"""The port's ``crypto/`` (AEAD, XChaCha20-Poly1305, ECDH / X25519, IES and
``RandomCoin``) ≡ miden_tpu's.

The cases of ``tests/test_crypto.py`` run on the port, and the same inputs
give the same bytes and elements in both packages. Across the packages: what
one encrypts the other decrypts, and what one seals the other unseals (the
ephemeral keys of IES come from ``secrets`` in both, so sealed boxes are
compared by opening them, never byte for byte).
"""

from __future__ import annotations

import pytest

from miden_tpu.crypto import aead as j_aead
from miden_tpu.crypto import ecdh as j_ecdh
from miden_tpu.crypto import ies as j_ies
from miden_tpu.crypto import rand_coin as j_rand_coin
from miden_tpu.dsa import ecdsa_k256 as j_ec
from miden_tpu_torch.crypto import aead, ecdh, ies, rand_coin
from miden_tpu_torch.dsa import ecdsa_k256 as ec
from miden_tpu_torch.field import gl

PORT = (aead, ecdh, ies, ec)
JAX = (j_aead, j_ecdh, j_ies, j_ec)


def test_crypto_package_exports():
    import miden_tpu_torch.crypto as crypto

    assert {"aead", "ecdh", "ies", "rand_coin"} <= set(vars(crypto))


# -- X25519 and ECDH ---------------------------------------------------------


def test_x25519_rfc7748_vector():
    k = bytes.fromhex("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4")
    u = bytes.fromhex("e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c")
    want = "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"
    assert ecdh.x25519(k, u).hex() == want == j_ecdh.x25519(k, u).hex()


def test_x25519_agreement_equals_miden_tpu():
    a, b = b"\x01" * 32, b"\x02" * 32
    pa, pb = ecdh.x25519_public_key(a), ecdh.x25519_public_key(b)
    assert (pa, pb) == (j_ecdh.x25519_public_key(a), j_ecdh.x25519_public_key(b))
    shared = ecdh.x25519_shared_secret(a, pb)
    assert shared == ecdh.x25519_shared_secret(b, pa) == j_ecdh.x25519_shared_secret(b, pa)


def test_k256_ecdh_agreement_equals_miden_tpu():
    a, b = ec.SigningKey.from_seed(b"alice"), ec.SigningKey.from_seed(b"bob")
    shared = a.get_shared_secret(b.public_key())
    assert shared == b.get_shared_secret(a.public_key())
    j_a, j_b = j_ec.SigningKey.from_seed(b"alice"), j_ec.SigningKey.from_seed(b"bob")
    assert shared == j_a.get_shared_secret(j_b.public_key())
    assert ecdh.k256_shared_secret(a, b.public_key()) == j_ecdh.k256_shared_secret(j_a, j_b.public_key())


@pytest.mark.parametrize("length,salt", [(32, None), (64, b"salt"), (100, b"")])
def test_hkdf_key_material_equals_miden_tpu(length, salt):
    args = (b"shared secret", length, b"info", salt)
    assert ecdh.extract_key_material(*args) == j_ecdh.extract_key_material(*args)
    assert len(ecdh.extract_key_material(*args)) == length


# -- AEAD --------------------------------------------------------------------


def test_aead_poseidon2_round_trip_and_rejections():
    key = aead.AeadPoseidon2([1, 2, 3, 4])
    data, ad = list(range(19)), [7, 8, 9]
    enc = key.encrypt_elements(data, ad, nonce=(9, 9, 9, 9))
    assert key.decrypt_elements(enc, ad) == data
    with pytest.raises(aead.AeadError):
        key.decrypt_elements(enc, [7, 8])
    bad = aead.EncryptedData("elements", [(enc.ciphertext[0] + 1) % gl.P] + enc.ciphertext[1:],
                             enc.auth_tag, enc.nonce)
    with pytest.raises(aead.AeadError):
        key.decrypt_elements(bad, ad)
    with pytest.raises(aead.AeadError):
        aead.AeadPoseidon2([1, 2, 3, 5]).decrypt_elements(enc, ad)


@pytest.mark.parametrize("n", [0, 1, 8, 19, 64])
def test_aead_poseidon2_elements_equal_miden_tpu_both_ways(n):
    data, ad, nonce = [(i * 0x9E3779B97F4A7C15) % gl.P for i in range(n)], [7, 8, 9], (9, 8, 7, 6)
    enc = aead.AeadPoseidon2([1, 2, 3, 4]).encrypt_elements(data, ad, nonce=nonce)
    j_enc = j_aead.AeadPoseidon2([1, 2, 3, 4]).encrypt_elements(data, ad, nonce=nonce)
    assert (enc.ciphertext, tuple(enc.auth_tag)) == (j_enc.ciphertext, tuple(j_enc.auth_tag))
    assert j_aead.AeadPoseidon2([1, 2, 3, 4]).decrypt_elements(
        j_aead.EncryptedData(enc.data_type, enc.ciphertext, enc.auth_tag, enc.nonce), ad) == data
    assert aead.AeadPoseidon2([1, 2, 3, 4]).decrypt_elements(
        aead.EncryptedData(j_enc.data_type, j_enc.ciphertext, j_enc.auth_tag, j_enc.nonce), ad) == data


@pytest.mark.parametrize("msg", [b"", b"short", b"x" * 200])
def test_aead_poseidon2_bytes_equal_miden_tpu_both_ways(msg):
    key, j_key = aead.AeadPoseidon2([5, 6, 7, 8]), j_aead.AeadPoseidon2([5, 6, 7, 8])
    enc = key.encrypt_bytes(msg, b"context")
    assert key.decrypt_bytes(enc, b"context") == msg
    carried = j_aead.EncryptedData(enc.data_type, enc.ciphertext, enc.auth_tag, enc.nonce)
    assert j_key.decrypt_bytes(carried, b"context") == msg
    j_enc = j_key.encrypt_bytes(msg, b"context", nonce=enc.nonce)
    assert (j_enc.ciphertext, tuple(j_enc.auth_tag)) == (enc.ciphertext, tuple(enc.auth_tag))


@pytest.mark.parametrize("msg", [b"", b"a", b"1234567", b"12345678", b"x" * 100])
def test_byte_element_packing_equals_miden_tpu(msg):
    felts = aead.bytes_to_elements_with_padding(msg)
    assert felts == j_aead.bytes_to_elements_with_padding(msg)
    assert aead.padded_elements_to_bytes(felts) == msg == j_aead.padded_elements_to_bytes(felts)


def test_xchacha20poly1305_round_trip_and_rejections():
    key = aead.XChaCha20Poly1305(b"\x42" * 32)
    sealed = key.encrypt_bytes(b"hello world", b"ad")
    assert key.decrypt_bytes(sealed, b"ad") == b"hello world"
    with pytest.raises(aead.AeadError):
        key.decrypt_bytes(sealed, b"other-ad")
    with pytest.raises(aead.AeadError):
        key.decrypt_bytes(sealed[:-1] + bytes([sealed[-1] ^ 1]), b"ad")


@pytest.mark.parametrize("msg", [b"", b"hello world", bytes(range(256)) * 3])
def test_xchacha20poly1305_equals_miden_tpu_both_ways(msg):
    key, j_key = aead.XChaCha20Poly1305(b"\x42" * 32), j_aead.XChaCha20Poly1305(b"\x42" * 32)
    nonce = bytes(range(24))
    sealed = key.encrypt_bytes(msg, b"ad", nonce=nonce)
    assert sealed == j_key.encrypt_bytes(msg, b"ad", nonce=nonce)
    assert j_key.decrypt_bytes(key.encrypt_bytes(msg, b"ad"), b"ad") == msg
    assert key.decrypt_bytes(j_key.encrypt_bytes(msg, b"ad"), b"ad") == msg


# -- IES ---------------------------------------------------------------------


def _recipient(package, scheme: str):
    """(secret, public) of a fixed recipient in ``package``."""
    _, pkg_ecdh, _, pkg_ec = package
    if scheme.startswith("k256"):
        sk = pkg_ec.SigningKey.from_seed(b"recipient")
        return sk, sk.public_key()
    secret = b"\x33" * 32
    return secret, pkg_ecdh.x25519_public_key(secret)


def _carry(sealed, package):
    """A sealed box of one package rebuilt from its fields in ``package``."""
    pkg_aead, _, pkg_ies, _ = package
    payload = sealed.payload
    if not isinstance(payload, bytes):
        payload = pkg_aead.EncryptedData(payload.data_type, payload.ciphertext, payload.auth_tag, payload.nonce)
    return pkg_ies.SealedMessage(sealed.scheme, sealed.ephemeral_public, payload)


@pytest.mark.parametrize("scheme", sorted(ies.SCHEMES))
def test_ies_seal_unseal(scheme):
    secret, public = _recipient(PORT, scheme)
    sealed = ies.seal_bytes(scheme, public, b"the deferred root is bound", b"ad")
    assert ies.unseal_bytes(secret, sealed, b"ad") == b"the deferred root is bound"
    with pytest.raises(Exception):
        ies.unseal_bytes(secret, sealed, b"wrong-ad")


@pytest.mark.parametrize("scheme", sorted(ies.SCHEMES))
def test_ies_sealed_in_one_package_unseals_in_the_other(scheme):
    assert ies.SCHEMES == j_ies.SCHEMES
    msg = b"sealed across the packages"
    for sealer, opener in ((PORT, JAX), (JAX, PORT)):
        _, public = _recipient(sealer, scheme)
        secret, _ = _recipient(opener, scheme)
        sealed = sealer[2].seal_bytes(scheme, public, msg, b"ad")
        assert opener[2].unseal_bytes(secret, _carry(sealed, opener), b"ad") == msg


# -- RandomCoin --------------------------------------------------------------


def test_random_coin():
    from miden_tpu_torch.hash import poseidon2_host as hp

    coin = rand_coin.RandomCoin((1, 2, 3, 4))
    first9 = [coin.draw() for _ in range(9)]
    assert all(0 <= v < gl.P for v in first9)
    state = hp.permute([1, 2, 3, 4] + [0] * 8)
    assert first9[:8] == state[:8] and first9[8] == hp.permute(state)[0]
    coin2 = rand_coin.RandomCoin((1, 2, 3, 4))
    coin2.reseed((5, 5, 5, 5))
    assert coin2.draw() != rand_coin.RandomCoin((1, 2, 3, 4)).draw()
    state, cur = coin.into_parts()
    assert rand_coin.RandomCoin.from_parts(state, cur).draw() == coin.draw()
    assert len(coin.fill_bytes(10)) == 10


def test_random_coin_stream_equals_miden_tpu():
    coin, j_coin = rand_coin.RandomCoin((7, 8, 9, 10)), j_rand_coin.RandomCoin((7, 8, 9, 10))
    draws = [(c.draw(), c.draw_ext(), c.draw_word(), c.next_u32(), c.next_u64()) for c in (coin, j_coin)]
    assert draws[0] == draws[1]
    coin.reseed((1, 1, 2, 3))
    j_coin.reseed((1, 1, 2, 3))
    assert [coin.draw() for _ in range(20)] == [j_coin.draw() for _ in range(20)]
    assert coin.fill_bytes(37) == j_coin.fill_bytes(37)
    assert coin.into_parts() == j_coin.into_parts()
