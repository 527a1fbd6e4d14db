"""The port's host signature schemes ≡ ``miden_tpu``'s: Ed25519 and Falcon-512.

Both are host crypto (no MASM, no device code). From the same seeds the two
packages must give equal keys, signatures, encodings and verify results,
exactly; the edge cases of ``tests/test_dsa_edge_cases.py`` ``TestEd25519``
and the checks of ``tests/test_falcon.py`` hold in the port. X25519 is
``crypto/ecdh.py`` (``tests/test_torch_crypto.py``).
"""

import random

import pytest

from miden_tpu.dsa import ed25519 as j_ed
from miden_tpu.dsa import falcon512 as j_fc
from miden_tpu_torch.dsa import ed25519 as ed
from miden_tpu_torch.dsa import falcon512 as fc

ED_SEEDS = [b"\x01" * 32, b"\x02" * 32, bytes(range(32)), random.Random(25519).randbytes(32)]
MESSAGES = [b"", b"msg", bytes(range(200))]
WORDS = [(1, 2, 3, 4), (17, 34, 51, 68), (2**64 - 2**32, 0, 7, 2**63)]


# ---------------------------------------------------------------------------
# Ed25519
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", ED_SEEDS, ids=range(len(ED_SEEDS)))
def test_ed25519_keys_signatures_and_verdicts_equal_miden_tpu(seed):
    sk, j_sk = ed.SigningKey(seed), j_ed.SigningKey(seed)
    pk, j_pk = sk.public_key(), j_sk.public_key()
    assert pk.to_elements() == j_pk.to_elements()
    assert pk.to_commitment() == j_pk.to_commitment()
    for msg in MESSAGES:
        sig = sk.sign_bytes(msg)
        assert sig == j_sk.sign_bytes(msg) and len(sig) == 64
        assert pk.verify_bytes(msg, sig) and j_pk.verify_bytes(msg, sig)
        assert not pk.verify_bytes(msg + b"x", sig) and not j_pk.verify_bytes(msg + b"x", sig)
    for word in WORDS:
        sig = sk.sign(word)
        assert sig == j_sk.sign(word)
        assert pk.verify(word, sig) and j_pk.verify(word, sig)


def _ed_edge_cases():
    """(name, key seed, signature of b"msg") of TestEd25519's cases: each
    must be refused."""
    cases = []
    sig = ed.SigningKey(b"\x02" * 32).sign_bytes(b"msg")
    s = int.from_bytes(sig[32:], "little")
    cases.append(("s >= L", b"\x02" * 32, sig[:32] + (s + ed.L).to_bytes(32, "little")))
    sig = ed.SigningKey(b"\x03" * 32).sign_bytes(b"msg")
    cases.append(("flipped r", b"\x03" * 32, bytes([sig[0] ^ 1]) + sig[1:]))
    cases.append(("63 bytes", b"\x03" * 32, sig[:63]))
    cases.append(("65 bytes", b"\x03" * 32, sig + b"\x00"))
    # R encoded with y >= p: y = p + 1 is the non-canonical twin of the
    # identity's y = 1 (TestEd25519 only reaches this when y(R) < 19)
    cases.append(("non-canonical R", b"\x03" * 32, (ed.P + 1).to_bytes(32, "little") + sig[32:]))
    cases.append(("all zero", b"\x05" * 32, bytes(64)))
    return cases


@pytest.mark.parametrize("case", _ed_edge_cases(), ids=lambda c: c[0])
def test_ed25519_edge_cases_refused_by_both(case):
    _name, seed, sig = case
    pk, j_pk = ed.SigningKey(seed).public_key(), j_ed.SigningKey(seed).public_key()
    assert pk.verify_bytes(b"msg", sig) is False
    assert j_pk.verify_bytes(b"msg", sig) is False


def test_ed25519_decompression_is_canonical_in_both():
    """y >= p never decodes, as a point or as a public key; its canonical
    twin does."""
    for pkg in (ed, j_ed):
        assert pkg._decompress((1).to_bytes(32, "little")) == (0, 1, 1, 0)
        for y in (pkg.P, pkg.P + 1, pkg.P + 18):
            assert pkg._decompress(y.to_bytes(32, "little")) is None
            with pytest.raises(pkg.Ed25519Error):
                pkg.PublicKey(y.to_bytes(32, "little"))


# ---------------------------------------------------------------------------
# Falcon-512
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def falcon_keys():
    """One key pair per package from the same seed (keygen is seconds of
    NTRUSolve in each)."""
    sk, j_sk = fc.SecretKey.generate(seed=b"\x42" * 32), j_fc.SecretKey.generate(seed=b"\x42" * 32)
    return sk, sk.public_key(), j_sk, j_sk.public_key()


def test_falcon_keys_and_encodings_equal_miden_tpu(falcon_keys):
    sk, pk, j_sk, j_pk = falcon_keys
    assert sk.basis == j_sk.basis
    assert pk.h == j_pk.h
    assert pk.to_bytes() == j_pk.to_bytes() and len(pk.to_bytes()) == fc.PK_LEN
    assert sk.to_bytes() == j_sk.to_bytes() and len(sk.to_bytes()) == 1281
    assert pk.to_commitment() == j_pk.to_commitment() and len(pk.to_commitment()) == 4
    assert pk.to_elements() == j_pk.to_elements()


@pytest.mark.parametrize("word", WORDS, ids=range(len(WORDS)))
def test_falcon_hash_to_point_equals_miden_tpu(word):
    for nonce in (fc.deterministic_nonce(), bytes([2]) + fc.PREVERSIONED_NONCE, bytes(range(40))):
        c = fc.hash_to_point(word, nonce)
        assert c == j_fc.hash_to_point(word, nonce)
        assert len(c) == fc.N and all(0 <= v < fc.Q for v in c)
    assert fc.nonce_to_elements(fc.deterministic_nonce()) == j_fc.nonce_to_elements(j_fc.deterministic_nonce())


@pytest.mark.parametrize("word", WORDS, ids=range(len(WORDS)))
def test_falcon_signatures_equal_miden_tpu(falcon_keys, word):
    sk, pk, j_sk, j_pk = falcon_keys
    sig, j_sig = sk.sign(word), j_sk.sign(word)
    assert (sig.nonce, sig.s2, sig.h) == (j_sig.nonce, j_sig.s2, j_sig.h)
    blob = sig.to_bytes()
    assert blob == j_sig.to_bytes()
    assert len(blob) == 1 + fc.SIG_NONCE_LEN + fc.SIG_POLY_BYTE_LEN + fc.PK_LEN
    assert pk.verify(word, sig) and j_pk.verify(word, j_sig)
    # each package reads the other's bytes and accepts them
    assert pk.verify(word, fc.Signature.from_bytes(j_sig.to_bytes()))
    assert j_pk.verify(word, j_fc.Signature.from_bytes(blob))
    # deterministic: the same key and message sign the same
    assert sk.sign(word).s2 == sig.s2


def test_falcon_tampered_signature_refused_by_both(falcon_keys):
    sk, pk, j_sk, j_pk = falcon_keys
    msg = (1, 2, 3, 4)
    sig = sk.sign(msg)
    bad = (sig.nonce, [sig.s2[0] + 1] + sig.s2[1:], sig.h)
    assert not pk.verify(msg, fc.Signature(*bad))
    assert not j_pk.verify(msg, j_fc.Signature(*bad))
    other = (sig.nonce, sig.s2, [(v + 1) % fc.Q for v in sig.h])
    assert not pk.verify(msg, fc.Signature(*other))
    assert not j_pk.verify(msg, j_fc.Signature(*other))
    assert not pk.verify((1, 2, 3, 5), sig) and not j_pk.verify((1, 2, 3, 5), j_sk.sign(msg))
    blob = sig.to_bytes()
    for pkg in (fc, j_fc):
        with pytest.raises(pkg.FalconError):
            pkg.Signature.from_bytes(b"\x00" + blob[1:])
        with pytest.raises(pkg.FalconError):
            pkg.PublicKey.from_bytes(b"\x00" * fc.PK_LEN)


def test_falcon_ntru_equation_and_norm_bound(falcon_keys):
    sk, pk, _, _ = falcon_keys
    g, neg_f, G, neg_F = sk.basis
    f = [-v for v in neg_f]
    F = [-v for v in neg_F]
    diff = [a - b for a, b in zip(fc._int_negacyclic_mul(f, G), fc._int_negacyclic_mul(g, F))]
    assert diff[0] == fc.Q and all(v == 0 for v in diff[1:])
    msg = (17, 34, 51, 68)
    sig = sk.sign(msg)
    assert max(abs(v) for v in sig.s2) <= 2047
    c = fc.hash_to_point(msg, sig.nonce)
    s2h = fc.poly_mul_mod([v % fc.Q for v in sig.s2], pk.h)
    s1 = [(a - b) % fc.Q for a, b in zip(c, s2h)]
    assert sum(fc._balanced(v) ** 2 for v in s1) + sum(v * v for v in sig.s2) < fc.SIG_L2_BOUND


def test_falcon_serialization_roundtrips(falcon_keys):
    sk, pk, _, _ = falcon_keys
    sig = sk.sign((9, 8, 7, 6))
    rt = fc.Signature.from_bytes(sig.to_bytes())
    assert (rt.s2, rt.h, rt.nonce) == (sig.s2, sig.h, sig.nonce)
    assert pk.verify((9, 8, 7, 6), rt)
    assert fc.PublicKey.from_bytes(pk.to_bytes()).h == pk.h
    assert fc.SecretKey.from_bytes(sk.to_bytes()).basis == sk.basis


def test_falcon_sampler_z_equals_miden_tpu_and_its_statistics():
    rng, j_rng = fc.ChaChaRng(b"\x05" * 32), j_fc.ChaChaRng(b"\x05" * 32)
    samples = [fc.sampler_z(0.5, 1.5, fc.SIGMIN, rng) for _ in range(2000)]
    assert samples == [j_fc.sampler_z(0.5, 1.5, j_fc.SIGMIN, j_rng) for _ in range(2000)]
    mean = sum(samples) / len(samples)
    var = sum((s - mean) ** 2 for s in samples) / len(samples)
    assert abs(mean - 0.5) < 0.15
    assert abs(var - 2.25) < 0.5
