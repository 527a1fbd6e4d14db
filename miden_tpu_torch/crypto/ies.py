"""Integrated Encryption Scheme: ECDH + AEAD sealed boxes (ies/).

Mirrors ies/crypto_box.rs: an ephemeral keypair is generated per seal, the
shared secret is fed through HKDF-SHA256 with
``info = KDF_CONTEXT || scheme_id || ephemeral_public_key``, and the derived
key encrypts the payload under the scheme's AEAD. Four schemes
(ies/mod.rs:47): {K256, X25519} x {XChaCha20-Poly1305, AeadPoseidon2}.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from . import ecdh
from .aead import AeadPoseidon2, EncryptedData, XChaCha20Poly1305
from ..dsa import ecdsa_k256 as k256

KDF_CONTEXT = b"miden-crypto/ies/hkdf-v1"

SCHEMES = {
    "k256-xchacha20poly1305": 0,
    "x25519-xchacha20poly1305": 1,
    "k256-aead-poseidon2": 2,
    "x25519-aead-poseidon2": 3,
}


class IesError(ValueError):
    pass


@dataclass(frozen=True)
class SealedMessage:
    scheme: str
    ephemeral_public: bytes
    payload: object  # bytes (xchacha) or EncryptedData (poseidon2)


def _kdf_info(scheme: str, ephemeral_public: bytes) -> bytes:
    return KDF_CONTEXT + bytes([SCHEMES[scheme]]) + ephemeral_public


def _derive_key(scheme: str, shared: bytes, ephemeral_public: bytes):
    info = _kdf_info(scheme, ephemeral_public)
    material = ecdh.extract_key_material(shared, 32, info)
    if scheme.endswith("aead-poseidon2"):
        # poseidon2 keys need 4 uniform felts — expand 64 bytes
        material = ecdh.extract_key_material(shared, 64, info)
        return AeadPoseidon2.key_from_uniform_bytes(material)
    return XChaCha20Poly1305.key_from_uniform_bytes(material)


def seal_bytes(scheme: str, recipient_public, plaintext: bytes, associated_data: bytes = b"") -> SealedMessage:
    if scheme not in SCHEMES:
        raise IesError(f"unsupported scheme {scheme!r}")
    if scheme.startswith("k256"):
        eph_sk = k256.SigningKey.from_seed(secrets.token_bytes(32))
        eph_pub = eph_sk.public_key().to_bytes()
        shared = eph_sk.get_shared_secret(recipient_public)
    else:
        eph_scalar = secrets.token_bytes(32)
        eph_pub = ecdh.x25519_public_key(eph_scalar)
        shared = ecdh.x25519_shared_secret(eph_scalar, recipient_public)
    aead_key = _derive_key(scheme, shared, eph_pub)
    if isinstance(aead_key, AeadPoseidon2):
        payload = aead_key.encrypt_bytes(plaintext, associated_data)
    else:
        payload = aead_key.encrypt_bytes(plaintext, associated_data)
    return SealedMessage(scheme, eph_pub, payload)


def unseal_bytes(recipient_secret, sealed: SealedMessage, associated_data: bytes = b"") -> bytes:
    scheme = sealed.scheme
    if scheme not in SCHEMES:
        raise IesError(f"unsupported scheme {scheme!r}")
    if scheme.startswith("k256"):
        eph_pk = k256.PublicKey.from_bytes(sealed.ephemeral_public)
        shared = recipient_secret.get_shared_secret(eph_pk)
    else:
        shared = ecdh.x25519_shared_secret(recipient_secret, sealed.ephemeral_public)
    aead_key = _derive_key(scheme, shared, sealed.ephemeral_public)
    if isinstance(aead_key, AeadPoseidon2):
        if not isinstance(sealed.payload, EncryptedData):
            raise IesError("payload/scheme mismatch")
        return aead_key.decrypt_bytes(sealed.payload, associated_data)
    return aead_key.decrypt_bytes(sealed.payload, associated_data)
