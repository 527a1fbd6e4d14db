"""Diffie-Hellman key agreement + HKDF-SHA256 extraction (ecdh/).

- ``k256``: secp256k1 ECDH — shared secret is the x-coordinate big-endian
  bytes (ecdh/k256.rs via the k256 crate's `diffie_hellman`).
- ``x25519``: RFC 7748 Montgomery ladder (ecdh/x25519.rs via x25519-dalek).
- ``extract_key_material``: HKDF-SHA256 (ecdh/mod.rs:61).
"""

from __future__ import annotations

import hashlib
import hmac

from ..dsa import ecdsa_k256 as _k256

# -- HKDF-SHA256 -------------------------------------------------------------


def hkdf_sha256(ikm: bytes, salt: bytes | None, length: int, info: bytes) -> bytes:
    if length > 255 * 32:
        raise ValueError("HKDF expansion too long")
    prk = hmac.new(salt or b"\x00" * 32, ikm, hashlib.sha256).digest()
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def extract_key_material(shared_secret: bytes, length: int, info: bytes, salt: bytes | None = None) -> bytes:
    return hkdf_sha256(shared_secret, salt, length, info)


# -- secp256k1 ---------------------------------------------------------------


def k256_keypair(seed: bytes):
    sk = _k256.SigningKey.from_seed(seed)
    return sk, sk.public_key()


def k256_shared_secret(sk: "_k256.SigningKey", pk: "_k256.PublicKey") -> bytes:
    return sk.get_shared_secret(pk)


# -- X25519 (RFC 7748) -------------------------------------------------------

_P25519 = 2**255 - 19
_A24 = 121665


def _x25519_ladder(k: int, u: int) -> int:
    x1 = u % _P25519
    x2, z2 = 1, 0
    x3, z3 = x1, 1
    swap = 0
    for t in reversed(range(255)):
        kt = (k >> t) & 1
        swap ^= kt
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        a = (x2 + z2) % _P25519
        aa = a * a % _P25519
        b = (x2 - z2) % _P25519
        bb = b * b % _P25519
        e = (aa - bb) % _P25519
        c = (x3 + z3) % _P25519
        d = (x3 - z3) % _P25519
        da = d * a % _P25519
        cb = c * b % _P25519
        x3 = (da + cb) % _P25519
        x3 = x3 * x3 % _P25519
        z3 = (da - cb) % _P25519
        z3 = x1 * z3 * z3 % _P25519
        x2 = aa * bb % _P25519
        z2 = e * (aa + _A24 * e) % _P25519
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return x2 * pow(z2, _P25519 - 2, _P25519) % _P25519


def _clamp(scalar: bytes) -> int:
    k = bytearray(scalar)
    k[0] &= 248
    k[31] &= 127
    k[31] |= 64
    return int.from_bytes(bytes(k), "little")


def x25519(scalar: bytes, u_bytes: bytes) -> bytes:
    """RFC 7748 X25519 function: scalar (32B) x u-coordinate (32B)."""
    k = _clamp(scalar)
    u = int.from_bytes(u_bytes, "little") & ((1 << 255) - 1)
    return _x25519_ladder(k, u).to_bytes(32, "little")


_X25519_BASE = (9).to_bytes(32, "little")


def x25519_public_key(scalar: bytes) -> bytes:
    return x25519(scalar, _X25519_BASE)


def x25519_shared_secret(scalar: bytes, peer_public: bytes) -> bytes:
    out = x25519(scalar, peer_public)
    if out == b"\x00" * 32:
        raise ValueError("degenerate x25519 shared secret")
    return out
