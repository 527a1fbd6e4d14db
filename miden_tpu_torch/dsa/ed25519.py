"""EdDSA over Curve25519 (Ed25519) per RFC 8032, SHA-512 message hashing.

Mirrors dsa/eddsa_25519_sha512/mod.rs (which wraps ed25519-dalek): 32-byte
secret seeds, 32-byte compressed public keys, 64-byte (R, S) signatures.
Word messages are signed over their 32-byte little-endian felt encoding.
Public keys commit to the VM as Poseidon2 over packed-u32 felts
(bytes_to_packed_u32_elements — 8 u32 limbs of the compressed key).

Verification uses the cofactorless equation ``[S]B = R + [k]A`` matching
dalek's `verify` (strict about canonical encodings of R and A).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..hash import poseidon2_host

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P  # curve constant of -x²+y²=1+dx²y²
BASE_Y = 4 * pow(5, P - 2, P) % P


class Ed25519Error(ValueError):
    pass


def _inv(a: int) -> int:
    return pow(a, P - 2, P)


def _recover_x(y: int, sign: int):
    if y >= P:
        return None
    x2 = (y * y - 1) * _inv(D * y * y + 1) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * pow(2, (P - 1) // 4, P) % P
    if (x * x - x2) % P != 0:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


_BASE_X = _recover_x(BASE_Y, 0)
# extended homogeneous coordinates (X, Y, Z, T), T = XY/Z
_BASE = (_BASE_X, BASE_Y, 1, _BASE_X * BASE_Y % P)
_IDENT = (0, 1, 1, 0)


def _pt_add(p, q):
    a = (p[1] - p[0]) * (q[1] - q[0]) % P
    b = (p[1] + p[0]) * (q[1] + q[0]) % P
    c = 2 * p[3] * q[3] * D % P
    d = 2 * p[2] * q[2] % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _pt_mul(s: int, pt):
    acc = _IDENT
    while s:
        if s & 1:
            acc = _pt_add(acc, pt)
        pt = _pt_add(pt, pt)
        s >>= 1
    return acc


def _pt_equal(p, q) -> bool:
    # x1/z1 == x2/z2 and y1/z1 == y2/z2
    return (
        (p[0] * q[2] - q[0] * p[2]) % P == 0
        and (p[1] * q[2] - q[1] * p[2]) % P == 0
    )


def _compress(pt) -> bytes:
    zi = _inv(pt[2])
    x, y = pt[0] * zi % P, pt[1] * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decompress(data: bytes):
    if len(data) != 32:
        return None
    val = int.from_bytes(data, "little")
    sign = val >> 255
    y = val & ((1 << 255) - 1)
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def _sha512_int(*parts: bytes) -> int:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return int.from_bytes(h.digest(), "little")


def word_to_bytes(message_word) -> bytes:
    return b"".join(int(v).to_bytes(8, "little") for v in message_word)


@dataclass(frozen=True)
class PublicKey:
    data: bytes  # 32-byte compressed point

    def __post_init__(self):
        if _decompress(self.data) is None:
            raise Ed25519Error("invalid public key encoding")

    def to_elements(self) -> list[int]:
        """8 packed-u32 felts of the compressed key (LE limbs)."""
        return [
            int.from_bytes(self.data[4 * i : 4 * i + 4], "little")
            for i in range(8)
        ]

    def to_commitment(self) -> list[int]:
        return poseidon2_host.hash_elements(self.to_elements())

    def verify_bytes(self, message: bytes, signature: bytes) -> bool:
        if len(signature) != 64:
            return False
        r_enc, s_enc = signature[:32], signature[32:]
        s = int.from_bytes(s_enc, "little")
        if s >= L:
            return False  # malleability check (dalek is strict)
        r_pt = _decompress(r_enc)
        a_pt = _decompress(self.data)
        if r_pt is None or a_pt is None:
            return False
        k = _sha512_int(r_enc, self.data, message) % L
        lhs = _pt_mul(s, _BASE)
        rhs = _pt_add(r_pt, _pt_mul(k, a_pt))
        return _pt_equal(lhs, rhs)

    def verify(self, message_word, signature: bytes) -> bool:
        return self.verify_bytes(word_to_bytes(message_word), signature)


@dataclass(frozen=True)
class SigningKey:
    seed: bytes  # 32 bytes

    def __post_init__(self):
        if len(self.seed) != 32:
            raise Ed25519Error("seed must be 32 bytes")

    def _expanded(self) -> tuple[int, bytes]:
        h = hashlib.sha512(self.seed).digest()
        a = int.from_bytes(h[:32], "little")
        a &= (1 << 254) - 8
        a |= 1 << 254
        return a, h[32:]

    def public_key(self) -> PublicKey:
        a, _ = self._expanded()
        return PublicKey(_compress(_pt_mul(a, _BASE)))

    def sign_bytes(self, message: bytes) -> bytes:
        a, prefix = self._expanded()
        pk = _compress(_pt_mul(a, _BASE))
        r = _sha512_int(prefix, message) % L
        r_enc = _compress(_pt_mul(r, _BASE))
        k = _sha512_int(r_enc, pk, message) % L
        s = (r + k * a) % L
        return r_enc + s.to_bytes(32, "little")

    def sign(self, message_word) -> bytes:
        return self.sign_bytes(word_to_bytes(message_word))
