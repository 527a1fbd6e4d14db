"""ECDSA over secp256k1 with Keccak-256 message hashing.

Mirrors dsa/ecdsa_k256_keccak/mod.rs: messages are Words (4 felts → 32
little-endian bytes), hashed with Keccak-256; signatures are (r, s, v) with a
recovery id and low-s normalization; public keys commit to the VM as
Poseidon2(hash of 16 u32-limb felts of the affine point) — the exact layout
the in-VM verifier reads (affine_point_to_elements, mod.rs:527-546).

Deterministic nonces per RFC 6979 (the reference's k256 crate does the same),
so signing is reproducible without an RNG.
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass

from ..hash import keccak_host, poseidon2_host

# secp256k1 domain parameters
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
B = 7


class EcdsaError(ValueError):
    pass


# -- affine/Jacobian point arithmetic ---------------------------------------


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def _jac_double(p):
    x, y, z = p
    if y == 0:
        return (0, 1, 0)
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = 2 * ((x + b) * (x + b) - a - c) % P
    e = 3 * a % P
    f = e * e % P
    x3 = (f - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * y * z % P
    return (x3, y3, z3)


def _jac_add(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        if s1 != s2:
            return (0, 1, 0)
        return _jac_double(p)
    h = (u2 - u1) % P
    i = 4 * h * h % P
    j = h * i % P
    r = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * s1 * j) % P
    z3 = 2 * h * z1 * z2 % P
    return (x3, y3, z3)


def _jac_mul(k: int, p) -> tuple:
    acc = (0, 1, 0)
    add = p
    while k:
        if k & 1:
            acc = _jac_add(acc, add)
        add = _jac_double(add)
        k >>= 1
    return acc


def _to_affine(p):
    x, y, z = p
    if z == 0:
        return None
    zi = _inv(z, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def _point_mul(k: int, point=None):
    base = (GX, GY, 1) if point is None else (point[0], point[1], 1)
    return _to_affine(_jac_mul(k % N, base))


def is_on_curve(pt) -> bool:
    if pt is None:
        return False
    x, y = pt
    return (y * y - (x * x * x + B)) % P == 0


def _lift_x(x: int, y_odd: bool):
    y2 = (pow(x, 3, P) + B) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        return None
    if (y & 1) != int(y_odd):
        y = P - y
    return (x, y)


# -- message hashing / encodings --------------------------------------------


def hash_message(message_word) -> bytes:
    """Keccak-256 over the 32-byte LE encoding of a 4-felt Word."""
    data = b"".join(int(v).to_bytes(8, "little") for v in message_word)
    return keccak_host.keccak256(data)


def point_to_elements(pt) -> list[int]:
    """16 felts: x then y as 8 little-endian u32 limbs each (mod.rs:527)."""
    out = []
    for coord in pt:
        b = int(coord).to_bytes(32, "big")
        for i in range(8):
            start = 32 - 4 * (i + 1)
            out.append(int.from_bytes(b[start : start + 4], "big"))
    return out


# -- keys and signatures -----------------------------------------------------


@dataclass(frozen=True)
class Signature:
    r: int
    s: int
    v: int  # recovery id (0/1)

    def to_bytes(self) -> bytes:
        return (
            self.r.to_bytes(32, "big") + self.s.to_bytes(32, "big")
            + bytes([self.v])
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        if len(data) != 65:
            raise EcdsaError("signature must be 65 bytes")
        r = int.from_bytes(data[0:32], "big")
        s = int.from_bytes(data[32:64], "big")
        if not (0 < r < N and 0 < s < N):
            raise EcdsaError("signature scalar out of range")
        return cls(r, s, data[64])


@dataclass(frozen=True)
class PublicKey:
    x: int
    y: int

    def to_elements(self) -> list[int]:
        return point_to_elements((self.x, self.y))

    def to_commitment(self) -> list[int]:
        """Word commitment = Poseidon2::hash_elements(16 limb felts)."""
        return poseidon2_host.hash_elements(self.to_elements())

    def to_bytes(self) -> bytes:
        """SEC1 compressed (33 bytes)."""
        return bytes([2 + (self.y & 1)]) + self.x.to_bytes(32, "big")

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey":
        if len(data) != 33 or data[0] not in (2, 3):
            raise EcdsaError("bad compressed public key")
        pt = _lift_x(int.from_bytes(data[1:], "big"), data[0] == 3)
        if pt is None:
            raise EcdsaError("x is not on the curve")
        return cls(*pt)

    def verify(self, message_word, sig: Signature) -> bool:
        return self.verify_prehash(hash_message(message_word), sig)

    def verify_prehash(self, digest: bytes, sig: Signature) -> bool:
        if not (0 < sig.r < N and 0 < sig.s < N):
            return False
        if not is_on_curve((self.x, self.y)):
            return False
        z = int.from_bytes(digest, "big") % N
        si = _inv(sig.s, N)
        u1 = z * si % N
        u2 = sig.r * si % N
        pt = _to_affine(
            _jac_add(_jac_mul(u1, (GX, GY, 1)), _jac_mul(u2, (self.x, self.y, 1)))
        )
        return pt is not None and pt[0] % N == sig.r

    @classmethod
    def recover_from(cls, message_word, sig: Signature) -> "PublicKey":
        """Recover the signing key from (message, signature) (mod.rs:268)."""
        digest = hash_message(message_word)
        if not (0 < sig.r < N and 0 < sig.s < N and sig.v in (0, 1)):
            raise EcdsaError("recovery failed")
        r_pt = _lift_x(sig.r, bool(sig.v))
        if r_pt is None:
            raise EcdsaError("recovery failed")
        z = int.from_bytes(digest, "big") % N
        ri = _inv(sig.r, N)
        # Q = r^-1 (s·R - z·G)
        srp = _jac_mul(sig.s, (r_pt[0], r_pt[1], 1))
        zg = _jac_mul((N - z) % N, (GX, GY, 1))
        q = _to_affine(_jac_mul(ri, _jac_add(srp, zg)))
        if q is None:
            raise EcdsaError("recovery failed")
        pk = cls(*q)
        if not pk.verify_prehash(digest, sig):
            raise EcdsaError("recovery failed")
        return pk


@dataclass(frozen=True)
class SigningKey:
    d: int

    @classmethod
    def from_bytes(cls, data: bytes) -> "SigningKey":
        d = int.from_bytes(data, "big")
        if not (0 < d < N):
            raise EcdsaError("secret scalar out of range")
        return cls(d)

    @classmethod
    def from_seed(cls, seed: bytes) -> "SigningKey":
        """Derive a valid scalar from arbitrary seed bytes (test helper)."""
        d = int.from_bytes(hashlib.sha256(seed).digest(), "big") % (N - 1) + 1
        return cls(d)

    def public_key(self) -> PublicKey:
        return PublicKey(*_point_mul(self.d))

    def sign(self, message_word) -> Signature:
        return self.sign_prehash(hash_message(message_word))

    def sign_prehash(self, digest: bytes) -> Signature:
        z = int.from_bytes(digest, "big") % N
        k = _rfc6979_nonce(self.d, digest)
        while True:
            pt = _point_mul(k)
            r = pt[0] % N
            if r != 0:
                s = _inv(k, N) * (z + r * self.d) % N
                if s != 0:
                    break
            k = (k + 1) % N or 1
        v = pt[1] & 1
        # low-s normalization flips the recovery parity (IsHigh in k256)
        if s > N // 2:
            s = N - s
            v ^= 1
        return Signature(r, s, v)

    def get_shared_secret(self, peer: PublicKey) -> bytes:
        """ECDH x-coordinate shared secret (ecdh/k256.rs semantics)."""
        pt = _point_mul(self.d, (peer.x, peer.y))
        if pt is None:
            raise EcdsaError("degenerate shared secret")
        return pt[0].to_bytes(32, "big")


def _rfc6979_nonce(d: int, digest: bytes) -> int:
    """Deterministic nonce per RFC 6979 §3.2 (HMAC-SHA256)."""
    qlen = 32
    x = d.to_bytes(qlen, "big")
    h1 = digest
    v = b"\x01" * 32
    k = b"\x00" * 32
    k = hmac.new(k, v + b"\x00" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    k = hmac.new(k, v + b"\x01" + x + h1, hashlib.sha256).digest()
    v = hmac.new(k, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(k, v, hashlib.sha256).digest()
        t = int.from_bytes(v, "big")
        if 0 < t < N:
            return t
        k = hmac.new(k, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(k, v, hashlib.sha256).digest()
