"""Pure-Python Keccak-256 (Ethereum-style, multi-rate pad 0x01).

Host hash of the deferred Keccak claims; behavioral spec:
crates/crypto/src/hash/keccak/ (wraps the `sha3` crate's Keccak256), with
``hash_elements`` = keccak256 over LE bytes of canonical u64 felts
(keccak/tests.rs:92) and ``merge`` = hash of concatenated digests.
Pinned by the NIST/Ethereum vectors embedded in keccak/tests.rs.
"""

from __future__ import annotations

import struct

RATE = 136  # bytes, capacity 512 → Keccak-256
_M64 = 0xFFFFFFFFFFFFFFFF

ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# Rotation offsets r[x][y] for lane (x, y), lane index = x + 5y.
ROTATIONS = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _M64


def keccak_f(lanes: list[int]) -> list[int]:
    """Keccak-f[1600] permutation on 25 u64 lanes (index = x + 5y)."""
    a = list(lanes)
    for rc in ROUND_CONSTANTS:
        # θ
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # ρ and π: b[y, 2x+3y] = rot(a[x, y])
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], ROTATIONS[x][y])
        # χ
        a = [
            b[i] ^ ((~b[(i % 5 + 1) % 5 + 5 * (i // 5)]) & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        a = [v & _M64 for v in a]
        # ι
        a[0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    """Keccak-256 (pad10*1 with domain bit 0x01, rate 136)."""
    lanes = [0] * 25
    padded = bytearray(data)
    pad_len = RATE - (len(data) % RATE)
    padded += b"\x00" * pad_len
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    for off in range(0, len(padded), RATE):
        block = padded[off : off + RATE]
        for i in range(RATE // 8):
            lanes[i] ^= struct.unpack_from("<Q", block, i * 8)[0]
        lanes = keccak_f(lanes)
    return struct.pack("<4Q", *lanes[:4])


def hash_elements(elements: list[int]) -> bytes:
    """Keccak256::hash_elements: LE bytes of canonical u64 felts."""
    return keccak256(b"".join(struct.pack("<Q", e) for e in elements))


def merge(left: bytes, right: bytes) -> bytes:
    return keccak256(left + right)
