"""Pure-Python BLAKE3 (host hash of the VM's event ids).

Implements the full BLAKE3 hash-mode tree (chunks, parents, root) from the
public specification. Reference surface: crates/crypto/src/hash/blake/mod.rs
wraps the upstream `blake3` crate; miden semantics on top of it are
  - ``hash(bytes)``   → 32-byte digest (Blake3_256) / first 24 (Blake3_192)
  - ``merge(a, b)``   → hash(a || b)          (blake/mod.rs:51,105)
  - ``hash_elements`` → hash(LE bytes of canonical u64s)  (blake/mod.rs:126)

Anchored by the official empty-input test vector.
"""

from __future__ import annotations

import struct

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)
MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1
CHUNK_END = 2
PARENT = 4
ROOT = 8

BLOCK_LEN = 64
CHUNK_LEN = 1024

_M32 = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M32


def _g(s: list[int], a: int, b: int, c: int, d: int, mx: int, my: int) -> None:
    s[a] = (s[a] + s[b] + mx) & _M32
    s[d] = _rotr(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & _M32
    s[b] = _rotr(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b] + my) & _M32
    s[d] = _rotr(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & _M32
    s[b] = _rotr(s[b] ^ s[c], 7)


def compress(
    cv: tuple, block_words: tuple, counter: int, block_len: int, flags: int
) -> list[int]:
    """One compression; returns the 8-word output chaining value."""
    s = [
        *cv,
        IV[0], IV[1], IV[2], IV[3],
        counter & _M32, (counter >> 32) & _M32, block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _g(s, 0, 4, 8, 12, m[0], m[1])
        _g(s, 1, 5, 9, 13, m[2], m[3])
        _g(s, 2, 6, 10, 14, m[4], m[5])
        _g(s, 3, 7, 11, 15, m[6], m[7])
        _g(s, 0, 5, 10, 15, m[8], m[9])
        _g(s, 1, 6, 11, 12, m[10], m[11])
        _g(s, 2, 7, 8, 13, m[12], m[13])
        _g(s, 3, 4, 9, 14, m[14], m[15])
        if r != 6:
            m = [m[p] for p in MSG_PERMUTATION]
    return [s[i] ^ s[i + 8] for i in range(8)]


def _block_words(block: bytes) -> tuple:
    block = block.ljust(BLOCK_LEN, b"\x00")
    return struct.unpack("<16I", block)


def _chunk_cv(chunk: bytes, counter: int, root: bool) -> list[int]:
    """Chaining value of one ≤1024-byte chunk (possibly the root)."""
    blocks = [chunk[i : i + BLOCK_LEN] for i in range(0, len(chunk), BLOCK_LEN)] or [b""]
    cv = IV
    for i, block in enumerate(blocks):
        flags = 0
        if i == 0:
            flags |= CHUNK_START
        if i == len(blocks) - 1:
            flags |= CHUNK_END
            if root:
                flags |= ROOT
        cv = compress(cv, _block_words(block), counter, len(block), flags)
    return list(cv)


def _parent_cv(left: list[int], right: list[int], root: bool) -> list[int]:
    return compress(
        IV, tuple(left) + tuple(right), 0, BLOCK_LEN, PARENT | (ROOT if root else 0)
    )


def _subtree_cv(data: bytes, chunk_counter: int, root: bool) -> list[int]:
    if len(data) <= CHUNK_LEN:
        return _chunk_cv(data, chunk_counter, root)
    # Left subtree takes the largest power-of-two number of chunks strictly
    # less than the total (spec §2.1).
    chunks = (len(data) + CHUNK_LEN - 1) // CHUNK_LEN
    left_chunks = 1 << ((chunks - 1).bit_length() - 1)
    split = left_chunks * CHUNK_LEN
    left = _subtree_cv(data[:split], chunk_counter, False)
    right = _subtree_cv(data[split:], chunk_counter + left_chunks, False)
    return _parent_cv(left, right, root)


def blake3(data: bytes, out_len: int = 32) -> bytes:
    """BLAKE3 hash (hash mode), first ``out_len`` bytes (≤ 32)."""
    cv = _subtree_cv(data, 0, True)
    return struct.pack("<8I", *cv)[:out_len]


def hash_elements(elements: list[int], out_len: int = 32) -> bytes:
    """Blake3_256/192::hash_elements: LE bytes of canonical u64 felts."""
    return blake3(b"".join(struct.pack("<Q", e) for e in elements), out_len)


def merge(left: bytes, right: bytes, out_len: int = 32) -> bytes:
    """Blake3_*::merge: hash of the concatenated digest bytes."""
    return blake3(left + right, out_len)
