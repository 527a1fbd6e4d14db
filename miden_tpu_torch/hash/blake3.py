"""Batched BLAKE3 in plain torch (the BLAKE3-256 LMCS configuration).

Port of ``miden_tpu/hash/blake3.py``: every row of Goldilocks elements (an
(h, w) int64 tensor of canonical values, hashed as their LE u64 bytes per
crates/crypto/src/hash/blake/mod.rs:126) maps to one 32-byte digest, and
Merkle layers merge digest pairs with ``blake3(left || right)``
(reference air/src/config.rs:236 ``blake3_256_config``).

A 32-bit word is held in int64 masked to 32 bits: torch's ``uint32`` has no
add, shift or compare on the CPU. The state is one (16, n) tensor, and each
half-round mixes its four columns (then its four diagonals) in one set of
ops on (4, n) slices, so a compression is ~350 tensor ops whatever n. It
runs on the caller's device; ``miden_tpu`` computes it in XLA, with no
Pallas kernel, so the port has no kernel for it.

Ground truth: ``blake3_host`` (the same module family as Poseidon2's host
twin).
"""

from __future__ import annotations

import numpy as np
import torch

from . import blake3_host as H

M32 = 0xFFFFFFFF

#: the diagonal step mixes (0,5,10,15), (1,6,11,12), (2,7,8,13), (3,4,9,14):
#: rows b, c, d of the (4, 4, n) state rotated left by 1, 2, 3
_DIAG = torch.tensor([0, 1, 2, 3, 5, 6, 7, 4, 10, 11, 8, 9, 15, 12, 13, 14])
_UNDIAG = torch.argsort(_DIAG)


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) | ((x << (32 - n)) & M32)


def _g(s: torch.Tensor, mx: torch.Tensor, my: torch.Tensor) -> torch.Tensor:
    """The G mix on four (a, b, c, d) quadruples at once: ``s`` (16, n)
    holds rows a0..a3, b0..b3, c0..c3, d0..d3; mx, my are (4, n)."""
    a, b, c, d = s[0:4], s[4:8], s[8:12], s[12:16]
    a = (a + b + mx) & M32
    d = _rotr(d ^ a, 16)
    c = (c + d) & M32
    b = _rotr(b ^ c, 12)
    a = (a + b + my) & M32
    d = _rotr(d ^ a, 8)
    c = (c + d) & M32
    b = _rotr(b ^ c, 7)
    return torch.cat([a, b, c, d])


def compress(cv: torch.Tensor, m: torch.Tensor, counter: int, block_len: int, flags: int) -> torch.Tensor:
    """Batched compression: ``cv`` (8, n) and ``m`` (16, n) 32-bit words in
    int64; returns the (8, n) output chaining value."""
    n = cv.shape[1]
    tail = torch.tensor(
        [*H.IV[:4], counter & M32, (counter >> 32) & M32, block_len, flags],
        dtype=torch.int64, device=cv.device,
    )
    s = torch.cat([cv, tail[:, None].expand(8, n)])
    diag, undiag = _DIAG.to(cv.device), _UNDIAG.to(cv.device)
    perm = torch.tensor(H.MSG_PERMUTATION, device=cv.device)
    for r in range(7):
        s = _g(s, m[0:8:2], m[1:8:2])
        s = _g(s[diag], m[8:16:2], m[9:16:2])[undiag]
        if r != 6:
            m = m[perm]
    return s[:8] ^ s[8:]


def _iv(n: int, device) -> torch.Tensor:
    return torch.tensor(H.IV, dtype=torch.int64, device=device)[:, None].expand(8, n)


def hash_felt_rows(rows: torch.Tensor) -> torch.Tensor:
    """``Blake3_256::hash_elements`` of each row: (h, w) int64 canonical
    elements -> (h, 8) 32-bit digest words (LE) in int64. A row's w·8 bytes
    must fit one BLAKE3 chunk (w <= 128), as in ``miden_tpu``."""
    n, w = rows.shape
    nbytes = w * 8
    assert nbytes <= H.CHUNK_LEN, "row exceeds one BLAKE3 chunk"
    # (2w, n) message words, the low half of each element first
    words = torch.stack([rows & M32, (rows >> 32) & M32], dim=2).reshape(n, 2 * w).T
    cv = _iv(n, rows.device)
    nblocks = max(1, (nbytes + H.BLOCK_LEN - 1) // H.BLOCK_LEN)
    for b in range(nblocks):
        blk = words[b * 16 : (b + 1) * 16]
        if blk.shape[0] < 16:
            blk = torch.nn.functional.pad(blk, (0, 0, 0, 16 - blk.shape[0]))
        block_len = min(H.BLOCK_LEN, nbytes - b * H.BLOCK_LEN)
        flags = (H.CHUNK_START if b == 0 else 0) | ((H.CHUNK_END | H.ROOT) if b == nblocks - 1 else 0)
        cv = compress(cv, blk, 0, block_len, flags)
    return cv.T.contiguous()


def compress_pairs(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Merkle merge ``blake3(left_bytes || right_bytes)`` per row: (n, 8)
    words each -> (n, 8). A 64-byte input is one block with flags
    CHUNK_START | CHUNK_END | ROOT (crates/lib/core/asm/crypto/hashes/
    blake3.masm:31 ``push.11.64.0.0``)."""
    m = torch.cat([left.T, right.T])
    out = compress(_iv(left.shape[0], left.device), m, 0, H.BLOCK_LEN, H.CHUNK_START | H.CHUNK_END | H.ROOT)
    return out.T.contiguous()


def digests_to_bytes(digests, out_len: int = 32) -> list[bytes]:
    """(n, 8) words -> list of digest byte strings (LE words)."""
    arr = np.asarray(torch.as_tensor(digests).cpu().numpy(), dtype="<u4")
    return [row.tobytes()[:out_len] for row in arr]
