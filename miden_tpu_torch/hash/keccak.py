"""Batched Keccak-256 in plain torch (the Keccak-256 LMCS configuration).

Port of ``miden_tpu/hash/keccak.py`` (reference air/src/config.rs
``keccak_config``). A Keccak lane is a 64-bit word, kept whole here: one
int64 holds its bits, rotates are a left shift or'ed with a masked right
shift (int64's right shift carries the sign). ``miden_tpu`` splits each lane
into (lo, hi) uint32 halves for the TPU; that split is not kept.

The state is one (25, n) tensor, lane ``x + 5y`` in row ``x + 5y``, and each
step of a round (θ, ρ and π, χ, ι) is a few ops on the whole state, so a
permutation is ~600 tensor ops whatever n. It runs on the caller's device;
``miden_tpu`` computes it in XLA, with no Pallas kernel, so the port has no
kernel for it.

Digests use the layout of :mod:`.blake3`: (n, 8) 32-bit words (LE) in int64.

Ground truth: ``keccak_host`` (pinned to the reference's NIST vectors).
"""

from __future__ import annotations

import numpy as np
import torch

from ..field.goldilocks import as_i64
from . import keccak_host as H

RATE_WORDS = H.RATE // 8  # 17 u64 lanes absorbed per block
M32 = 0xFFFFFFFF

#: π: lane j of the rotated state comes from lane _PI_SRC[j]; ρ rotates
#: lane i left by _RHO[i]
_PI_SRC = [0] * 25
_RHO = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
        _RHO[_x + 5 * _y] = H.ROTATIONS[_x][_y]
#: χ reads lanes x + 1 and x + 2 of the same row y
_CHI1 = [(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)]
_CHI2 = [(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)]
_RC = [as_i64(rc) for rc in H.ROUND_CONSTANTS]


def _rotl(x: torch.Tensor, n) -> torch.Tensor:
    """Rotate each 64-bit lane left by ``n`` (an int, or a tensor that
    broadcasts against ``x``, with entries in 0..63)."""
    return (x << n) | ((x >> (64 - n)) & ((1 << n) - 1))


def keccak_f(a: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] on a (25, n) int64 state."""
    dev = a.device
    rho = torch.tensor(_RHO, dtype=torch.int64, device=dev)[:, None]
    pi_src, chi1, chi2 = (torch.tensor(t, device=dev) for t in (_PI_SRC, _CHI1, _CHI2))
    prev, nxt = torch.tensor([4, 0, 1, 2, 3], device=dev), torch.tensor([1, 2, 3, 4, 0], device=dev)
    for rc in _RC:
        rows = a.view(5, 5, -1)  # [y][x]
        c = rows[0] ^ rows[1] ^ rows[2] ^ rows[3] ^ rows[4]  # (5, n)
        d = c[prev] ^ _rotl(c[nxt], 1)
        a = (rows ^ d).view(25, -1)
        b = _rotl(a, rho)[pi_src]
        a = b ^ (~b[chi1] & b[chi2])
        a[0] ^= rc
    return a


def _absorb(words: torch.Tensor) -> torch.Tensor:
    """Sponge over (k, n) u64 lanes, already pad10*1-padded to a multiple of
    17 lanes; returns the (25, n) state."""
    k, n = words.shape
    assert k % RATE_WORDS == 0
    state = torch.zeros((25, n), dtype=torch.int64, device=words.device)
    for off in range(0, k, RATE_WORDS):
        state[:RATE_WORDS] ^= words[off : off + RATE_WORDS]
        state = keccak_f(state)
    return state


def _pad(words: torch.Tensor) -> torch.Tensor:
    """pad10*1 after whole u64 lanes: 0x01 in the first byte of the next
    lane, 0x80 in the last byte of the block."""
    k, n = words.shape
    total = (k // RATE_WORDS + 1) * RATE_WORDS
    out = torch.zeros((total, n), dtype=torch.int64, device=words.device)
    out[:k] = words
    out[k] ^= 1
    out[-1] ^= as_i64(0x80 << 56)
    return out


def _digest_words(state: torch.Tensor) -> torch.Tensor:
    """The first four lanes as (n, 8) LE 32-bit words."""
    lanes = state[:4].T  # (n, 4)
    return torch.stack([lanes & M32, (lanes >> 32) & M32], dim=2).reshape(-1, 8)


def hash_felt_rows(rows: torch.Tensor) -> torch.Tensor:
    """``Keccak256::hash_elements`` per row: (h, w) int64 canonical elements
    -> (h, 8) 32-bit digest words (LE) in int64."""
    return _digest_words(_absorb(_pad(rows.T)))


def compress_pairs(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Merkle merge ``keccak256(left_bytes || right_bytes)`` per row: (n, 8)
    words each -> (n, 8)."""
    words = torch.cat([left, right], dim=1)  # (n, 16) 32-bit words
    lanes = words[:, 0::2] | (words[:, 1::2] << 32)  # (n, 8) u64 lanes
    return _digest_words(_absorb(_pad(lanes.T)))


def digests_to_bytes(digests) -> list[bytes]:
    """(n, 8) words -> 32-byte digest strings."""
    arr = np.asarray(torch.as_tensor(digests).cpu().numpy(), dtype="<u4")
    return [row.tobytes() for row in arr]
