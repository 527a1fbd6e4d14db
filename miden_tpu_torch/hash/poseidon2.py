"""Batched Poseidon2 permutation (width 12, Goldilocks) on torch tensors.

The state is one int64 tensor of shape ``(12, n)`` — the caller layout of
``miden_tpu.hash.poseidon2.permute`` — so one call runs ``n`` independent
permutations. Three entry points, each with a hand-written kernel in
``csrc/poseidon2.cu`` (K3) for CUDA tensors and a plain torch twin for CPU
tensors; nothing but the tensor's device chooses between them:

- :func:`permute`: ``(12, n)`` states (the duplex and the PoW grind);
- :func:`absorb_rows`: the LMCS leaf sponge over one row-major matrix, with
  cyclic lifting and a zero-padded tail block;
- :func:`compress_rows`: one Merkle layer over row-major digests,
  ``(2m, 4) → (m, 4)``.

:func:`hash_blocks` and :func:`compress_pairs` are the sponge and the 2-to-1
compression in the layout of ``miden_tpu.hash.poseidon2``.
"""

from __future__ import annotations

import torch

from ..field import goldilocks as F
from ..utils import cuda
from . import constants as C

_ARK_EXT = [C.ARK_EXT_INITIAL[12 * r : 12 * r + 12] for r in range(4)] + [
    C.ARK_EXT_TERMINAL[12 * r : 12 * r + 12] for r in range(4)
]

RATE = 8

#: kernel K3 (replaces miden_tpu/hash/poseidon2_pallas.py `permute_pallas`)
PERMUTE_KERNEL = cuda.Kernel(
    "poseidon2", "poseidon2_permute", [cuda.P, cuda.P, cuda.I64, cuda.P]
)
#: K3's leaf sponge over a row-major matrix (one launch per committed matrix)
ABSORB_KERNEL = cuda.Kernel(
    "poseidon2", "poseidon2_absorb_rows",
    [cuda.P, cuda.P, cuda.P, cuda.I64, cuda.I32, cuda.I64, cuda.P],
)
#: K3's Merkle layer over row-major digests
COMPRESS_KERNEL = cuda.Kernel(
    "poseidon2", "poseidon2_compress_rows", [cuda.P, cuda.P, cuda.I64, cuda.P]
)

_CONSTS: dict = {}  # device -> (ext (8, 12, 1), int (22,), diag (12, 1))


def _constants(device):
    key = str(device)
    if key not in _CONSTS:
        _CONSTS[key] = (
            F.to_torch([[[v] for v in row] for row in _ARK_EXT], device),
            F.to_torch(C.ARK_INT, device),
            F.to_torch([[v] for v in C.MAT_DIAG], device),
        )
    return _CONSTS[key]


def _sbox(x):
    x2 = F.square(x)
    x4 = F.square(x2)
    x3 = F.mul(x2, x)
    return F.mul(x4, x3)


def _mds_external(s):
    """M_E on (12, n): circ(2,3,1,1) per 4-lane chunk as
    ``y_r = (x0+x1+x2+x3) + x_r + 2·x_{(r+1)%4}``, then cross-chunk sums."""
    x = s.reshape(3, 4, -1)
    total = F.add(F.add(x[:, 0], x[:, 1]), F.add(x[:, 2], x[:, 3]))  # (3, n)
    y = F.add(total[:, None], F.add(x, F.double(x[:, [1, 2, 3, 0]])))
    sums = F.add(F.add(y[0], y[1]), y[2])  # (4, n)
    return F.add(y, sums[None]).reshape(s.shape)


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Plain torch Poseidon2 on ``(12, n)`` int64 states (any device)."""
    assert state.shape[0] == 12
    ext, ark_int, diag = _constants(state.device)
    s = _mds_external(state)
    for r in range(4):
        s = _mds_external(_sbox(F.add(s, ext[r])))
    for r in range(C.NUM_INTERNAL_ROUNDS):
        s0 = _sbox(F.add(s[0], ark_int[r]))
        s = torch.cat([s0[None], s[1:]])
        s = F.add(F.sum_axis0(s)[None], F.mul(s, diag))
    for r in range(4, 8):
        s = _mds_external(_sbox(F.add(s, ext[r])))
    return s


def permute_kernel(state: torch.Tensor) -> torch.Tensor:
    """K3 on a CUDA ``(12, n)`` int64 state; any n ≥ 1."""
    cuda.check_tensor(state, "poseidon2 state")
    if state.ndim != 2 or state.shape[0] != 12 or state.shape[1] < 1:
        raise ValueError(f"poseidon2 state: expected (12, n >= 1), got {tuple(state.shape)}")
    out = torch.empty_like(state)
    PERMUTE_KERNEL.launch(
        state.data_ptr(), out.data_ptr(), state.shape[1], key=(state.shape[1],)
    )
    return out


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation on a batch of states, shape ``(12, n)``."""
    if state.is_cuda:
        return permute_kernel(state.contiguous())
    return permute_plain(state)


def absorb_rows_plain(state: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`absorb_rows`: one permutation per rate-8 column
    block of ``m``, each block lifted to ``max_h`` rows and the ragged tail
    block zero-padded."""
    h, w = m.shape
    reps = state.shape[1] // h
    for c0 in range(0, w, RATE):
        chunk = m[:, c0 : c0 + RATE].T  # (≤ 8, h)
        if chunk.shape[0] < RATE:
            pad = torch.zeros((RATE - chunk.shape[0], h), dtype=torch.int64, device=m.device)
            chunk = torch.cat([chunk, pad])
        if reps > 1:
            chunk = chunk.repeat(1, reps)
        state = permute_plain(torch.cat([chunk, state[8:]]))
    return state


def absorb_rows_kernel(state: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """K3's leaf sponge on CUDA tensors: state ``(12, max_h)``, ``m`` an
    ``(h, w)`` row-major matrix, h a power of two dividing max_h."""
    cuda.check_tensor(state, "sponge state")
    cuda.check_tensor(m, "absorbed matrix")
    if state.ndim != 2 or state.shape[0] != 12 or state.shape[1] < 1 or m.ndim != 2:
        raise ValueError(
            f"absorb_rows: expected state (12, max_h) and m (h, w), got "
            f"{tuple(state.shape)} and {tuple(m.shape)}"
        )
    max_h = state.shape[1]
    h, w = m.shape
    if h < 1 or h & (h - 1) or max_h % h or w >= 1 << 31:
        raise ValueError(f"absorb_rows: height {h} must be a power of two dividing {max_h}")
    if w == 0:
        return state
    out = torch.empty_like(state)
    ABSORB_KERNEL.launch(
        state.data_ptr(), out.data_ptr(), m.data_ptr(), h, w, max_h, key=(max_h, h, w)
    )
    return out


def absorb_rows(state: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Absorb every row-major row of ``m`` (h, w) into the overwrite-mode
    sponge states ``(12, max_h)``: state ``d`` takes row ``d mod h``, rate 8."""
    if state.is_cuda:
        return absorb_rows_kernel(state.contiguous(), m.contiguous())
    return absorb_rows_plain(state, m)


def compress_rows_plain(cur: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`compress_rows`: the states [row 2i, row 2i + 1,
    0, 0, 0, 0] permuted and truncated to their first 4 lanes."""
    m = cur.shape[0] // 2
    zeros = torch.zeros((4, m), dtype=torch.int64, device=cur.device)
    out = permute_plain(torch.cat([cur.reshape(m, 8).T, zeros]))
    return out[:4].T.contiguous()


def compress_rows_kernel(cur: torch.Tensor) -> torch.Tensor:
    """K3's Merkle layer on a CUDA ``(2m, 4)`` tensor, 16-byte aligned."""
    cuda.check_tensor(cur, "digest layer")
    if cur.ndim != 2 or cur.shape[1] != 4 or cur.shape[0] < 2 or cur.shape[0] % 2:
        raise ValueError(f"compress_rows: expected (2m, 4) with m >= 1, got {tuple(cur.shape)}")
    if cur.data_ptr() % 16:
        raise ValueError("compress_rows: the digest layer must be 16-byte aligned")
    m = cur.shape[0] // 2
    out = torch.empty((m, 4), dtype=torch.int64, device=cur.device)
    COMPRESS_KERNEL.launch(cur.data_ptr(), out.data_ptr(), m, key=(m,))
    return out


def compress_rows(cur: torch.Tensor) -> torch.Tensor:
    """One Merkle layer: rows ``2i`` and ``2i + 1`` of ``cur`` (2m, 4) compress
    to row ``i`` of the result (m, 4)."""
    if cur.is_cuda:
        return compress_rows_kernel(cur.contiguous())
    return compress_rows_plain(cur)


def hash_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Overwrite-mode sponge over rate-8 blocks: ``(n, n_blocks, 8)`` →
    digests ``(n, 4)``."""
    n, n_blocks, rate = blocks.shape
    assert rate == RATE
    state = torch.zeros((12, n), dtype=torch.int64, device=blocks.device)
    state = absorb_rows(state, blocks.reshape(n, n_blocks * rate))
    return state[:4].T.contiguous()


def compress_pairs(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Truncated-permutation 2-to-1 compression: ``(n, 4) × (n, 4) → (n, 4)``."""
    return compress_rows(torch.stack([left, right], dim=1).reshape(-1, 4))
