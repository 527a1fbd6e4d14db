"""Batched Poseidon2 permutation (width 12, Goldilocks) on torch tensors.

The state is one int64 tensor of shape ``(12, n)`` — the caller layout of
``miden_tpu.hash.poseidon2.permute`` — so one call runs ``n`` independent
permutations. :func:`permute` launches kernel K3 (``csrc/poseidon2.cu``) on a
CUDA tensor and runs the plain torch version :func:`permute_plain` on a CPU
tensor; nothing else chooses between them.

:func:`hash_blocks` (LMCS leaves, overwrite sponge at rate 8) and
:func:`compress_pairs` (Merkle layers) are the sponge choreography around it.
"""

from __future__ import annotations

import torch

from ..field import goldilocks as F
from ..utils import cuda
from . import constants as C

_ARK_EXT = [C.ARK_EXT_INITIAL[12 * r : 12 * r + 12] for r in range(4)] + [
    C.ARK_EXT_TERMINAL[12 * r : 12 * r + 12] for r in range(4)
]

#: kernel K3 (replaces miden_tpu/hash/poseidon2_pallas.py `permute_pallas`)
PERMUTE_KERNEL = cuda.Kernel(
    "poseidon2", "poseidon2_permute", [cuda.P, cuda.P, cuda.I64, cuda.P]
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


def hash_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Overwrite-mode sponge over rate-8 blocks: ``(n, n_blocks, 8)`` →
    digests ``(n, 4)``."""
    n, n_blocks, rate = blocks.shape
    assert rate == 8
    state = torch.zeros((12, n), dtype=torch.int64, device=blocks.device)
    for b in range(n_blocks):
        state = permute(torch.cat([blocks[:, b].T, state[8:]]))
    return state[:4].T.contiguous()


def compress_pairs(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Truncated-permutation 2-to-1 compression: ``(n, 4) × (n, 4) → (n, 4)``."""
    n = left.shape[0]
    zeros = torch.zeros((4, n), dtype=torch.int64, device=left.device)
    out = permute(torch.cat([left.T, right.T, zeros]))
    return out[:4].T.contiguous()
