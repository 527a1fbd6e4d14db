"""Batched Poseidon2 permutation (width 12, Goldilocks) on torch tensors.

The state is one int64 tensor of shape ``(12, n)`` — the caller layout of
``miden_tpu.hash.poseidon2.permute`` — so one call runs ``n`` independent
permutations. The three entries of :class:`~.sponge.Sponge` over
:func:`permute_plain`, each with kernel K3 (``csrc/poseidon2.cu``) for CUDA
tensors and a plain torch twin for CPU tensors:

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
from . import constants as C
from .sponge import Sponge

_ARK_EXT = [C.ARK_EXT_INITIAL[12 * r : 12 * r + 12] for r in range(4)] + [
    C.ARK_EXT_TERMINAL[12 * r : 12 * r + 12] for r in range(4)
]

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


#: K3 (replaces miden_tpu/hash/poseidon2_pallas.py `permute_pallas`)
POSEIDON2 = Sponge("poseidon2", "poseidon2", "Poseidon2", permute_plain)
PERMUTE_KERNEL = POSEIDON2.PERMUTE_KERNEL
ABSORB_KERNEL = POSEIDON2.ABSORB_KERNEL
COMPRESS_KERNEL = POSEIDON2.COMPRESS_KERNEL

permute_kernel = POSEIDON2.permute_kernel
permute = POSEIDON2.permute
absorb_rows_plain = POSEIDON2.absorb_rows_plain
absorb_rows_kernel = POSEIDON2.absorb_rows_kernel
absorb_rows = POSEIDON2.absorb_rows
compress_rows_plain = POSEIDON2.compress_rows_plain
compress_rows_kernel = POSEIDON2.compress_rows_kernel
compress_rows = POSEIDON2.compress_rows
hash_blocks = POSEIDON2.hash_blocks
compress_pairs = POSEIDON2.compress_pairs
