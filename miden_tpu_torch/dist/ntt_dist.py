"""Row-sharded Goldilocks coset LDE over a mesh (``miden_tpu/dist/ntt_dist.py``).

With ``D`` ranks holding contiguous row blocks of ``S = n/D`` rows, a DIF
butterfly stage over blocks of ``m`` rows crosses ranks iff ``m/2 ≥ S``:
exactly the first ``log2 D`` stages (for DIT, the last ``log2 D``). Those
stages exchange whole blocks between partner ranks ``k`` and
``k ^ (D >> (s+1))``; the top rank keeps ``a + b``, the bottom one
``(a − b)·T`` (DIT: the bottom rank multiplies by ``T`` before the swap).
Every other stage, and the zero-pad of the LDE in bit-reversed coefficient
space, stays within the block and runs the single-device transforms of
:mod:`miden_tpu_torch.ntt.ntt` (K1 / K2 on a card) unchanged, so the result
is bit-identical to :func:`~miden_tpu_torch.ntt.ntt.coset_lde`.

The cross-stage butterflies are plain torch field ops, as ``miden_tpu``'s
are XLA rather than Pallas.

Reference analog: p3-dft ``Radix2DitParallel`` under rayon
(crates/lifted-stark/src/prover/commit.rs:173).
"""

from __future__ import annotations

import torch

from ..field import gl
from ..field import goldilocks as F
from ..ntt import ntt
from .mesh import Mesh, RowShard, exchange, shard_rows


def _cross_twiddles(log_n: int, s: int, inverse: bool, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of stage ``s``'s table ``T[r] = ω_m^{r mod m/2}``
    (``m = n >> s``): ``m/2`` is a multiple of the block, so they are one
    slice of the stage's twiddles in :func:`ntt.stage_twiddles`."""
    n = 1 << log_n
    shard = n // mesh.size
    start = (n - (n >> s)) + (mesh.rank * shard) % (n >> (s + 1))
    return ntt.stage_twiddles(log_n, inverse, mesh.device)[start : start + shard]


def _is_top(s: int, mesh: Mesh) -> bool:
    return mesh.rank & (mesh.size >> (s + 1)) == 0


def _dif_cross(x: torch.Tensor, tw: torch.Tensor, s: int, mesh: Mesh) -> torch.Tensor:
    """One cross-rank DIF stage: top ← a + b, bottom ← (a − b)·T."""
    other = exchange(x, mesh.rank ^ (mesh.size >> (s + 1)), mesh)
    if _is_top(s, mesh):
        return F.add(x, other)
    return F.mul(F.sub(other, x), tw[:, None])


def _dit_cross(x: torch.Tensor, tw: torch.Tensor, s: int, mesh: Mesh) -> torch.Tensor:
    """One cross-rank DIT stage: the bottom block is multiplied by T, then
    top ← t + u, bottom ← t − u."""
    top = _is_top(s, mesh)
    pre = x if top else F.mul(x, tw[:, None])
    other = exchange(pre, mesh.rank ^ (mesh.size >> (s + 1)), mesh)
    return F.add(pre, other) if top else F.sub(other, pre)


def coset_lde_sharded(evals: torch.Tensor, added_bits: int, shift_out: int, mesh: Mesh, shift_in: int = 1) -> RowShard:
    """Sharded twin of :func:`miden_tpu_torch.ntt.ntt.coset_lde`: natural
    evaluations over ``shift_in·H`` (the whole ``(n, w)`` tensor, which
    every rank holds) → this rank's block of the natural evaluations over
    ``shift_out·K``, ``|K| = n·2^added_bits``."""
    x = shard_rows(evals, mesh)
    n = x.rows
    log_n = n.bit_length() - 1
    d = mesh.size
    log_d = d.bit_length() - 1
    if n != 1 << log_n or d != 1 << log_d or n // d < 2:
        raise ValueError(f"coset_lde_sharded: {n} rows over {d} ranks (powers of two, ≥ 2 rows a block)")
    big_n = n << added_bits
    eff = gl.mul(shift_out % gl.P, gl.inv(shift_in % gl.P)) if shift_in != 1 else shift_out % gl.P

    # 1. interpolate: cross inverse-DIF stages, local stages, the GLOBAL 1/n
    y = x.local
    for s in range(log_d):
        y = _dif_cross(y, _cross_twiddles(log_n, s, True, mesh), s, mesh)
    y = ntt.dft_dif(y, inverse=True)
    y = F.mul(y, F.const(gl.inv(n % gl.P), device=y.device))
    # 2. zero-pad in bit-reversed coefficient space (block-local)
    y = ntt._pad_bitrev_coeffs(y, added_bits)
    # 3. coset shift: this rank's slice of the bit-reversed powers
    if eff != 1:
        rows = y.shape[0]
        pw = ntt.shift_powers(eff, big_n, True, y.device)[mesh.rank * rows : (mesh.rank + 1) * rows]
        y = F.mul(y, pw[:, None])
    # 4. evaluate: local DIT stages, then the cross stages in reverse order
    y = ntt.dft_dit(y)
    for s in reversed(range(log_d)):
        y = _dit_cross(y, _cross_twiddles(log_n + added_bits, s, False, mesh), s, mesh)
    return RowShard(y, big_n)
