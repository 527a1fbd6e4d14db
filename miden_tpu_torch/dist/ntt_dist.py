"""Row-sharded Goldilocks coset LDE over a mesh (``miden_tpu/dist/ntt_dist.py``).

With ``D`` ranks holding contiguous row blocks of ``S = n/D`` rows, a DIF
butterfly stage over blocks of ``m`` rows crosses ranks iff ``m/2 ≥ S``:
exactly the first ``log2 D`` stages (for DIT, the last ``log2 D``). Those
stages exchange whole blocks between partner ranks ``k`` and
``k ^ (D >> (s+1))``; the top rank keeps ``a + b``, the bottom one
``(a − b)·T`` (DIT: the bottom rank multiplies by ``T`` before the swap).
The LDE is two halves, each its own function: the interpolation
(:func:`coset_interpolate_bitrev_sharded`) and the evaluation of
bit-reversed coefficients on a larger coset
(:func:`evaluate_coeffs_on_coset_sharded`); the quotient's upsampling and
chunk LDE use them apart. Every other stage, and the zero-pad of the LDE in
bit-reversed coefficient space, stays within the block and runs the single-device transforms of
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


def _check_blocks(rows: int, mesh: Mesh, what: str) -> int:
    log_n = rows.bit_length() - 1
    d = mesh.size
    if rows != 1 << log_n or d & (d - 1) or rows // d < 2:
        raise ValueError(f"{what}: {rows} rows over {d} ranks (powers of two, ≥ 2 rows a block)")
    return log_n


def _bitrev_shift_powers(shift: int, n: int, mesh: Mesh, device) -> torch.Tensor:
    """This rank's block of ``ntt.shift_powers(shift, n, bitrev=True)``,
    made without the whole table: position ``k·R + j`` (``R = n/D``) is
    ``shift^{bitrev_D(k) + D·bitrev_R(j)}``."""
    d = mesh.size
    rows = n // d
    k_rev = int(format(mesh.rank, f"0{(d.bit_length() - 1)}b")[::-1], 2) if d > 1 else 0
    base = ntt.shift_powers(gl.exp_power_of_2(shift % gl.P, d.bit_length() - 1), rows, True, device)
    lead = pow(shift % gl.P, k_rev, gl.P)
    return base if lead == 1 else F.mul(base, F.const(lead, device=device))


def coset_interpolate_bitrev_sharded(x: RowShard, shift: int, mesh: Mesh) -> RowShard:
    """Sharded twin of :func:`miden_tpu_torch.ntt.ntt.coset_interpolate_bitrev`:
    this rank's block of natural evaluations over ``shift·H`` → its block of
    the bit-reversed coefficients. The cross inverse-DIF stages, the local
    stages, the global ``1/n`` and this rank's slice of the ``shift^{-i}``
    powers."""
    n = x.rows
    log_n = _check_blocks(n, mesh, "coset_interpolate_bitrev_sharded")
    y = x.local
    for s in range(mesh.size.bit_length() - 1):
        y = _dif_cross(y, _cross_twiddles(log_n, s, True, mesh), s, mesh)
    y = ntt.dft_dif(y, inverse=True)
    y = F.mul(y, F.const(gl.inv(n % gl.P), device=y.device))
    if shift % gl.P != 1:
        y = F.mul(y, _bitrev_shift_powers(gl.inv(shift % gl.P), n, mesh, y.device)[:, None])
    return RowShard(y, n)


def evaluate_coeffs_on_coset_sharded(coeffs: RowShard, added_bits: int, shift: int, mesh: Mesh) -> RowShard:
    """Sharded twin of :func:`miden_tpu_torch.ntt.ntt.evaluate_coeffs_on_coset`:
    this rank's block of bit-reversed coefficients (size n) → its block of
    the natural evaluations over ``shift·K``, ``|K| = n·2^added_bits``. The
    zero-pad (block-local in bit-reversed order), this rank's slice of the
    ``shift^i`` powers, the local DIT stages, then the cross stages."""
    _check_blocks(coeffs.rows, mesh, "evaluate_coeffs_on_coset_sharded")
    big_n = coeffs.rows << added_bits
    y = ntt._pad_bitrev_coeffs(coeffs.local, added_bits)
    if shift % gl.P != 1:
        y = F.mul(y, _bitrev_shift_powers(shift, big_n, mesh, y.device)[:, None])
    y = ntt.dft_dit(y)
    log_big = big_n.bit_length() - 1
    for s in reversed(range(mesh.size.bit_length() - 1)):
        y = _dit_cross(y, _cross_twiddles(log_big, s, False, mesh), s, mesh)
    return RowShard(y, big_n)


def coset_lde_sharded(evals, added_bits: int, shift_out: int, mesh: Mesh, shift_in: int = 1) -> RowShard:
    """Sharded twin of :func:`miden_tpu_torch.ntt.ntt.coset_lde`: natural
    evaluations over ``shift_in·H`` (the whole ``(n, w)`` tensor, which
    every rank holds, or this rank's :class:`RowShard` of it) → this rank's
    block of the natural evaluations over ``shift_out·K``,
    ``|K| = n·2^added_bits``: :func:`coset_interpolate_bitrev_sharded` then
    :func:`evaluate_coeffs_on_coset_sharded` (the two coset factors are
    exact field products, so their product is ``coset_lde``'s one factor)."""
    x = evals if isinstance(evals, RowShard) else shard_rows(evals, mesh)
    coeffs = coset_interpolate_bitrev_sharded(x, shift_in, mesh)
    return evaluate_coeffs_on_coset_sharded(coeffs, added_bits, shift_out, mesh)
