"""Goldilocks NTT / low-degree extension on torch tensors.

Same conventions as ``miden_tpu.ntt.ntt``:

- arrays are ``(n, batch)`` int64; the transform runs along axis 0;
- :func:`dft_dif`: natural input → bit-reversed output; :func:`dft_dit`:
  bit-reversed input → natural output; both evaluate ``Σ_j x[j]·ω^{jk}``
  (``ω^{-jk}`` with ``inverse=True``, the caller applying the 1/n scale);
- :func:`interpolate_bitrev`, :func:`coset_lde`,
  :func:`coset_interpolate_bitrev` and :func:`evaluate_coeffs_on_coset`
  build on those two.

On a CUDA tensor the transforms run the four-step decomposition
(:func:`four_step_dif` / :func:`four_step_dit`) over kernel K1
(``ntt_col_transform``: a whole sub-transform of up to 2^MAX_LOG_SINGLE rows
in one launch: column tiles staged through shared memory by cp.async, the
next in flight while the current one is transformed, groups of up to four
stages in registers between passes over the tile) and kernel K2
(``ntt_transpose_twiddle``: outer-twiddle multiply fused with the
transpose), both in ``csrc/ntt.cu``. On a CPU tensor
they run the plain stage-by-stage butterflies. The decomposition is plain
Python over :func:`col_transform` and :func:`transpose_twiddle`, each of
which takes its kernel on CUDA and its plain version on the CPU, so the
four-step code runs (and is tested) on the CPU too.
"""

from __future__ import annotations

import torch

from ..field import gl
from ..field import goldilocks as F
from ..utils import cuda

MAX_LOG_SINGLE = 12  # largest sub-transform K1 does in one launch

#: kernel K1 (replaces miden_tpu/ntt/ntt_pallas.py `_col_transform`)
COL_KERNEL = cuda.Kernel(
    "ntt", "ntt_col_transform",
    [cuda.P, cuda.P, cuda.P, cuda.I32, cuda.I64, cuda.I32, cuda.P],
)
#: kernel K2 (the four-step twiddle multiply + transposes of
#: miden_tpu/ntt/ntt_pallas.py `dft_dif` / `dft_dit`)
TRANSPOSE_KERNEL = cuda.Kernel(
    "ntt", "ntt_transpose_twiddle",
    [cuda.P, cuda.P, cuda.P, cuda.I64, cuda.I64, cuda.I32, cuda.I32, cuda.P],
)

_STAGE_TW: dict = {}  # (log_n, inverse, device) -> (n − 1,) compact stage twiddles
_OUTER_TW: dict = {}  # (log_n1, log_n2, inverse, device) -> (n1, n2)
_POWERS: dict = {}  # (shift, n, bitrev, device) -> (n,)
_BITREV: dict = {}  # (n, device) -> (n,) index


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    assert n == 1 << log_n, f"size {n} is not a power of two"
    return log_n


def stage_twiddles(log_n: int, inverse: bool, device) -> torch.Tensor:
    """Stage s of a size-2^log_n transform (block size m = n >> s) uses
    ``[ω_m^0, ..., ω_m^{m/2−1}]``, stored at offset ``n − (n >> s)``: the
    values of ``miden_tpu``'s ``_stage_twiddles`` / ``_stage_tw_table``."""
    key = (log_n, inverse, str(device))
    if key not in _STAGE_TW:
        parts = []
        for s in range(log_n):
            w = gl.two_adic_generator(log_n - s)
            if inverse:
                w = gl.inv(w)
            parts.append(F.powers(w, 1 << (log_n - s - 1), device=device))
        _STAGE_TW[key] = (
            torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64, device=device)
        )
    return _STAGE_TW[key]


def _bitrev_index(n: int, device) -> torch.Tensor:
    key = (n, str(device))
    if key not in _BITREV:
        log_n = _log2(n)
        idx = torch.arange(n)
        rev = torch.zeros(n, dtype=torch.int64)
        for b in range(log_n):
            rev |= ((idx >> b) & 1) << (log_n - 1 - b)
        _BITREV[key] = rev.to(device)
    return _BITREV[key]


def bitrev_perm(x: torch.Tensor) -> torch.Tensor:
    """Bit-reversal permutation along axis 0 (power-of-two length)."""
    n = x.shape[0]
    if n <= 2:
        return x
    return x.index_select(0, _bitrev_index(n, x.device))


def shift_powers(shift: int, n: int, bitrev: bool, device) -> torch.Tensor:
    """``shift^k`` for k = 0..n−1 (optionally bit-reversed), cached."""
    key = (shift % gl.P, n, bitrev, str(device))
    if key not in _POWERS:
        p = F.powers(shift, n, device=device)
        _POWERS[key] = bitrev_perm(p) if bitrev else p
    return _POWERS[key]


# ---------------------------------------------------------------------------
# Plain stage-by-stage transforms (the CPU path and the twin of K1)
# ---------------------------------------------------------------------------


def _butterfly_dif(x, tw):
    """One DIF stage. x: (blocks, m, batch); tw: (m/2,)."""
    blocks, m, batch = x.shape
    a, b = x[:, : m // 2], x[:, m // 2 :]
    top = F.add(a, b)
    bot = F.mul(F.sub(a, b), tw[None, :, None])
    return torch.stack([top, bot], dim=1).reshape(blocks * 2, m // 2, batch)


def _butterfly_dit(x, tw):
    """One DIT stage. x: (2·blocks, m/2, batch); tw: (m/2,)."""
    blocks2, half, batch = x.shape
    y = x.reshape(blocks2 // 2, 2, half, batch)
    utw = F.mul(y[:, 1], tw[None, :, None])
    top = F.add(y[:, 0], utw)
    bot = F.sub(y[:, 0], utw)
    return torch.stack([top, bot], dim=1).reshape(blocks2 // 2, 2 * half, batch)


def transform_plain(x: torch.Tensor, inverse: bool, dit: bool) -> torch.Tensor:
    """All log n stages along axis 0 of an (n, batch) array, plain torch."""
    n, batch = x.shape
    log_n = _log2(n)
    tws = stage_twiddles(log_n, inverse, x.device)
    offs = [n - (n >> s) for s in range(log_n + 1)]
    if dit:
        y = x.reshape(n, 1, batch)
        for s in reversed(range(log_n)):
            y = _butterfly_dit(y, tws[offs[s] : offs[s + 1]])
    else:
        y = x.reshape(1, n, batch)
        for s in range(log_n):
            y = _butterfly_dif(y, tws[offs[s] : offs[s + 1]])
    return y.reshape(n, batch)


def col_transform_kernel(x: torch.Tensor, inverse: bool, dit: bool) -> torch.Tensor:
    """K1 on a CUDA (n, M) int64 array, n ≤ 2^MAX_LOG_SINGLE."""
    cuda.check_tensor(x, "ntt input")
    if x.ndim != 2:
        raise ValueError(f"ntt input: expected (n, M), got {tuple(x.shape)}")
    n, m_cols = x.shape
    log_n = _log2(n)
    if log_n > MAX_LOG_SINGLE:
        raise ValueError(f"ntt_col_transform takes n <= 2^{MAX_LOG_SINGLE}, got 2^{log_n}")
    if log_n == 0 or m_cols == 0:
        return x.clone()
    tw = stage_twiddles(log_n, inverse, x.device)
    out = torch.empty_like(x)
    COL_KERNEL.launch(
        x.data_ptr(), out.data_ptr(), tw.data_ptr(), log_n, m_cols, int(dit),
        key=(log_n, m_cols, dit, inverse),
    )
    return out


def col_transform(x: torch.Tensor, inverse: bool, dit: bool) -> torch.Tensor:
    if x.is_cuda:
        return col_transform_kernel(x, inverse, dit)
    return transform_plain(x, inverse, dit)


def transpose_twiddle_plain(x, tw, mode: int):
    """(A, B, w) → (B, A, w), times tw[a, b] (mode 1), tw[b, a] (mode 2) or
    nothing (mode 0)."""
    y = x.transpose(0, 1)
    if mode == 1:
        y = F.mul(y, tw.T[:, :, None])
    elif mode == 2:
        y = F.mul(y, tw[:, :, None])
    return y.contiguous()


def transpose_twiddle_kernel(x, tw, mode: int):
    """K2 on a CUDA (A, B, w) int64 array."""
    cuda.check_tensor(x, "transpose input")
    if x.ndim != 3:
        raise ValueError(f"transpose input: expected (A, B, w), got {tuple(x.shape)}")
    a, b, w = x.shape
    if mode:
        cuda.check_tensor(tw, "outer twiddles", (a, b) if mode == 1 else (b, a))
    if b > 65535 or a * w >= (1 << 31):
        raise ValueError(f"transpose input too large: {tuple(x.shape)}")
    out = torch.empty((b, a, w), dtype=torch.int64, device=x.device)
    if x.numel():
        TRANSPOSE_KERNEL.launch(
            x.data_ptr(), out.data_ptr(), tw.data_ptr() if mode else None, a, b, w, mode,
            key=(a, b, w, mode),
        )
    return out


def transpose_twiddle(x, tw, mode: int):
    if x.is_cuda:
        return transpose_twiddle_kernel(x, tw, mode)
    return transpose_twiddle_plain(x, tw, mode)


# ---------------------------------------------------------------------------
# Four-step decomposition (the CUDA path)
# ---------------------------------------------------------------------------


def _split(log_n: int):
    log_n1 = min(MAX_LOG_SINGLE, (log_n + 1) // 2)
    return log_n1, log_n - log_n1


def outer_twiddles(log_n1: int, log_n2: int, inverse: bool, device) -> torch.Tensor:
    """T[r1, j2] = ω_n^{rev_n1(r1)·j2} (ω⁻¹ when inverse), n = n1·n2."""
    key = (log_n1, log_n2, inverse, str(device))
    if key not in _OUTER_TW:
        w = gl.two_adic_generator(log_n1 + log_n2)
        if inverse:
            w = gl.inv(w)
        b = bitrev_perm(F.powers(w, 1 << log_n1, device=device))  # row bases
        t = torch.ones((1 << log_n1, 1), dtype=torch.int64, device=device)
        for _ in range(log_n2):
            t = torch.cat([t, F.mul(t, b[:, None])], dim=1)
            b = F.square(b)
        _OUTER_TW[key] = t.contiguous()
    return _OUTER_TW[key]


def four_step_dif(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Natural → bit-reversed along axis 0 of (n, w): DIF_n1 on the columns
    of (n1, n2·w), twiddle-transpose to (n2, n1, w), DIF_n2, transpose back.
    Flat output is the full bit-reversed result because
    rev_n(k1 + n1·k2) = rev_n1(k1)·n2 + rev_n2(k2)."""
    n, w = x.shape
    log_n = _log2(n)
    if log_n <= MAX_LOG_SINGLE:
        return col_transform(x, inverse, dit=False)
    log_n1, log_n2 = _split(log_n)
    n1, n2 = 1 << log_n1, 1 << log_n2
    a = four_step_dif(x.reshape(n1, n2 * w), inverse)
    tw = outer_twiddles(log_n1, log_n2, inverse, x.device)
    bt = transpose_twiddle(a.reshape(n1, n2, w), tw, 1)
    c = four_step_dif(bt.reshape(n2, n1 * w), inverse)
    return transpose_twiddle(c.reshape(n2, n1, w), None, 0).reshape(n, w)


def four_step_dit(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Bit-reversed → natural: the mirror of :func:`four_step_dif` with the
    same twiddle table."""
    n, w = x.shape
    log_n = _log2(n)
    if log_n <= MAX_LOG_SINGLE:
        return col_transform(x, inverse, dit=True)
    log_n1, log_n2 = _split(log_n)
    n1, n2 = 1 << log_n1, 1 << log_n2
    gt = transpose_twiddle(x.reshape(n1, n2, w), None, 0)
    d = four_step_dit(gt.reshape(n2, n1 * w), inverse)
    tw = outer_twiddles(log_n1, log_n2, inverse, x.device)
    e = transpose_twiddle(d.reshape(n2, n1, w), tw, 2)
    return four_step_dit(e.reshape(n1, n2 * w), inverse).reshape(n, w)


# ---------------------------------------------------------------------------
# Public transforms
# ---------------------------------------------------------------------------


def dft_dif(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Size-n transform along axis 0: natural input → bit-reversed output."""
    if x.is_cuda:
        return four_step_dif(x.contiguous(), inverse)
    return transform_plain(x, inverse, dit=False)


def dft_dit(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Size-n transform along axis 0: bit-reversed input → natural output."""
    if x.is_cuda:
        return four_step_dit(x.contiguous(), inverse)
    return transform_plain(x, inverse, dit=True)


def interpolate_bitrev(evals_natural: torch.Tensor) -> torch.Tensor:
    """Natural evaluations over the order-n subgroup → bit-reversed
    coefficients (1/n scale included)."""
    n = evals_natural.shape[0]
    coeffs = dft_dif(evals_natural, inverse=True)
    return F.mul(coeffs, F.const(gl.inv(n % gl.P), device=coeffs.device))


def evaluate_natural(coeffs_bitrev: torch.Tensor) -> torch.Tensor:
    """Bit-reversed coefficients → natural-order evaluations."""
    return dft_dit(coeffs_bitrev)


def _pad_bitrev_coeffs(coeffs_bitrev, added_bits: int):
    """Zero-pad bit-reversed coefficients n → n·2^added_bits: entry j moves
    to position j·2^added_bits."""
    if added_bits == 0:
        return coeffs_bitrev
    n, batch = coeffs_bitrev.shape
    out = torch.zeros(
        (n, 1 << added_bits, batch), dtype=torch.int64, device=coeffs_bitrev.device
    )
    out[:, 0] = coeffs_bitrev
    return out.reshape(n << added_bits, batch)


def coset_lde(evals_natural, added_bits: int, shift_out: int, shift_in: int = 1):
    """Evaluations over ``shift_in·H`` (natural, size n) → evaluations over
    ``shift_out·K`` (natural, size n·2^added_bits)."""
    n = evals_natural.shape[0]
    coeffs = _pad_bitrev_coeffs(interpolate_bitrev(evals_natural), added_bits)
    eff = (
        gl.mul(shift_out % gl.P, gl.inv(shift_in % gl.P))
        if shift_in != 1
        else shift_out % gl.P
    )
    if eff != 1:
        pw = shift_powers(eff, n << added_bits, True, coeffs.device)
        coeffs = F.mul(coeffs, pw[:, None])
    return dft_dit(coeffs)


def coset_interpolate_bitrev(evals_natural, shift: int):
    """Evaluations over ``shift·H`` (natural) → coefficients of f
    (bit-reversed order)."""
    n = evals_natural.shape[0]
    coeffs = interpolate_bitrev(evals_natural)
    if shift % gl.P != 1:
        pw = shift_powers(gl.inv(shift % gl.P), n, True, coeffs.device)
        coeffs = F.mul(coeffs, pw[:, None])
    return coeffs


def evaluate_coeffs_on_coset(coeffs_bitrev, added_bits: int, shift: int):
    """Bit-reversed coefficients (size n) → natural evaluations over
    ``shift·K``, ``|K| = n·2^added_bits``."""
    coeffs = _pad_bitrev_coeffs(coeffs_bitrev, added_bits)
    if shift % gl.P != 1:
        pw = shift_powers(shift, coeffs.shape[0], True, coeffs.device)
        coeffs = F.mul(coeffs, pw[:, None])
    return dft_dit(coeffs)
