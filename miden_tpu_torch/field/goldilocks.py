"""Goldilocks field arithmetic on torch tensors.

A field element ``a < p = 2^64 - 2^32 + 1`` is ONE ``torch.int64`` tensor
element holding the u64 bits of ``a`` (values ≥ 2^63 read as negative
int64s). Unlike ``miden_tpu.field.goldilocks`` there is no ``(lo, hi)`` u32
pair: that layout answers the TPU's lack of a 64-bit multiply, and a GPU
has one. ``torch.uint64`` is not used because torch has no add, sub, shift
or compare for it on the CPU.

The plain ops below rely on int64 wrap-around for the low 64 bits of sums
and products, mask after every right shift (torch shifts int64
arithmetically), and compare unsigned values by flipping the sign bit. The
128-bit product is assembled from 32-bit halves and reduced with
``2^64 ≡ 2^32 − 1`` and ``2^96 ≡ −1 (mod p)``.

All values are canonical (``< p``) at function boundaries. Every function
works elementwise over any shape (broadcasting like torch) on whatever
device its inputs lie on.

The quadratic extension ``Fp2 = F[x]/(x^2 − 7)`` is a trailing dimension
of 2: ``t[..., 0] + x·t[..., 1]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.cuda import capturing
from . import gl

I64 = torch.int64
_SIGN = -(1 << 63)  # xor with this maps unsigned order onto signed order
_M32 = 0xFFFFFFFF
_EPS = 0xFFFFFFFF  # 2^32 - 1 == 2^64 mod p


def as_i64(v: int) -> int:
    """Python int in [0, 2^64) → the int64 with the same bits."""
    v &= gl.MASK64
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# Converters (host numpy u64 ⇄ torch int64)
# ---------------------------------------------------------------------------


def to_torch(values, device="cuda") -> torch.Tensor:
    """numpy u64 (or anything ``np.asarray`` takes) → int64 tensor, same bits.
    Raises inside a CUDA-graph capture, which cannot take a host upload."""
    if torch.device(device).type == "cuda" and capturing():
        raise RuntimeError(
            "host upload inside a CUDA graph capture: pass the values as a static "
            "input of the graph, or make a constant table with table() before the capture"
        )
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.uint64))
    return torch.from_numpy(arr.view(np.int64).copy()).to(device)


_TABLES: dict = {}


def table(values, device="cuda") -> torch.Tensor:
    """A constant table that depends on the proof's shape alone (coset
    factors, periodic patterns, a program's constants) on ``device``,
    uploaded at its first use and kept until :func:`clear_tables`: every
    later call returns the same tensor, also inside a CUDA-graph capture.
    The tables are short (a pattern's period, a quotient degree, a
    constraint program's constants), so their values are their key.
    Callers must not write to them."""
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.uint64))
    key = (arr.shape, arr.tobytes(), str(device))
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = to_torch(arr, device)
    return t


def clear_tables() -> None:
    """Forget the constant tables (the fused prover's ``release``)."""
    _TABLES.clear()


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor → numpy u64 with the same bits (host copy)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def from_lo_hi(lo, hi, device="cuda") -> torch.Tensor:
    """``(lo, hi)`` numpy u32 limb planes (``miden_tpu``'s layout) → int64."""
    lo64 = np.asarray(lo, dtype=np.uint64)
    hi64 = np.asarray(hi, dtype=np.uint64)
    return to_torch(lo64 | (hi64 << np.uint64(32)), device)


def const(value: int, shape=(), device="cuda") -> torch.Tensor:
    return torch.full(shape, as_i64(value % gl.P), dtype=I64, device=device)


# ---------------------------------------------------------------------------
# u64 helpers on int64 bits
# ---------------------------------------------------------------------------


def _ult(a, b):
    """Unsigned a < b."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _shr32(x):
    """Logical shift right by 32."""
    return (x >> 32) & _M32


_P_FLIPPED = gl.P ^ (1 << 63)  # p with its sign bit flipped, as an int64 value


def _canonicalize(x):
    """x (any u64) → x mod p, one conditional subtract (2^64 < 2p);
    x − p ≡ x + (2^32 − 1) mod 2^64."""
    return torch.where((x ^ _SIGN) < _P_FLIPPED, x, x + _EPS)


# ---------------------------------------------------------------------------
# Fp
# ---------------------------------------------------------------------------


def add(a, b):
    s = a + b
    s = torch.where(_ult(s, a), s + _EPS, s)  # carry-out: 2^64 ≡ 2^32 − 1
    return _canonicalize(s)


def sub(a, b):
    d = a - b
    return torch.where(_ult(a, b), d - _EPS, d)  # borrow: + p ≡ − (2^32 − 1)


def neg(a):
    return sub(torch.zeros_like(a), a)


def double(a):
    return add(a, a)


def _reduce128(lo, hi):
    """(hi·2^64 + lo) mod p (plonky2's reduce128)."""
    hi_hi = _shr32(hi)
    hi_lo = hi & _M32
    t = lo - hi_hi
    t = torch.where(_ult(lo, hi_hi), t - _EPS, t)
    t1 = (hi_lo << 32) - hi_lo  # hi_lo · (2^32 − 1), exact in 64 bits
    r = t + t1
    r = torch.where(_ult(r, t1), r + _EPS, r)
    return _canonicalize(r)


def mul(a, b):
    """a·b mod p. The high half of the 128-bit product comes from 32-bit
    halves with carries that cannot overflow u64:
    u = a1·b0 + (a0·b0 >> 32), v = a0·b1 + (u mod 2^32),
    hi = a1·b1 + (u >> 32) + (v >> 32); the low half is the wrapped a·b."""
    a0, a1 = a & _M32, _shr32(a)
    b0, b1 = b & _M32, _shr32(b)
    u = a1 * b0 + _shr32(a0 * b0)
    v = a0 * b1 + (u & _M32)
    hi = a1 * b1 + _shr32(u) + _shr32(v)
    return _reduce128(a * b, hi)


def square(a):
    return mul(a, a)


def mul_2exp(a, k: int):
    """a · 2^k."""
    return mul(a, const(pow(2, k, gl.P), device=a.device))


def mul_small(a, k: int):
    """a · k for a small non-negative integer k (shift-and-add)."""
    assert k >= 0
    if k == 0:
        return torch.zeros_like(a)
    result = None
    acc = a
    while k:
        if k & 1:
            result = acc if result is None else add(result, acc)
        k >>= 1
        if k:
            acc = double(acc)
    return result


def pow_const(a, e: int):
    if e == 0:
        return torch.ones_like(a)
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def exp_power_of_2(a, k: int):
    for _ in range(k):
        a = square(a)
    return a


def _inv_fermat(a):
    return pow_const(a, gl.P - 2)


def batch_inv(a):
    """Inverse of every element of a nonzero array along axis 0 (Montgomery's
    trick as a product tree: log-depth up-sweep of pairwise products, one
    Fermat inverse of the root, down-sweep). Trailing axes are batched."""
    n = a.shape[0]
    if n <= 1:
        return _inv_fermat(a)
    size = 1 << (n - 1).bit_length()
    if size != n:
        pad = torch.ones((size - n,) + tuple(a.shape[1:]), dtype=I64, device=a.device)
        a = torch.cat([a, pad], dim=0)
    levels = [a]
    while levels[-1].shape[0] > 1:
        cur = levels[-1]
        levels.append(mul(cur[0::2], cur[1::2]))
    inv = _inv_fermat(levels[-1])
    for cur in reversed(levels[:-1]):
        nxt = torch.empty_like(cur)
        nxt[0::2] = mul(inv, cur[1::2])
        nxt[1::2] = mul(inv, cur[0::2])
        inv = nxt
    return inv[:n]


def inv(a):
    """Inverse of nonzero elements: flat arrays via :func:`batch_inv`,
    scalars via Fermat."""
    if a.ndim == 0:
        return _inv_fermat(a)
    return batch_inv(a.reshape(-1)).reshape(a.shape)


def powers(base: int, n: int, shift: int = 1, device="cuda"):
    """``[shift, shift·base, ..., shift·base^(n−1)]`` in log2(n) doublings."""
    assert n > 0
    out = const(shift, (1,), device)
    step = base % gl.P
    while out.shape[0] < n:
        out = torch.cat([out, mul(out, const(step, device=device))])
        step = gl.mul(step, step)
    return out[:n]


def sum_axis0(x):
    """Exact modular sum over axis 0 (log-depth halving)."""
    while x.shape[0] > 1:
        n = x.shape[0]
        half = n // 2
        folded = add(x[:half], x[half : 2 * half])
        x = torch.cat([folded, x[2 * half :]]) if n % 2 else folded
    return x[0]


# ---------------------------------------------------------------------------
# Fp2 = F[x]/(x^2 − 7), trailing dimension 2
# ---------------------------------------------------------------------------


def ext(c0, c1):
    return torch.stack([c0, c1], dim=-1)


def ext_from_base(a):
    return ext(a, torch.zeros_like(a))


def ext_const(c, shape=(), device="cuda"):
    return ext(const(c[0], shape, device), const(c[1], shape, device))


def ext_add(a, b):
    return add(a, b)


def ext_sub(a, b):
    return sub(a, b)


def ext_neg(a):
    return neg(a)


def ext_mul(a, b):
    a0, a1 = a[..., 0], a[..., 1]
    b0, b1 = b[..., 0], b[..., 1]
    c0 = add(mul(a0, b0), mul_small(mul(a1, b1), gl.W_EXT))
    c1 = add(mul(a0, b1), mul(a1, b0))
    return ext(c0, c1)


def ext_mul_base(a, s):
    """Extension × base: ``s`` broadcasts against ``a[..., 0]``."""
    return mul(a, s.unsqueeze(-1))


def ext_square(a):
    return ext_mul(a, a)


def ext_inv(a):
    a0, a1 = a[..., 0], a[..., 1]
    d = sub(square(a0), mul_small(square(a1), gl.W_EXT))
    di = inv(d)
    return ext(mul(a0, di), mul(neg(a1), di))


def ext_exp_power_of_2(a, k: int):
    for _ in range(k):
        a = ext_square(a)
    return a


def ext_powers(base, n: int):
    """``[1, base, ..., base^(n−1)]`` for an extension scalar ``base`` (2,),
    in log2(n) doublings. Returns (n, 2)."""
    assert n > 0
    out = ext_const((1, 0), (1,), base.device)
    step = base
    while out.shape[0] < n:
        out = torch.cat([out, ext_mul(out, step)])
        step = ext_square(step)
    return out[:n]


def ext_sum_axis0(x):
    return sum_axis0(x)
