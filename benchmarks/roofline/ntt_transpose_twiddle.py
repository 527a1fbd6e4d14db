"""K2 (`csrc/ntt.cu`) `ntt_transpose_twiddle`: the (a, b, w) transpose of
the four-step NTT, times a twiddle table where ``mode`` asks for one."""

from __future__ import annotations

from benchmarks.harness.work import INT32_MULS_PER_MUL


def work_of(key: tuple) -> tuple:
    """(bytes, 32-bit multiplies) of one launch at the shape ``key``."""
    a, b, w, mode = key
    elems = a * b * w
    return (2 * elems + (a * b if mode else 0)) * 8, (elems * INT32_MULS_PER_MUL if mode else 0)
