"""K1 (`csrc/ntt.cu`) `ntt_col_transform`: a radix-2 transform of length
2^log_n down each of m columns."""

from __future__ import annotations

from benchmarks.harness.work import INT32_MULS_PER_MUL


def work_of(key: tuple) -> tuple:
    """(bytes, 32-bit multiplies) of one launch at the shape ``key``: the
    matrix read and written once with the 2^log_n - 1 twiddles; one
    product per butterfly, (n m / 2) log_n butterflies."""
    log_n, m, _dit, _inverse = key
    elems = (1 << log_n) * m
    return (2 * elems + (1 << log_n) - 1) * 8, (elems // 2) * log_n * INT32_MULS_PER_MUL
