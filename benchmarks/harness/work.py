"""The work one kernel launch needs at least: bytes moved and 32-bit integer
multiplies, from the launch's shape alone. A frozen copy of the arithmetic
of the port's ``bench_kernels.py`` and ``bench_quotient.py`` (the files under
``roofline/`` use it), so that a change to the program cannot change what a
kernel is measured against.

Each input byte is counted once as read and each output byte once as
written, whatever a kernel reads again.
"""

from __future__ import annotations

#: 32-bit multiplies per Goldilocks product: a general 64x64 -> 128-bit
#: product is four 32x32 -> 64 partial products, each a low and a high half;
#: a square needs three (lo*lo, hi*hi, and lo*hi once, doubled)
INT32_MULS_PER_MUL, INT32_MULS_PER_SQUARE = 8, 6
#: x^7 as x^2, x^4 (squares) and x^3, x^7 (products)
_X7 = 2 * INT32_MULS_PER_SQUARE + 2 * INT32_MULS_PER_MUL
#: x^(1/7) by the reference's addition chain: 63 squares and 9 products
_X_INV7 = 63 * INT32_MULS_PER_SQUARE + 9 * INT32_MULS_PER_MUL
#: x^7 in F_p[phi]/(phi^3 - phi - 1): two extension squares and two
#: extension products, each 6 base squares / products (Karatsuba)
_X7_EXT3 = 2 * 6 * INT32_MULS_PER_SQUARE + 2 * 6 * INT32_MULS_PER_MUL
#: 32-bit multiplies per permutation. Poseidon2: 8 external rounds x 12
#: S-boxes plus 22 internal rounds x 1 (the internal diagonal's entries are
#: +-2^k, +-3 and +-2^-k: shifts and adds). RPO: 7 rounds x 12 lanes x
#: (x^7 + x^(1/7)). RPX: 3 such rounds, plus 3 E rounds of four
#: cubic-extension x^7. The MDS of RPO / RPX is multiply-adds by constants
#: <= 26, not counted.
INT32_MULS_PER_PERM = {
    "poseidon2": (8 * 12 + 22) * _X7,
    "rpo": 7 * 12 * (_X7 + _X_INV7),
    "rpx": 3 * 12 * (_X7 + _X_INV7) + 3 * 4 * _X7_EXT3,
}
STATE = 12  # a sponge state's field elements
RATE = 8


def permute(perm: str, key: tuple) -> tuple:
    """``n`` states permuted: each read and written once."""
    (n,) = key
    return 2 * STATE * n * 8, INT32_MULS_PER_PERM[perm] * n


def absorb_rows(perm: str, key: tuple) -> tuple:
    """``max_h`` states absorb the rows of an (h, w) matrix (state j takes row
    j mod h), one permutation per block of 8 columns."""
    max_h, h, w = key
    blocks = -(-w // RATE)
    return (h * w + 2 * STATE * max_h) * 8, blocks * INT32_MULS_PER_PERM[perm] * max_h


def compress_rows(perm: str, key: tuple) -> tuple:
    """``m`` 2-to-1 compressions of digest rows 2i, 2i + 1 into row i."""
    (m,) = key
    return (2 * m * 4 + m * 4) * 8, INT32_MULS_PER_PERM[perm] * m
