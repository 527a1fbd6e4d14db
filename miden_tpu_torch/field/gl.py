"""Pure-Python Goldilocks field arithmetic (ground truth + host-side helpers).

The Goldilocks prime is ``p = 2^64 - 2^32 + 1`` (reference:
docs/src/design/index.md:10). The multiplicative group has two-adicity 32.

This module is the *exact* arithmetic oracle used by:
- tests of the torch int64 ops in ``miden_tpu_torch.field.goldilocks``;
- host-side protocol bookkeeping (twiddle/constant generation, transcript
  scalars) where an O(1)-sized amount of exact arithmetic is clearer in
  Python integers than on device.

The quadratic extension ``QuadFelt = F[x]/(x^2 - 7)`` mirrors the reference's
``BinomialExtensionField<Goldilocks, 2>`` (core/src/lib.rs:30); ``W = 7`` is
also the multiplicative-group generator.
"""

from __future__ import annotations

P = 0xFFFF_FFFF_0000_0001  # 2^64 - 2^32 + 1
EPSILON = 0xFFFF_FFFF  # 2^32 - 1 == 2^64 mod p
TWO_ADICITY = 32
GENERATOR = 7  # generator of the full multiplicative group
W_EXT = 7  # binomial for the quadratic extension x^2 - 7

MASK64 = (1 << 64) - 1


def add(a: int, b: int) -> int:
    s = a + b
    return s - P if s >= P else s


def sub(a: int, b: int) -> int:
    d = a - b
    return d + P if d < 0 else d


def neg(a: int) -> int:
    return 0 if a == 0 else P - a


def mul(a: int, b: int) -> int:
    return (a * b) % P


def pow_(a: int, e: int) -> int:
    return pow(a, e, P)


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("inverse of zero in Goldilocks field")
    return pow(a, P - 2, P)


def exp_power_of_2(a: int, k: int) -> int:
    for _ in range(k):
        a = (a * a) % P
    return a


def two_adic_generator(log_n: int) -> int:
    """Primitive ``2^log_n``-th root of unity.

    Computed as ``g^((p-1) / 2^log_n)`` from the full-group generator, the
    same derivation p3-goldilocks uses for ``two_adic_generator``
    (single call site in the reference: crates/lifted-stark/src/domain.rs:241).
    """
    assert 0 <= log_n <= TWO_ADICITY
    return pow(GENERATOR, (P - 1) >> log_n, P)


def canonical_lde_shift(log_lde_order: int) -> int:
    """Canonical LDE coset shift ``g^(2^(TWO_ADICITY - log_lde_order))``.

    Mirrors ``LiftedDomain::canonical_lde_shift``
    (crates/lifted-stark/src/domain.rs:358-361): the shift depends only on the
    LDE order, making per-batch sub-domain shifts batch-independent.
    """
    assert log_lde_order <= TWO_ADICITY
    return exp_power_of_2(GENERATOR, TWO_ADICITY - log_lde_order)


# ---------------------------------------------------------------------------
# Quadratic extension QuadFelt = F[x] / (x^2 - W_EXT)
# ---------------------------------------------------------------------------


def ext_add(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int]:
    return add(a[0], b[0]), add(a[1], b[1])


def ext_sub(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int]:
    return sub(a[0], b[0]), sub(a[1], b[1])


def ext_neg(a: tuple[int, int]) -> tuple[int, int]:
    return neg(a[0]), neg(a[1])


def ext_mul(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int]:
    a0, a1 = a
    b0, b1 = b
    c0 = (a0 * b0 + W_EXT * a1 * b1) % P
    c1 = (a0 * b1 + a1 * b0) % P
    return c0, c1


def ext_mul_base(a: tuple[int, int], s: int) -> tuple[int, int]:
    return mul(a[0], s), mul(a[1], s)


def ext_inv(a: tuple[int, int]) -> tuple[int, int]:
    a0, a1 = a
    # (a0 + a1 x)^-1 = (a0 - a1 x) / (a0^2 - W a1^2)
    d = (a0 * a0 - W_EXT * a1 * a1) % P
    di = inv(d)
    return mul(a0, di), mul(neg(a1), di)


def ext_pow(a: tuple[int, int], e: int) -> tuple[int, int]:
    result = (1, 0)
    base = a
    while e:
        if e & 1:
            result = ext_mul(result, base)
        base = ext_mul(base, base)
        e >>= 1
    return result


def ext_exp_power_of_2(a: tuple[int, int], k: int) -> tuple[int, int]:
    for _ in range(k):
        a = ext_mul(a, a)
    return a
