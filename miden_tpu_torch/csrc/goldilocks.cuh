// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) for the port's kernels.
//
// Elements are canonical u64 values (< p), stored in the caller's int64
// tensors bit for bit. Every function but the *_wrap ones returns a
// canonical value, so the results equal the plain torch ops of
// miden_tpu_torch/field/goldilocks.py bit for bit.
//
// How the H100 is used: the SM has no 64-bit integer ALU, so every 64-bit op
// is a chain of 32-bit IMAD/IADD3 instructions. The 64x64 -> 128-bit product
// is one carry chain of four 32x32 partial products, so the cross terms
// are computed once; the reduction uses 2^64 = 2^32 - 1 and
// 2^96 = -1 (mod p) with a shift-and-subtract in place of the multiply by
// 2^32 - 1; adds and subtracts take their carry or borrow from the carry
// flag (add.cc / sub.cc) instead of a compare. Multiplies by the small
// constants of Poseidon2's internal diagonal (+-2^k, +-3, +-2^-k) are shifts
// and adds, and sums of up to 12 values reduce once (LazySum).
#pragma once
#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;           // 2^64 mod p
constexpr uint64_t HALF = 0x7FFFFFFF80000001ull;  // (p + 1) / 2 = 1/2 mod p

// a - b, plus p when it borrows (that is, minus EPS mod 2^64). Equals
// a - b (mod p) for any a, and is canonical when a and b are.
__device__ __forceinline__ uint64_t sub_wrap(uint64_t a, uint64_t b) {
  uint64_t d;
  uint32_t borrow;  // 0, or 0xFFFFFFFF = EPS when a < b
  asm("sub.cc.u64 %0, %2, %3;\n\t"
      "subc.u32 %1, 0, 0;"
      : "=l"(d), "=r"(borrow)
      : "l"(a), "l"(b));
  return d - (uint64_t)borrow;
}

// a + b, plus EPS when it carries. Equals a + b (mod p) and cannot carry a
// second time when b < p. Not canonical: the result may be >= p.
__device__ __forceinline__ uint64_t add_wrap(uint64_t a, uint64_t b) {
  uint64_t s;
  uint32_t carry;
  asm("add.cc.u64 %0, %2, %3;\n\t"
      "addc.u32 %1, 0, 0;"
      : "=l"(s), "=r"(carry)
      : "l"(a), "l"(b));
  return s + (uint64_t)(0u - carry);  // 0u - 1 = EPS
}

__device__ __forceinline__ uint64_t canon(uint64_t x) { return x >= P ? x - P : x; }

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) { return sub_wrap(a, b); }

// a + b = a - (p - b): one subtract with its borrow, and p - b is in [1, p].
__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) { return sub_wrap(a, P - b); }

__device__ __forceinline__ uint64_t neg(uint64_t x) { return sub_wrap(0, x); }

__device__ __forceinline__ uint64_t dbl(uint64_t x) { return add(x, x); }

__device__ __forceinline__ uint64_t mul3(uint64_t x) { return add(dbl(x), x); }

// x * 2^k for 1 <= k <= 31: the 128-bit shift (hi < 2^k), then hi * 2^64 =
// hi * EPS, written as (hi << 32) - hi.
__device__ __forceinline__ uint64_t mul_pow2(uint64_t x, int k) {
  const uint64_t hi = x >> (64 - k);
  return canon(add_wrap(x << k, (hi << 32) - hi));
}

// x / 2: x even ? x >> 1 : (x + p) / 2 = (x >> 1) + (p + 1) / 2.
__device__ __forceinline__ uint64_t halve(uint64_t x) {
  return (x >> 1) + ((x & 1) ? HALF : 0);
}

// x * 2^-k for 1 <= k <= 3, by k halvings: no general multiply.
__device__ __forceinline__ uint64_t mul_inv_pow2(uint64_t x, int k) {
  for (int i = 0; i < k; ++i) x = halve(x);
  return x;
}

// Sum of up to 2^32 - 1 canonical values, reduced once: a 64-bit low word
// and the count of its carries out, lo + carries * 2^64 = lo + carries * EPS.
struct LazySum {
  uint64_t lo = 0;
  uint32_t carries = 0;

  __device__ __forceinline__ LazySum& operator+=(uint64_t v) {
    asm("add.cc.u64 %0, %0, %2;\n\t"
        "addc.u32 %1, %1, 0;"
        : "+l"(lo), "+r"(carries)
        : "l"(v));
    return *this;
  }

  __device__ __forceinline__ uint64_t value() const {
    const uint64_t c = carries;
    return canon(add_wrap(lo, (c << 32) - c));
  }
};

// The 128-bit product of a and b as (lo, hi): the four 32x32 partial
// products a0b0, a0b1, a1b0, a1b1 in one carry chain (8 IMAD).
__device__ __forceinline__ void mul_wide(uint64_t a, uint64_t b, uint64_t& lo, uint64_t& hi) {
  const uint32_t a0 = (uint32_t)a, a1 = (uint32_t)(a >> 32);
  const uint32_t b0 = (uint32_t)b, b1 = (uint32_t)(b >> 32);
  uint32_t r0, r1, r2, r3;
  asm("mul.lo.u32     %0, %4, %6;\n\t"
      "mul.hi.u32     %1, %4, %6;\n\t"
      "mad.lo.cc.u32  %1, %4, %7, %1;\n\t"
      "madc.hi.u32    %2, %4, %7, 0;\n\t"
      "mad.lo.cc.u32  %1, %5, %6, %1;\n\t"
      "madc.hi.cc.u32 %2, %5, %6, %2;\n\t"
      "addc.u32       %3, 0, 0;\n\t"
      "mad.lo.cc.u32  %2, %5, %7, %2;\n\t"
      "madc.hi.u32    %3, %5, %7, %3;"
      : "=&r"(r0), "=&r"(r1), "=&r"(r2), "=&r"(r3)
      : "r"(a0), "r"(a1), "r"(b0), "r"(b1));
  lo = ((uint64_t)r1 << 32) | r0;
  hi = ((uint64_t)r3 << 32) | r2;
}

// lo + hi * 2^64 mod p, with hi = hi_hi * 2^32 + hi_lo:
// lo - hi_hi + hi_lo * (2^32 - 1).
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  const uint64_t hi_hi = hi >> 32;
  const uint64_t hi_lo = hi & EPS;
  const uint64_t t = sub_wrap(lo, hi_hi);
  return canon(add_wrap(t, (hi_lo << 32) - hi_lo));
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  uint64_t lo, hi;
  mul_wide(a, b, lo, hi);
  return reduce128(lo, hi);
}

// a * b (mod p) for any 64-bit a, b, as a value below 2^64 that may not be
// canonical: reduce128 without its last conditional subtract. For products
// that only feed further products (the S-box's x^2, x^4, x^3).
__device__ __forceinline__ uint64_t mul_wrap(uint64_t a, uint64_t b) {
  uint64_t lo, hi;
  mul_wide(a, b, lo, hi);
  const uint64_t hi_lo = hi & EPS;
  return add_wrap(sub_wrap(lo, hi >> 32), (hi_lo << 32) - hi_lo);
}

// ---------------------------------------------------------------------------
// Squares, and a reduction that leans on the multiplier (the Rescue kernels
// of rescue.cu). Nothing above this line uses them.
// ---------------------------------------------------------------------------

// The 128-bit square of a as (lo, hi) from three 32x32 -> 64 partial
// products with no addend, a0^2, a0*a1 and a1^2 (IMAD.WIDE.U32 ..., RZ: no
// register pairs to assemble for an addend), the cross term added twice
// through the carry chain on the integer ALU.
__device__ __forceinline__ void sqr_wide(uint64_t a, uint64_t& lo, uint64_t& hi) {
  const uint32_t a0 = (uint32_t)a, a1 = (uint32_t)(a >> 32);
  uint32_t r0, r1, r2, r3;
  asm("{\n\t"
      ".reg .u64 x, c, y;\n\t"
      ".reg .u32 c0, c1, y0, y1;\n\t"
      "mul.wide.u32   x, %4, %4;\n\t"
      "mul.wide.u32   c, %4, %5;\n\t"
      "mul.wide.u32   y, %5, %5;\n\t"
      "mov.b64        {%0, %1}, x;\n\t"
      "mov.b64        {c0, c1}, c;\n\t"
      "mov.b64        {y0, y1}, y;\n\t"
      "add.cc.u32     %1, %1, c0;\n\t"
      "addc.cc.u32    %2, y0, c1;\n\t"
      "addc.u32       %3, y1, 0;\n\t"
      "add.cc.u32     %1, %1, c0;\n\t"
      "addc.cc.u32    %2, %2, c1;\n\t"
      "addc.u32       %3, %3, 0;\n\t"
      "}"
      : "=&r"(r0), "=&r"(r1), "=&r"(r2), "=&r"(r3)
      : "r"(a0), "r"(a1));
  lo = ((uint64_t)r1 << 32) | r0;
  hi = ((uint64_t)r3 << 32) | r2;
}

// lo + hi * 2^64 (mod p) as a value below 2^64 that may not be canonical,
// with hi = h1 * 2^32 + h0, 2^64 = EPS and 2^96 = -1 (mod p): t = lo - h1
// (borrow b), u = t + h0 * EPS (a 32x32 multiply-add on the multiplier,
// carry c), and one signed correction (c - b) * EPS in place of reduce128's
// two. A borrow means t is 2^64 = EPS too large, a carry that u is EPS too
// small; u + (c - b) * EPS cannot wrap: with c = 1, b = 0, u < h0 * EPS <=
// 2^64 - 2^33 + 1; with c = 0, b = 1, u >= t >= 2^64 - 2^32 + 1 > EPS.
__device__ __forceinline__ uint64_t fold128(uint64_t lo, uint64_t hi) {
  const uint32_t l0 = (uint32_t)lo, l1 = (uint32_t)(lo >> 32);
  const uint32_t h0 = (uint32_t)hi, h1 = (uint32_t)(hi >> 32);
  uint32_t r0, r1;
  asm("{\n\t"
      ".reg .u32 t0, t1, bm, u0, u1, d, dh, nd;\n\t"
      "sub.cc.u32     t0, %2, %5;\n\t"          // t = lo - h1
      "subc.cc.u32    t1, %3, 0;\n\t"
      "subc.u32       bm, 0, 0;\n\t"            // -b
      "mad.lo.cc.u32  u0, %4, 0xFFFFFFFF, t0;\n\t"  // u = t + h0 * EPS
      "madc.hi.cc.u32 u1, %4, 0xFFFFFFFF, t1;\n\t"
      "addc.u32       d, bm, 0;\n\t"            // d = c - b in {-1, 0, 1}
      "shr.s32        dh, d, 31;\n\t"           // d * EPS = (-d) + (d < 0 ? -2^32 : 0)
      "neg.s32        nd, d;\n\t"
      "add.cc.u32     %0, u0, nd;\n\t"
      "addc.u32       %1, u1, dh;\n\t"
      "}"
      : "=r"(r0), "=r"(r1)
      : "r"(l0), "r"(l1), "r"(h0), "r"(h1));
  return ((uint64_t)r1 << 32) | r0;
}

// A sum of 128-bit values, lo + hi * 2^64 + top * 2^128, with subtraction:
// a caller that subtracts starts from an offset that is 0 mod p and larger
// than everything it will subtract (Wide3::offset), so the sum never goes
// below 0. value() reduces once, with 2^128 = -2^32 (mod p); top < 2^31.
struct Wide3 {
  uint64_t lo = 0, hi = 0;
  uint32_t top = 0;

  // p * 2^66 = 3 * 2^128 + (2^64 - 2^34 + 4) * 2^64: above 3 * 2^128, so
  // three products of 64-bit values may be subtracted from it.
  static __device__ __forceinline__ Wide3 offset() {
    Wide3 w;
    w.hi = 0xFFFFFFFC00000004ull;
    w.top = 3;
    return w;
  }

  __device__ __forceinline__ void add(uint64_t l, uint64_t h) {
    asm("add.cc.u64 %0, %0, %3;\n\t"
        "addc.cc.u64 %1, %1, %4;\n\t"
        "addc.u32 %2, %2, 0;"
        : "+l"(lo), "+l"(hi), "+r"(top)
        : "l"(l), "l"(h));
  }

  __device__ __forceinline__ void sub(uint64_t l, uint64_t h) {
    asm("sub.cc.u64 %0, %0, %3;\n\t"
        "subc.cc.u64 %1, %1, %4;\n\t"
        "subc.u32 %2, %2, 0;"
        : "+l"(lo), "+l"(hi), "+r"(top)
        : "l"(l), "l"(h));
  }

  // canonical; top * 2^32 < p for top < 2^31
  __device__ __forceinline__ uint64_t value() const {
    return canon(sub_wrap(fold128(lo, hi), (uint64_t)top << 32));
  }
};

}  // namespace gl
