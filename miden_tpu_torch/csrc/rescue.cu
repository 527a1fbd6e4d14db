// Width-12 Goldilocks RPO-256 (R1) and RPX-256 (R2) for Hopper (sm_90a):
// the permutations of the two other algebraic LMCS configurations of
// PcsParams.hash_name. They are not ports of a TPU kernel: miden_tpu
// computes them in XLA (miden_tpu/hash/rescue.py rpo_permute, rpx_permute).
// Each has the three entries of sponge_rows.cuh over its permutation:
// `<name>_permute` on (12, n) states, `<name>_absorb_rows` (the LMCS leaf
// sponge over one row-major matrix, cyclic lifting, zero-padded tail block)
// and `<name>_compress_rows` (one Merkle layer, (2m, 4) -> (m, 4)).
//
// - RPO: 7 rounds of MDS, + ARK1[r], x^7, MDS, + ARK2[r], x^(1/7).
// - RPX: (FB)(E)(FB)(E)(FB)(E)(M): FB is the RPO round; E is + ARK1[r] then
//   x^7 in F_p[phi]/(phi^3 - phi - 1) on four 3-lane chunks; M is MDS then
//   + ARK1[6].
//
// What bounds them on the H100: integer instruction throughput, the
// multiplier's pipe first. x^(1/7) is the reference's chain of 63 squares
// and 9 products, so a lane-round is 65 squares and 11 products, against
// at most 192 bytes of device traffic a permutation. Every IMAD form issues
// to one 16-lane pipe of a scheduler (IMAD.WIDE / IMAD.HI take about 4
// cycles a warp, IMAD, IMAD.X, IMAD.MOV, IMAD.IADD about 2), the carries
// and selects (IADD3, SEL, LEA, SHF) to the integer ALU, 2 cycles a warp.
// Per RPO permutation (SASS per operation from probe kernels times the
// operations; PERF.md section 6 holds the table for RPO and RPX) the
// general-product arithmetic (gl::mul_wrap for every square and product, as
// in Poseidon2) issued 135184 instructions, 35770 IMAD.WIDE / HI and 25655
// other IMADs (194.4k multiplier-pipe cycles a warp), against the bound's
// 40152 32-bit multiplies (80.3k cycles); the kernels ran at ~77 % of that
// pipe, and groups of 12, 6 or 4 lanes in lockstep timed within ~1 % of each
// other, so latency is not what binds.
//
// The design, for fewer multiplier-pipe cycles a square:
// - gl::sqr_wide: three 32x32 -> 64 products with no addend (no register
//   pairs to assemble), the doubled cross term on the ALU's carry chain;
// - gl::fold128: the reduction's two fix-ups (borrow of lo - h1, carry of
//   + h0 * EPS) merged into one signed correction (c - b) * EPS;
// - x^(1/7) on kGroup lanes in lockstep: a table of seven steps
//   (kInvSteps), each m squarings by one run-time loop and a product, so
//   the whole chain is one squaring body and one product body (no calls,
//   no 300 KB unrolled round); the state rotates by the group after each;
// - RPX's E round: Karatsuba products (6 base products) and a dedicated
//   cubic square, each output coefficient summed in 128 bits (gl::Wide3)
//   and reduced once; one chunk's code, run four times.
// That is 128968 instructions an RPO permutation, 30331 IMAD.WIDE / HI and
// 20878 other IMADs (163.1k cycles, -16 %). The circulant MDS (entries
// <= 26: multiply-adds by immediates on the 32-bit halves, sums below 2^41,
// one reduction per output) is ~9 % of a permutation's instructions and is
// kept; the round constants stay in __constant__ memory.
#include <cuda_runtime.h>
#include <cstdint>

#include "goldilocks.cuh"
#include "rescue_constants.h"  // generated from hash/rescue_constants.py at build
#include "sponge_rows.cuh"

namespace {

// Lanes of the lockstep x^(1/7) chain: of 12, 6 and 4, 6 measured fastest
// and spills in no entry (12 spills in two RPO entries; PERF.md section 6).
constexpr int kGroup = 6;

__constant__ uint64_t c_ark1[7][12] = RESCUE_ARK1;
__constant__ uint64_t c_ark2[7][12] = RESCUE_ARK2;

// Row 0 of the circulant MDS; a constant expression in an unrolled loop,
// so each product is by an immediate.
__host__ __device__ constexpr uint32_t mds_entry(int k) {
  constexpr uint64_t row[12] = RESCUE_MDS_ROW0;
  return (uint32_t)row[k];
}

constexpr bool mds_entries_small() {
  for (int k = 0; k < 12; ++k)
    if (mds_entry(k) > 26) return false;
  return true;
}

static_assert(mds_entries_small(), "mds's sums of 32-bit halves assume entries <= 26 (below 2^41)");

// out[i] = sum_k mds_entry(k) * s[(i + k) % 12]: a = the sum over the low 32-bit
// halves, b over the high ones, so out = a + b * 2^32 with
// b * 2^32 = (b mod 2^32) * 2^32 + (b >> 32) * 2^64 and 2^64 = EPS (mod p).
__device__ __forceinline__ void mds(uint64_t (&s)[12]) {
  uint64_t y[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    uint64_t a = 0, b = 0;
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const uint64_t x = s[(i + k) % 12];
      a += (uint64_t)(uint32_t)x * mds_entry(k);  // IMAD.WIDE.U32 by an immediate
      b += (uint64_t)(uint32_t)(x >> 32) * mds_entry(k);
    }
    const uint64_t bh = b >> 32;
    y[i] = gl::canon(gl::add_wrap(gl::add_wrap(b << 32, a), (bh << 32) - bh));
  }
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = y[i];
}

// The S-boxes' arithmetic: values below 2^64, not canonical.
__device__ __forceinline__ uint64_t sq(uint64_t x) {
  uint64_t lo, hi;
  gl::sqr_wide(x, lo, hi);
  return gl::fold128(lo, hi);
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  uint64_t lo, hi;
  gl::mul_wide(a, b, lo, hi);
  return gl::fold128(lo, hi);
}

// x^7 on all 12 lanes: x^2, x^4 (squares), x^3, x^7 (products); the lanes'
// chains are independent, so the unrolled loop gives the scheduler 12-way
// ILP.
__device__ __forceinline__ void sbox(uint64_t (&s)[12]) {
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const uint64_t x2 = sq(s[i]);
    const uint64_t x4 = sq(x2);
    s[i] = gl::canon(mul(x4, mul(x2, s[i])));
  }
}

// x^(1/7) = x^10540996611094048183, the exponent
// 0b1001001001001001001001001001000110110110110110110110110110110111, by
// the reference's chain (rescue/mod.rs apply_inv_sbox): from t2 = x^4 and
// b = x^7, seven steps v <- v^(2^m) * tail:
//   t3 = t2^(2^3) t2, t4 = t3^(2^6) t3, t5 = t4^(2^12) t4, t6 = t5^(2^6) t3,
//   t7 = t6^(2^31) t6, a = t7^2 t6, x^(1/7) = a^4 b,
// 63 squares and 9 products in all. Each step's tail is the value before
// its squarings (SELF), the value saved after step 1 (t3) or 4 (t6) (KEEP),
// or b. A step is one byte of kInvSteps: m | tail << 5 | save << 7.
enum : uint32_t { SELF = 0, KEEP = 1, BVAL = 2 };

__host__ __device__ constexpr uint64_t inv_step(int k, uint32_t m, uint32_t tail, uint32_t save) {
  return (uint64_t)(m | tail << 5 | save << 7) << (8 * k);
}

constexpr uint64_t kInvSteps = inv_step(0, 3, SELF, 1) | inv_step(1, 6, SELF, 0) |
                               inv_step(2, 12, SELF, 0) | inv_step(3, 6, KEEP, 1) |
                               inv_step(4, 31, SELF, 0) | inv_step(5, 1, KEEP, 0) |
                               inv_step(6, 2, BVAL, 0);

// x^(1/7) on lanes 0..G of s, the G chains in lockstep: every squaring and
// product of a step is one unrolled loop over the lanes (G-way ILP), and
// the squarings' count is a run-time loop bound, so the chain is one
// squaring body and one product body whatever the step.
__device__ __forceinline__ void inv_sbox_group(uint64_t (&s)[12]) {
  constexpr int G = kGroup;
  uint64_t b[G], keep[G], tail[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const uint64_t x2 = sq(s[i]);
    const uint64_t x4 = sq(x2);
    b[i] = mul(x4, mul(x2, s[i]));
    s[i] = keep[i] = x4;
  }
#pragma unroll 1
  for (int k = 0; k < 7; ++k) {
    const uint32_t code = (uint32_t)(kInvSteps >> (8 * k));
    const uint32_t m = code & 31, src = (code >> 5) & 3;
#pragma unroll
    for (int i = 0; i < G; ++i) tail[i] = src == SELF ? s[i] : src == KEEP ? keep[i] : b[i];
#pragma unroll 1
    for (uint32_t j = 0; j < m; ++j) {
#pragma unroll
      for (int i = 0; i < G; ++i) s[i] = sq(s[i]);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) s[i] = mul(s[i], tail[i]);
    if (code & 128) {
#pragma unroll
      for (int i = 0; i < G; ++i) keep[i] = s[i];
    }
  }
#pragma unroll
  for (int i = 0; i < G; ++i) s[i] = gl::canon(s[i]);
}

// x^(1/7) on all 12 lanes, kGroup at a time: one group's code, run 12 / G
// times with the state rotated by G lanes after each.
__device__ __forceinline__ void inv_sbox(uint64_t (&s)[12]) {
  constexpr int G = kGroup;
#pragma unroll 1
  for (int g = 0; g < 12 / G; ++g) {
    inv_sbox_group(s);
    uint64_t t[G];
#pragma unroll
    for (int i = 0; i < G; ++i) t[i] = s[i];
#pragma unroll
    for (int i = 0; i < 12 - G; ++i) s[i] = s[i + G];
#pragma unroll
    for (int i = 0; i < G; ++i) s[12 - G + i] = t[i];
  }
}

__device__ __forceinline__ void fb_round(uint64_t (&s)[12], int r) {
  mds(s);
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = gl::add(s[i], c_ark1[r][i]);
  sbox(s);
  mds(s);
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = gl::add(s[i], c_ark2[r][i]);
  inv_sbox(s);
}

// F_p[phi]/(phi^3 - phi - 1), phi^3 = phi + 1 and phi^4 = phi^2 + phi, on
// canonical coefficients. Each output coefficient is a sum of 128-bit
// partial products (gl::Wide3), reduced once.
//
// Square: (a0 + a1 phi + a2 phi^2)^2 = a0^2 + 2 a1 a2
//   + (2 a0 a1 + 2 a1 a2 + a2^2) phi + (a1^2 + 2 a0 a2 + a2^2) phi^2:
// three base squares and three products.
__device__ __forceinline__ void c3_sqr(const uint64_t (&a)[3], uint64_t (&out)[3]) {
  uint64_t s0l, s0h, s1l, s1h, s2l, s2h, p01l, p01h, p02l, p02h, p12l, p12h;
  gl::sqr_wide(a[0], s0l, s0h);
  gl::sqr_wide(a[1], s1l, s1h);
  gl::sqr_wide(a[2], s2l, s2h);
  gl::mul_wide(a[0], a[1], p01l, p01h);
  gl::mul_wide(a[0], a[2], p02l, p02h);
  gl::mul_wide(a[1], a[2], p12l, p12h);
  gl::Wide3 r0, r1, r2;
  r0.add(s0l, s0h);
  r0.add(p12l, p12h);
  r0.add(p12l, p12h);
  r1.add(p01l, p01h);
  r1.add(p01l, p01h);
  r1.add(p12l, p12h);
  r1.add(p12l, p12h);
  r1.add(s2l, s2h);
  r2.add(s1l, s1h);
  r2.add(p02l, p02h);
  r2.add(p02l, p02h);
  r2.add(s2l, s2h);
  out[0] = r0.value();
  out[1] = r1.value();
  out[2] = r2.value();
}

// Product by b, Karatsuba: with p_ii = a_i b_i and m_ij = (a_i + a_j)(b_i + b_j)
// (the operand sums reduced mod p first, so each is a 64x64 product; b's
// sums bs01, bs02, bs12 are the caller's),
//   r0 = p00 + m12 - p11 - p22, r1 = m01 + m12 - p00 - 2 p11,
//   r2 = m02 - p00 + p11:
// six base products, each output from gl::Wide3::offset().
__device__ __forceinline__ void c3_mul(const uint64_t (&a)[3], const uint64_t (&b)[3],
                                       const uint64_t (&bs)[3], uint64_t (&out)[3]) {
  uint64_t p00l, p00h, p11l, p11h, p22l, p22h, m01l, m01h, m02l, m02h, m12l, m12h;
  gl::mul_wide(a[0], b[0], p00l, p00h);
  gl::mul_wide(a[1], b[1], p11l, p11h);
  gl::mul_wide(a[2], b[2], p22l, p22h);
  gl::mul_wide(gl::add(a[0], a[1]), bs[0], m01l, m01h);
  gl::mul_wide(gl::add(a[0], a[2]), bs[1], m02l, m02h);
  gl::mul_wide(gl::add(a[1], a[2]), bs[2], m12l, m12h);
  gl::Wide3 r0 = gl::Wide3::offset(), r1 = gl::Wide3::offset(), r2 = gl::Wide3::offset();
  r0.add(p00l, p00h);
  r0.add(m12l, m12h);
  r0.sub(p11l, p11h);
  r0.sub(p22l, p22h);
  r1.add(m01l, m01h);
  r1.add(m12l, m12h);
  r1.sub(p00l, p00h);
  r1.sub(p11l, p11h);
  r1.sub(p11l, p11h);
  r2.add(m02l, m02h);
  r2.sub(p00l, p00h);
  r2.add(p11l, p11h);
  out[0] = r0.value();
  out[1] = r1.value();
  out[2] = r2.value();
}

// x^7 = (x^3)^2 x with x^3 = x^2 x, on the chunk in lanes 0..3.
__device__ __forceinline__ void c3_pow7(uint64_t (&s)[12]) {
  const uint64_t a[3] = {s[0], s[1], s[2]};
  const uint64_t as[3] = {gl::add(a[0], a[1]), gl::add(a[0], a[2]), gl::add(a[1], a[2])};
  uint64_t t[3], u[3];
  c3_sqr(a, t);
  c3_mul(t, a, as, u);  // x^3
  c3_sqr(u, t);         // x^6
  uint64_t out[3];
  c3_mul(t, a, as, out);
  s[0] = out[0];
  s[1] = out[1];
  s[2] = out[2];
}

// + ARK1[r], then x^7 on the four 3-lane chunks: one chunk's code, run four
// times with the state rotated by 3 lanes after each.
__device__ __forceinline__ void ext_round(uint64_t (&s)[12], int r) {
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = gl::add(s[i], c_ark1[r][i]);
#pragma unroll 1
  for (int c = 0; c < 4; ++c) {
    c3_pow7(s);
    const uint64_t t0 = s[0], t1 = s[1], t2 = s[2];
#pragma unroll
    for (int i = 0; i < 9; ++i) s[i] = s[i + 3];
    s[9] = t0;
    s[10] = t1;
    s[11] = t2;
  }
}

struct Rpo {
  static __device__ __forceinline__ void apply(uint64_t (&s)[12]) {
#pragma unroll 1
    for (int r = 0; r < 7; ++r) fb_round(s, r);
  }
};

struct Rpx {
  static __device__ __forceinline__ void apply(uint64_t (&s)[12]) {
#pragma unroll 1
    for (int r = 0; r < 6; r += 2) {
      fb_round(s, r);
      ext_round(s, r + 1);
    }
    mds(s);
#pragma unroll
    for (int i = 0; i < 12; ++i) s[i] = gl::add(s[i], c_ark1[6][i]);
  }
};

}  // namespace

extern "C" {

int rpo_permute(const void* x, void* out, long long n, void* stream) {
  return sponge::launch_permute<Rpo>(x, out, n, stream);
}

int rpo_absorb_rows(const void* state_in, void* state_out, const void* m, long long h, int w,
                    long long max_h, void* stream) {
  return sponge::launch_absorb_rows<Rpo>(state_in, state_out, m, h, w, max_h, stream);
}

int rpo_compress_rows(const void* cur, void* out, long long m, void* stream) {
  return sponge::launch_compress_rows<Rpo>(cur, out, m, stream);
}

int rpx_permute(const void* x, void* out, long long n, void* stream) {
  return sponge::launch_permute<Rpx>(x, out, n, stream);
}

int rpx_absorb_rows(const void* state_in, void* state_out, const void* m, long long h, int w,
                    long long max_h, void* stream) {
  return sponge::launch_absorb_rows<Rpx>(state_in, state_out, m, h, w, max_h, stream);
}

int rpx_compress_rows(const void* cur, void* out, long long m, void* stream) {
  return sponge::launch_compress_rows<Rpx>(cur, out, m, stream);
}

}  // extern "C"
