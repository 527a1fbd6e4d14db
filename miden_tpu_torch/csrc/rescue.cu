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
// What bounds them on the H100: the integer multiplier. x^(1/7) =
// x^10540996611094048183 is the reference's 72-product addition chain
// (rescue/mod.rs apply_inv_sbox), so an RPO permutation takes 7 x 12 x
// (72 + 4) = 6384 general Goldilocks products and an RPX permutation
// 3 x 12 x 76 + 3 x 4 x 36 = 3168, each a 64x64 -> 128-bit product of 8
// 32-bit IMADs, against at most 192 bytes of device traffic. The design is
// the simple one: one thread per state, the 12 lanes in registers, round
// constants in __constant__ memory. The circulant MDS has entries <= 26, so
// it is 32x32 -> 64-bit multiply-adds by immediates on the two halves of
// each lane (each sum stays below 2^41) and one reduction per output lane.
// x^(1/7) and the cubic-extension x^7 are __noinline__ functions on one lane
// or one chunk, so the round body holds one copy of each chain, not twelve
// (an inlined RPO round would be about 300 KB of SASS); products that only
// feed further products skip their canonical subtract (gl::mul_wrap).
#include <cuda_runtime.h>
#include <cstdint>

#include "goldilocks.cuh"
#include "rescue_constants.h"  // generated from hash/rescue_constants.py at build
#include "sponge_rows.cuh"

namespace {

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

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = gl::mul_wrap(x, x);
  const uint64_t x4 = gl::mul_wrap(x2, x2);
  const uint64_t x3 = gl::mul_wrap(x2, x);
  return gl::mul(x4, x3);
}

// base^(2^M) * tail
template <int M>
__device__ __forceinline__ uint64_t exp_acc(uint64_t base, uint64_t tail) {
#pragma unroll
  for (int k = 0; k < M; ++k) base = gl::mul_wrap(base, base);
  return gl::mul_wrap(base, tail);
}

// x^(1/7) = x^10540996611094048183, the exponent
// 0b1001001001001001001001001001000110110110110110110110110110110111, in
// 72 products.
__device__ __noinline__ uint64_t inv_sbox(uint64_t x) {
  const uint64_t t1 = gl::mul_wrap(x, x);    // x^0b10
  const uint64_t t2 = gl::mul_wrap(t1, t1);  // x^0b100
  const uint64_t t3 = exp_acc<3>(t2, t2);    // x^0b100100
  const uint64_t t4 = exp_acc<6>(t3, t3);    // x^0b100100100100
  const uint64_t t5 = exp_acc<12>(t4, t4);   // x^0b100100100100100100100100
  const uint64_t t6 = exp_acc<6>(t5, t3);    // x^0b100100100100100100100100100100
  const uint64_t t7 = exp_acc<31>(t6, t6);   // t6^(2^31 + 1)
  uint64_t a = gl::mul_wrap(gl::mul_wrap(t7, t7), t6);
  a = gl::mul_wrap(a, a);
  a = gl::mul_wrap(a, a);
  const uint64_t b = gl::mul_wrap(gl::mul_wrap(t1, t2), x);
  return gl::mul(a, b);
}

__device__ __forceinline__ void fb_round(uint64_t (&s)[12], int r) {
  mds(s);
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = sbox(gl::add(s[i], c_ark1[r][i]));
  mds(s);
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = inv_sbox(gl::add(s[i], c_ark2[r][i]));
}

struct C3 {
  uint64_t c0, c1, c2;
};

// (a0 + a1 phi + a2 phi^2)(b0 + b1 phi + b2 phi^2) mod phi^3 - phi - 1, with
// phi^3 = phi + 1 and phi^4 = phi^2 + phi.
__device__ __forceinline__ C3 c3_mul(const C3& a, const C3& b) {
  const uint64_t p00 = gl::mul(a.c0, b.c0), p01 = gl::mul(a.c0, b.c1), p02 = gl::mul(a.c0, b.c2);
  const uint64_t p10 = gl::mul(a.c1, b.c0), p11 = gl::mul(a.c1, b.c1), p12 = gl::mul(a.c1, b.c2);
  const uint64_t p20 = gl::mul(a.c2, b.c0), p21 = gl::mul(a.c2, b.c1), p22 = gl::mul(a.c2, b.c2);
  gl::LazySum s0, s1, s2;
  s0 += p00; s0 += p12; s0 += p21;
  s1 += p01; s1 += p10; s1 += p12; s1 += p21; s1 += p22;
  s2 += p02; s2 += p11; s2 += p20; s2 += p22;
  return C3{s0.value(), s1.value(), s2.value()};
}

__device__ __noinline__ C3 c3_pow7(C3 a) {
  const C3 a2 = c3_mul(a, a);
  const C3 a3 = c3_mul(a2, a);
  const C3 a6 = c3_mul(a3, a3);
  return c3_mul(a6, a);
}

__device__ __forceinline__ void ext_round(uint64_t (&s)[12], int r) {
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = gl::add(s[i], c_ark1[r][i]);
#pragma unroll
  for (int c = 0; c < 12; c += 3) {
    const C3 out = c3_pow7(C3{s[c], s[c + 1], s[c + 2]});
    s[c] = out.c0;
    s[c + 1] = out.c1;
    s[c + 2] = out.c2;
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
