// Width-12 Goldilocks Poseidon2 for Hopper (sm_90a): K3 of the port, with
// three entry points over one permutation.
//
// Replaces miden_tpu/hash/poseidon2_pallas.py `permute_pallas` (kernel body
// `_permute_kernel`): the batched permutation on (12, n) states, in the
// order external MDS; 4 external rounds (round constant, x^7 S-box on all 12
// lanes, external MDS); 22 internal rounds (S-box on lane 0, then
// sum + MAT_DIAG * x); 4 terminal external rounds.
//
// The three entries are the kernels of sponge_rows.cuh over this
// permutation:
// - `poseidon2_permute`: (12, n) states in, (12, n) out (the duplex and the
//   PoW grind).
// - `poseidon2_absorb_rows`: the LMCS leaf sponge over one row-major matrix
//   (h, w), one launch per matrix, in place of one permutation launch per
//   8-column block and the torch copies (transpose, pad, repeat,
//   concatenate) around each.
// - `poseidon2_compress_rows`: one Merkle layer over row-major digests,
//   (2m, 4) -> (m, 4).
//
// What bounds it on the H100: the integer multiplier. A permutation needs
// 472 general Goldilocks multiplies (8 external rounds x 12 S-boxes x 4,
// plus 22 internal rounds x 4 for the lane-0 S-box), each a 64x64 -> 128-bit
// product of 8 32-bit IMADs, against at most 2 x 12 x 8 = 192 bytes of
// device traffic, so bytes are never the limit. The design: one thread per
// state keeps the 12 lanes in registers through all 30 rounds. The internal
// diagonal MAT_DIAG = {-2, 1, 2, 1/2, 3, 4, -1/2, -3, -4, 1/4, -1/4, 1/8} is
// applied by shifts, adds and halvings (no general multiply; the
// static_assert below pins each form to the generated constants), the
// 12-lane sum and the M_E sums reduce once (gl::LazySum), and the S-box's
// inner products skip their canonical subtract. Round constants sit in
// __constant__ memory, where a warp reads one word at once.
#include <cuda_runtime.h>
#include <cstdint>

#include "goldilocks.cuh"
#include "poseidon2_constants.h"  // generated from hash/constants.py at build
#include "sponge_rows.cuh"

namespace {

__constant__ uint64_t c_ext[8][12] = POSEIDON2_ARK_EXT;  // 4 initial, 4 terminal
__constant__ uint64_t c_int[22] = POSEIDON2_ARK_INT;

constexpr uint64_t kDiag[12] = POSEIDON2_MAT_DIAG;

constexpr uint64_t inv_pow2(int k) {
  uint64_t x = 1;
  for (int i = 0; i < k; ++i) x = (x & 1) ? (x >> 1) + gl::HALF : x >> 1;
  return x;
}

static_assert(kDiag[0] == gl::P - 2 && kDiag[1] == 1 && kDiag[2] == 2 &&
                  kDiag[3] == inv_pow2(1) && kDiag[4] == 3 && kDiag[5] == 4 &&
                  kDiag[6] == gl::P - inv_pow2(1) && kDiag[7] == gl::P - 3 &&
                  kDiag[8] == gl::P - 4 && kDiag[9] == inv_pow2(2) &&
                  kDiag[10] == gl::P - inv_pow2(2) && kDiag[11] == inv_pow2(3),
              "internal_round's shift/add forms no longer match MAT_DIAG");

// x^7: x^2, x^4 and x^3 only feed products, so they skip the canonical
// subtract (gl::mul_wrap); x^7 is canonical.
__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = gl::mul_wrap(x, x);
  const uint64_t x4 = gl::mul_wrap(x2, x2);
  const uint64_t x3 = gl::mul_wrap(x2, x);
  return gl::mul(x4, x3);
}

// M_E: circ(2,3,1,1) inside each 4-lane chunk, y_r = (x0+x1+x2+x3) + x_r +
// 2*x_{(r+1)%4}, then out = y + (the sum of y over the three chunks).
__device__ __forceinline__ void mds_external(uint64_t (&s)[12]) {
  uint64_t y[12];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const uint64_t* x = s + 4 * c;
    gl::LazySum total;
#pragma unroll
    for (int r = 0; r < 4; ++r) total += x[r];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      gl::LazySum acc = total;
      const uint64_t nxt = x[(r + 1) & 3];
      acc += x[r];
      acc += nxt;
      acc += nxt;
      y[4 * c + r] = acc.value();
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    gl::LazySum sum;
    sum += y[r];
    sum += y[4 + r];
    sum += y[8 + r];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gl::LazySum acc = sum;
      acc += y[4 * c + r];
      s[4 * c + r] = acc.value();
    }
  }
}

__device__ __forceinline__ void external_round(uint64_t (&s)[12], int r) {
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = sbox(gl::add(s[i], c_ext[r][i]));
  mds_external(s);
}

__device__ __forceinline__ void internal_round(uint64_t (&x)[12], int r) {
  x[0] = sbox(gl::add(x[0], c_int[r]));
  gl::LazySum sum;
#pragma unroll
  for (int i = 0; i < 12; ++i) sum += x[i];
  const uint64_t t = sum.value();
  x[0] = gl::sub(t, gl::dbl(x[0]));                 // -2
  x[1] = gl::add(t, x[1]);                          // 1
  x[2] = gl::add(t, gl::dbl(x[2]));                 // 2
  x[3] = gl::add(t, gl::halve(x[3]));               // 1/2
  x[4] = gl::add(t, gl::mul3(x[4]));                // 3
  x[5] = gl::add(t, gl::mul_pow2(x[5], 2));         // 4
  x[6] = gl::sub(t, gl::halve(x[6]));               // -1/2
  x[7] = gl::sub(t, gl::mul3(x[7]));                // -3
  x[8] = gl::sub(t, gl::mul_pow2(x[8], 2));         // -4
  x[9] = gl::add(t, gl::mul_inv_pow2(x[9], 2));     // 1/4
  x[10] = gl::sub(t, gl::mul_inv_pow2(x[10], 2));   // -1/4
  x[11] = gl::add(t, gl::mul_inv_pow2(x[11], 3));   // 1/8
}

__device__ __forceinline__ void permute_state(uint64_t (&s)[12]) {
  mds_external(s);
#pragma unroll 1
  for (int r = 0; r < 4; ++r) external_round(s, r);
#pragma unroll 1
  for (int r = 0; r < 22; ++r) internal_round(s, r);
#pragma unroll 1
  for (int r = 4; r < 8; ++r) external_round(s, r);
}

struct Poseidon2 {
  static __device__ __forceinline__ void apply(uint64_t (&s)[12]) { permute_state(s); }
};

}  // namespace

extern "C" {

int poseidon2_permute(const void* x, void* out, long long n, void* stream) {
  return sponge::launch_permute<Poseidon2>(x, out, n, stream);
}

int poseidon2_absorb_rows(const void* state_in, void* state_out, const void* m, long long h,
                          int w, long long max_h, void* stream) {
  return sponge::launch_absorb_rows<Poseidon2>(state_in, state_out, m, h, w, max_h, stream);
}

int poseidon2_compress_rows(const void* cur, void* out, long long m, void* stream) {
  return sponge::launch_compress_rows<Poseidon2>(cur, out, m, stream);
}

}  // extern "C"
