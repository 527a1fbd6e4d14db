// Width-12 Goldilocks Poseidon2 permutation for Hopper (sm_90a): K3 of the
// port.
//
// Replaces miden_tpu/hash/poseidon2_pallas.py `permute_pallas` (kernel body
// `_permute_kernel`): the batched permutation on (12, n) states, in the
// order external MDS; 4 external rounds (round constant, x^7 S-box on all 12
// lanes, external MDS); 22 internal rounds (S-box on lane 0, then
// sum + MAT_DIAG * x); 4 terminal external rounds.
//
// What bounds it on the H100: the integer multiplier. A permutation needs
// 472 general Goldilocks multiplies (8 external rounds x 12 S-boxes x 4,
// plus 22 internal rounds x 4 for the lane-0 S-box), each a 64x64 -> 128-bit
// product, against 2 x 12 x 8 = 192 bytes of device traffic, so bytes are
// never the limit. The internal diagonal needs no general multiply: the
// MAT_DIAG entries are +-2^k, +-3 and +-2^-k. This kernel still multiplies
// by them with gl::mul (264 more products per permutation).
// The design gives each thread one state and keeps its 12 lanes in
// registers through all 30 rounds: device memory sees one read and one
// write per lane. Lane i of neighbouring threads is adjacent in the (12, n)
// layout, so loads and stores coalesce. Round constants and MAT_DIAG sit in
// __constant__ memory, where every thread of a warp reads the same word at
// once. Any n >= 1 is taken; threads past n return before loading.
#include <cuda_runtime.h>
#include <cstdint>

#include "goldilocks.cuh"
#include "poseidon2_constants.h"  // generated from hash/constants.py at build

namespace {

__constant__ uint64_t c_ext[8][12] = POSEIDON2_ARK_EXT;  // 4 initial, 4 terminal
__constant__ uint64_t c_int[22] = POSEIDON2_ARK_INT;
__constant__ uint64_t c_diag[12] = POSEIDON2_MAT_DIAG;

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = gl::mul(x, x);
  const uint64_t x4 = gl::mul(x2, x2);
  const uint64_t x3 = gl::mul(x2, x);
  return gl::mul(x4, x3);
}

// M_E: circ(2,3,1,1) inside each 4-lane chunk, written as
// y_r = (x0+x1+x2+x3) + x_r + 2*x_{(r+1)%4}, then the cross-chunk sums.
__device__ __forceinline__ void mds_external(uint64_t s[12]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    uint64_t* x = s + 4 * c;
    const uint64_t total = gl::add(gl::add(x[0], x[1]), gl::add(x[2], x[3]));
    uint64_t y[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint64_t nxt = x[(r + 1) & 3];
      y[r] = gl::add(total, gl::add(x[r], gl::add(nxt, nxt)));
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = y[r];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint64_t sum = gl::add(gl::add(s[r], s[4 + r]), s[8 + r]);
    s[r] = gl::add(s[r], sum);
    s[4 + r] = gl::add(s[4 + r], sum);
    s[8 + r] = gl::add(s[8 + r], sum);
  }
}

__device__ __forceinline__ void external_round(uint64_t s[12], int r) {
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = sbox(gl::add(s[i], c_ext[r][i]));
  mds_external(s);
}

__device__ __forceinline__ void internal_round(uint64_t s[12], int r) {
  s[0] = sbox(gl::add(s[0], c_int[r]));
  uint64_t total = s[0];
#pragma unroll
  for (int i = 1; i < 12; ++i) total = gl::add(total, s[i]);
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = gl::add(total, gl::mul(s[i], c_diag[i]));
}

__global__ void permute_kernel(const uint64_t* __restrict__ x,
                               uint64_t* __restrict__ out, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  uint64_t s[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = x[i * n + j];
  mds_external(s);
#pragma unroll 1
  for (int r = 0; r < 4; ++r) external_round(s, r);
#pragma unroll 1
  for (int r = 0; r < 22; ++r) internal_round(s, r);
#pragma unroll 1
  for (int r = 4; r < 8; ++r) external_round(s, r);
#pragma unroll
  for (int i = 0; i < 12; ++i) out[i * n + j] = s[i];
}

}  // namespace

extern "C" {

// x, out: (12, n) int64 row-major. Returns the CUDA error code of the launch.
int poseidon2_permute(const void* x, void* out, long long n, void* stream) {
  const int threads = 128;
  const unsigned grid = (unsigned)((n + threads - 1) / threads);
  permute_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
