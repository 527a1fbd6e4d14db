// Width-12 Goldilocks Poseidon2 for Hopper (sm_90a): K3 of the port, with
// three entry points over one permutation.
//
// Replaces miden_tpu/hash/poseidon2_pallas.py `permute_pallas` (kernel body
// `_permute_kernel`): the batched permutation on (12, n) states, in the
// order external MDS; 4 external rounds (round constant, x^7 S-box on all 12
// lanes, external MDS); 22 internal rounds (S-box on lane 0, then
// sum + MAT_DIAG * x); 4 terminal external rounds.
//
// - `poseidon2_permute`: (12, n) states in, (12, n) out (the duplex and the
//   PoW grind).
// - `poseidon2_absorb_rows`: the LMCS leaf sponge over one row-major matrix
//   (h, w): state (12, max_h) absorbs the ceil(w/8) rate blocks of row
//   d mod h (cyclic lifting), the ragged tail block zero-padded. One launch
//   per matrix, in place of one permutation launch per 8-column block and
//   the torch copies (transpose, pad, repeat, concatenate) around each.
// - `poseidon2_compress_rows`: one Merkle layer over row-major digests,
//   (2m, 4) -> (m, 4), state [left, right, 0, 0, 0, 0] truncated to 4 lanes.
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
// __constant__ memory, where a warp reads one word at once. absorb_rows
// stages each rate block of its rows into shared memory with cp.async
// (16-byte copies where the rows allow), the next block in flight while the
// current one is permuted, so device reads coalesce whatever w is;
// compress_rows reads each pair of digests as four 16-byte loads.
#include <cuda_runtime.h>
#include <cstdint>

#include "cp_async.cuh"
#include "goldilocks.cuh"
#include "poseidon2_constants.h"  // generated from hash/constants.py at build

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

constexpr int kThreads = 128;
constexpr int kRate = 8;

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

__global__ void __launch_bounds__(kThreads) permute_kernel(const uint64_t* __restrict__ x,
                                                           uint64_t* __restrict__ out,
                                                           int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  uint64_t s[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = x[i * n + j];
  permute_state(s);
#pragma unroll
  for (int i = 0; i < 12; ++i) out[i * n + j] = s[i];
}

// Start copying rate block c0 / 8 of rows [r0, r0 + rows) of the (h, w)
// matrix m into tile (rows x 8), as one cp.async group: 16-byte copies when
// every row segment starts on a 16-byte boundary (w even, m aligned), 8-byte
// copies otherwise. Columns past w (the ragged tail block) are not copied.
__device__ __forceinline__ void stage_block(uint64_t* tile, const uint64_t* __restrict__ m,
                                            int64_t r0, int rows, int w, int c0, bool wide) {
  const int cw = min(kRate, w - c0);
  if (wide && cw == kRate) {
    for (int e = threadIdx.x; e < rows * (kRate / 2); e += blockDim.x) {
      const int r = e / (kRate / 2), k = 2 * (e % (kRate / 2));
      cp_async::copy16(tile + r * kRate + k, m + (r0 + r) * w + c0 + k);
    }
  } else {
    for (int e = threadIdx.x; e < rows * kRate; e += blockDim.x) {
      const int r = e / kRate, k = e % kRate;
      if (k < cw) cp_async::copy8(tile + e, m + (r0 + r) * w + c0 + k);
    }
  }
  cp_async::commit();
}

// Thread j (< max_h) absorbs row j & (h - 1). A block's threads read rows
// r0 .. r0 + rows - 1 with rows = min(kThreads, h): h and max_h are powers
// of two, so the block's rows are consecutive (h >= kThreads) or the whole
// matrix (h < kThreads). Rate blocks go through two tiles of rows x 8 in
// shared memory: block b + 1 is in flight while block b is permuted.
__global__ void __launch_bounds__(kThreads) absorb_rows_kernel(
    const uint64_t* __restrict__ st_in, uint64_t* __restrict__ st_out,
    const uint64_t* __restrict__ m, int64_t h, int w, int64_t max_h) {
  __shared__ __align__(16) uint64_t tiles[2][kThreads * kRate];
  const int64_t j0 = (int64_t)blockIdx.x * kThreads;
  const int64_t j = j0 + threadIdx.x;
  const bool active = j < max_h;
  const int rows = h < kThreads ? (int)h : kThreads;
  const int64_t r0 = j0 & (h - 1);
  const int my_row = threadIdx.x & (rows - 1);
  const bool wide = (w % 2 == 0) && (reinterpret_cast<uintptr_t>(m) & 15) == 0;
  uint64_t s[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = active ? st_in[i * max_h + j] : 0;
  const int blocks = (w + kRate - 1) / kRate;
  stage_block(tiles[0], m, r0, rows, w, 0, wide);
  for (int b = 0; b < blocks; ++b) {
    if (b + 1 < blocks) {
      stage_block(tiles[(b + 1) & 1], m, r0, rows, w, (b + 1) * kRate, wide);
      cp_async::wait<1>();
    } else {
      cp_async::wait<0>();
    }
    __syncthreads();  // block b is in shared memory for every thread
    const int cw = min(kRate, w - b * kRate);
    const uint64_t* row = tiles[b & 1] + my_row * kRate;
#pragma unroll
    for (int i = 0; i < kRate; ++i) s[i] = i < cw ? row[i] : 0;
    __syncthreads();  // every thread has read tile b & 1 before block b + 2 lands there
    if (active) permute_state(s);
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < 12; ++i) st_out[i * max_h + j] = s[i];
  }
}

// Thread i compresses rows 2i, 2i + 1 of cur (64 contiguous bytes).
__global__ void __launch_bounds__(kThreads) compress_rows_kernel(
    const uint64_t* __restrict__ cur, uint64_t* __restrict__ out, int64_t m) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const ulonglong2* src = reinterpret_cast<const ulonglong2*>(cur) + 4 * i;
  uint64_t s[12];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const ulonglong2 v = src[k];
    s[2 * k] = v.x;
    s[2 * k + 1] = v.y;
  }
#pragma unroll
  for (int k = 8; k < 12; ++k) s[k] = 0;
  permute_state(s);
  ulonglong2* dst = reinterpret_cast<ulonglong2*>(out) + 2 * i;
  dst[0] = make_ulonglong2(s[0], s[1]);
  dst[1] = make_ulonglong2(s[2], s[3]);
}

}  // namespace

extern "C" {

// x, out: (12, n) int64 row-major. Returns the CUDA error code of the launch.
int poseidon2_permute(const void* x, void* out, long long n, void* stream) {
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  permute_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)out, n);
  return (int)cudaGetLastError();
}

// state_in, state_out: (12, max_h); m: (h, w) row-major, h a power of two
// dividing max_h, w >= 1. state_out may be state_in.
int poseidon2_absorb_rows(const void* state_in, void* state_out, const void* m, long long h,
                          int w, long long max_h, void* stream) {
  const unsigned grid = (unsigned)((max_h + kThreads - 1) / kThreads);
  absorb_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)state_in, (uint64_t*)state_out, (const uint64_t*)m, h, w, max_h);
  return (int)cudaGetLastError();
}

// cur: (2m, 4), out: (m, 4), both 16-byte aligned.
int poseidon2_compress_rows(const void* cur, void* out, long long m, void* stream) {
  const unsigned grid = (unsigned)((m + kThreads - 1) / kThreads);
  compress_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)cur, (uint64_t*)out, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
