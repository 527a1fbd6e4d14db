// The three entry kernels that every width-12 Goldilocks permutation of the
// port offers (K3 Poseidon2 in poseidon2.cu, R1 RPO-256 and R2 RPX-256 in
// rescue.cu), as templates over the permutation. `Perm` is a type with
// `static __device__ void apply(uint64_t (&s)[12])`.
//
// - `permute_kernel`: (12, n) states in, (12, n) out.
// - `absorb_rows_kernel`: the LMCS leaf sponge over one row-major matrix
//   (h, w) in overwrite mode (rate lanes 0..8, capacity 8..12): state
//   (12, max_h) absorbs the ceil(w/8) rate blocks of row d mod h (cyclic
//   lifting), the ragged tail block zero-padded. One launch per matrix.
// - `compress_rows_kernel`: one Merkle layer over row-major digests,
//   (2m, 4) -> (m, 4), state [left, right, 0, 0, 0, 0] truncated to 4 lanes.
//
// One thread per state keeps the 12 lanes in registers through the whole
// permutation. absorb_rows stages each rate block of its rows into shared
// memory with cp.async (16-byte copies where the rows allow), the next block
// in flight while the current one is permuted, so device reads coalesce
// whatever w is; compress_rows reads each pair of digests as four 16-byte
// loads.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "cp_async.cuh"

namespace sponge {

constexpr int kThreads = 128;
constexpr int kRate = 8;

template <class Perm>
__global__ void __launch_bounds__(kThreads) permute_kernel(const uint64_t* __restrict__ x,
                                                           uint64_t* __restrict__ out,
                                                           int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n) return;
  uint64_t s[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) s[i] = x[i * n + j];
  Perm::apply(s);
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
template <class Perm>
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
    if (active) Perm::apply(s);
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < 12; ++i) st_out[i * max_h + j] = s[i];
  }
}

// Thread i compresses rows 2i, 2i + 1 of cur (64 contiguous bytes).
template <class Perm>
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
  Perm::apply(s);
  ulonglong2* dst = reinterpret_cast<ulonglong2*>(out) + 2 * i;
  dst[0] = make_ulonglong2(s[0], s[1]);
  dst[1] = make_ulonglong2(s[2], s[3]);
}

// The C launchers of one permutation: x, out (12, n); state_in, state_out
// (12, max_h) and m (h, w) row-major, h a power of two dividing max_h, w >= 1
// (state_out may be state_in); cur (2m, 4) and out (m, 4), both 16-byte
// aligned. Each returns the CUDA error code of its launch.
template <class Perm>
int launch_permute(const void* x, void* out, long long n, void* stream) {
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  permute_kernel<Perm><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)out, n);
  return (int)cudaGetLastError();
}

template <class Perm>
int launch_absorb_rows(const void* state_in, void* state_out, const void* m, long long h, int w,
                       long long max_h, void* stream) {
  const unsigned grid = (unsigned)((max_h + kThreads - 1) / kThreads);
  absorb_rows_kernel<Perm><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)state_in, (uint64_t*)state_out, (const uint64_t*)m, h, w, max_h);
  return (int)cudaGetLastError();
}

template <class Perm>
int launch_compress_rows(const void* cur, void* out, long long m, void* stream) {
  const unsigned grid = (unsigned)((m + kThreads - 1) / kThreads);
  compress_rows_kernel<Perm><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)cur, (uint64_t*)out, m);
  return (int)cudaGetLastError();
}

}  // namespace sponge
