// Goldilocks NTT kernels for Hopper (sm_90a): K1 and K2 of the port.
//
// K1 `ntt_col_transform` replaces miden_tpu/ntt/ntt_pallas.py `_col_transform`
// (the Pallas kernel entered through `col_transform`): a radix-2 transform
// along axis 0 of an (n, M) array, every stage on chip. DIF takes natural
// order to bit-reversed order, DIT takes bit-reversed order back to natural;
// the twiddles are forward or inverse as the caller's table says.
//
// K2 `ntt_transpose_twiddle` is the pass of the four-step transform
// (miden_tpu/ntt/ntt_pallas.py `dft_dif` / `dft_dit`) that the TPU left to
// XLA: the outer-twiddle multiply `_twiddle_mul` and the swapaxes around it.
// Here one kernel reads (A, B, w), multiplies by T and writes (B, A, w).
//
// What bounds them on the H100: both move each element once in and once out
// of device memory per pass and do a handful of 64-bit multiplies per
// element, so their bound is the bytes (3.35 TB/s), not the integer
// multiply rate. K1 still spends more time issuing instructions than
// moving bytes: a Goldilocks product is 27 SASS instructions (12 of them
// IMAD), a butterfly about 40, ten stages of them per element at n = 2^10.
//
// K1's design. A persistent block (one an SM: 512 threads at up to 128
// registers fill the register file) walks over tiles of n rows x C columns,
// with two tile slots in shared memory: while the butterflies of tile t run
// in one slot, tile t + grid is copied from device memory into the other
// with cp.async (16-byte copies where every row segment of the tile is
// whole and 16-byte aligned, 8-byte copies otherwise), so loads overlap the
// arithmetic. A slot holds at most 64 KB: C = 2^(13 - log n) columns, up to
// 256 (8 at n = 2^10, 4 at 2^11, 2 at 2^12), narrowed down to 8 where there
// would be fewer tiles than SMs. The log n stages are cut into groups of at
// most kMaxGroup = 4 (n = 2^10: 4 + 3 + 3). For a group, each thread holds
// one set of 2^G elements of one column in registers (rows base + k *
// stride), runs all G stages there and writes them back to the slot, so a
// 2^10 transform meets 3 barriers and 3 passes over shared memory, not 10 of
// each; the last group stores straight from registers to device memory. The
// n - 1 stage twiddles are copied into shared memory once per block, and the
// last group in stage order skips its multiplies by the twiddle 1. The
// launcher picks the tile and the thread count (one thread for every set and
// column of the smallest group, at most 512).
#include <cuda_runtime.h>
#include <cstdint>

#include "cp_async.cuh"
#include "goldilocks.cuh"

namespace {

constexpr int kColThreads = 512;  // at most 128 registers a thread
constexpr int kMaxGroup = 4;      // stages a group holds in registers (5 spills)

// Stage s of a size-2^log_n transform works on blocks of m = n >> s rows and
// pairs (p, p + m/2). Its twiddles tw[off_s + j] = w_m^j (j < m/2), with
// off_s = n - (n >> s): the stage tables of miden_tpu's `_stage_tw_table`
// without the repeated entries.
//
// The stages [s0, s0 + G) of one set: v[k] is row base + k * stride, with
// stride = n >> (s0 + G) and lo = base mod stride. Stage s0 + t pairs k and
// k + 2^(G-1-t); its twiddle index is row mod (n >> (s0 + t + 1)). In the
// last group of the stage order (LAST: s0 + G = log n) stride is 1 and lo 0,
// so the index is k mod 2^(G-1-t), known when the loops unroll: index 0 is
// the twiddle 1 and takes no multiply (n - 1 of the (n/2) log n butterflies
// of a transform have it, and all but 2^s0 - 1 of them fall in that group).
template <int G, bool DIT, bool LAST>
__device__ __forceinline__ void group_butterflies(uint64_t (&v)[1 << G], int lo, int stride,
                                                  int s0, int n, const uint64_t* tw) {
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int t = DIT ? G - 1 - u : u;
    const int hk = 1 << (G - 1 - t);
    const int s = s0 + t;
    const int half_mask = (n >> (s + 1)) - 1;
    const uint64_t* tws = tw + (n - (n >> s));
#pragma unroll
    for (int k = 0; k < (1 << G); ++k) {
      if (k & hk) continue;
      const int j = LAST ? (k & (hk - 1)) : ((lo + k * stride) & half_mask);
      const uint64_t a = v[k], b = v[k + hk];
      if (LAST && j == 0) {
        v[k] = gl::add(a, b);
        v[k + hk] = gl::sub(a, b);
        continue;
      }
      const uint64_t w = tws[j];
      if (DIT) {
        const uint64_t wb = gl::mul(b, w);
        v[k] = gl::add(a, wb);
        v[k + hk] = gl::sub(a, wb);
      } else {
        v[k] = gl::add(a, b);
        v[k + hk] = gl::mul(gl::sub(a, b), w);
      }
    }
  }
}

// One group over the tile in `buf` (row stride C): thread (q, c) for every
// set q and column c < C. The results go back to buf, or (TO_GLOBAL) to the
// tile's column 0 in device memory, `out` (row stride m_cols).
template <int G, bool DIT, bool LAST, bool TO_GLOBAL>
__device__ __forceinline__ void run_group(uint64_t* buf, uint64_t* __restrict__ out,
                                          int64_t m_cols, int s0, int log_n, int log_tile,
                                          bool valid, const uint64_t* tw) {
  if (!valid) return;
  const int n = 1 << log_n;
  const int c = threadIdx.x & ((1 << log_tile) - 1);
  const int log_stride = log_n - s0 - G;
  const int stride = 1 << log_stride;
  for (int q = threadIdx.x >> log_tile; q < (n >> G); q += blockDim.x >> log_tile) {
    const int lo = q & (stride - 1);
    const int base = ((q >> log_stride) << (log_n - s0)) + lo;
    uint64_t v[1 << G];
#pragma unroll
    for (int k = 0; k < (1 << G); ++k) v[k] = buf[((base + k * stride) << log_tile) + c];
    group_butterflies<G, DIT, LAST>(v, lo, stride, s0, n, tw);
#pragma unroll
    for (int k = 0; k < (1 << G); ++k) {
      if (TO_GLOBAL)
        out[(int64_t)(base + k * stride) * m_cols + c] = v[k];
      else
        buf[((base + k * stride) << log_tile) + c] = v[k];
    }
  }
}

// run_group for a group of g stages, 1 <= g <= kMaxGroup.
template <bool DIT, bool LAST, bool TO_GLOBAL, int G = 1>
__device__ __forceinline__ void run_group_any(int g, uint64_t* buf, uint64_t* out, int64_t m_cols,
                                              int s0, int log_n, int log_tile, bool valid,
                                              const uint64_t* tw) {
  if constexpr (G <= kMaxGroup) {
    if (g == G)
      run_group<G, DIT, LAST, TO_GLOBAL>(buf, out, m_cols, s0, log_n, log_tile, valid, tw);
    else
      run_group_any<DIT, LAST, TO_GLOBAL, G + 1>(g, buf, out, m_cols, s0, log_n, log_tile, valid,
                                                 tw);
  }
}

// Group i of the ng groups in stage order: as few groups of at most
// kMaxGroup stages as possible, as even as possible (10 -> 4 + 3 + 3,
// 12 -> 4 + 4 + 4), the larger ones first.
__host__ __device__ inline int num_groups(int log_n) { return (log_n + kMaxGroup - 1) / kMaxGroup; }
__host__ __device__ inline int group_size(int log_n, int ng, int i) {
  return log_n / ng + (i < log_n % ng ? 1 : 0);
}
__host__ __device__ inline int group_start(int log_n, int ng, int i) {
  return i * (log_n / ng) + (i < log_n % ng ? i : log_n % ng);
}

// Start copying the tile of columns [c0, c0 + C) of x into `slot` (n x C),
// as one cp.async group. Columns past m_cols are not copied (their threads
// skip the tile).
__device__ __forceinline__ void stage_tile(uint64_t* slot, const uint64_t* __restrict__ x,
                                           int64_t m_cols, int64_t c0, int log_n, int log_tile,
                                           bool wide) {
  const int C = 1 << log_tile;
  const int elems = C << log_n;
  if (wide && c0 + C <= m_cols) {
    for (int e = 2 * threadIdx.x; e < elems; e += 2 * blockDim.x)
      cp_async::copy16(slot + e, x + (e >> log_tile) * m_cols + c0 + (e & (C - 1)));
  } else {
    for (int e = threadIdx.x; e < elems; e += blockDim.x) {
      const int k = e & (C - 1);
      if (c0 + k < m_cols) cp_async::copy8(slot + e, x + (e >> log_tile) * m_cols + c0 + k);
    }
  }
  cp_async::commit();
}

template <bool DIT>
__global__ void __launch_bounds__(kColThreads) col_transform_kernel(
    const uint64_t* __restrict__ x, uint64_t* __restrict__ out, const uint64_t* __restrict__ tw_g,
    int log_n, int64_t m_cols, int log_tile) {
  extern __shared__ __align__(16) uint64_t smem[];
  const int n = 1 << log_n;
  const int tile = n << log_tile;
  uint64_t* tw = smem;          // n - 1 stage twiddles (n words keep the slots aligned)
  uint64_t* slots = smem + n;   // two tiles of n x C
  for (int i = threadIdx.x; i < n - 1; i += blockDim.x) tw[i] = tw_g[i];
  const int ng = num_groups(log_n);
  // 16-byte copies need every row segment on a 16-byte boundary
  const bool wide = log_tile >= 1 && m_cols % 2 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int64_t ntiles = (m_cols + (1 << log_tile) - 1) >> log_tile;
  int64_t t = blockIdx.x;
  if (t < ntiles) stage_tile(slots, x, m_cols, t << log_tile, log_n, log_tile, wide);
  for (int i = 0; t < ntiles; t += gridDim.x, ++i) {
    uint64_t* buf = slots + (i & 1) * tile;
    const int64_t next = t + gridDim.x;
    if (next < ntiles) {
      // the other slot was freed by the barrier that ended the last tile
      stage_tile(slots + ((i + 1) & 1) * tile, x, m_cols, next << log_tile, log_n, log_tile, wide);
      cp_async::wait<1>();
    } else {
      cp_async::wait<0>();
    }
    __syncthreads();  // tile t (and the twiddles) in shared memory for every thread
    const int64_t c0 = t << log_tile;
    const bool valid = c0 + (threadIdx.x & ((1 << log_tile) - 1)) < m_cols;
    uint64_t* ot = out + c0;
    for (int j = 0; j < ng; ++j) {
      const int gi = DIT ? ng - 1 - j : j;  // DIT runs the stages last to first
      const int g = group_size(log_n, ng, gi), s0 = group_start(log_n, ng, gi);
      // LAST: the group that ends the stage order (DIF's last, DIT's first)
      if (j == ng - 1) {
        if (DIT && ng > 1)
          run_group_any<DIT, false, true>(g, buf, ot, m_cols, s0, log_n, log_tile, valid, tw);
        else
          run_group_any<DIT, true, true>(g, buf, ot, m_cols, s0, log_n, log_tile, valid, tw);
      } else if (DIT && j == 0) {
        run_group_any<DIT, true, false>(g, buf, ot, m_cols, s0, log_n, log_tile, valid, tw);
      } else {
        run_group_any<DIT, false, false>(g, buf, ot, m_cols, s0, log_n, log_tile, valid, tw);
      }
      __syncthreads();  // the group's writes are visible; after the last, buf is free again
    }
  }
}

// out[b, a, k] = x[a, b, k] * T, where T = tw[a, b] (mode 1, tw is (A, B)),
// tw[b, a] (mode 2, tw is (B, A)) or 1 (mode 0). blockIdx.y is b; x runs
// over the contiguous output row (a, k), so writes coalesce and reads come
// in runs of w elements.
__global__ void transpose_twiddle_kernel(const uint64_t* __restrict__ x,
                                         uint64_t* __restrict__ out,
                                         const uint64_t* __restrict__ tw,
                                         int64_t A, int64_t B, int w,
                                         int mode) {
  const int64_t b = blockIdx.y;
  const int row = (int)(A * w);  // the wrapper keeps A·w below 2^31
  for (int o = blockIdx.x * blockDim.x + threadIdx.x; o < row;
       o += gridDim.x * blockDim.x) {
    const int64_t a = o / w;  // 32-bit division: cheap next to a 64-bit one
    const int64_t k = o - a * w;
    uint64_t v = x[(a * B + b) * w + k];
    if (mode == 1) v = gl::mul(v, __ldg(&tw[a * B + b]));
    if (mode == 2) v = gl::mul(v, __ldg(&tw[b * A + a]));
    out[b * (int64_t)row + o] = v;
  }
}

}  // namespace

extern "C" {

// x, out: (2^log_n, m_cols) int64 row-major, 1 <= log_n <= 12, m_cols >= 1;
// tw: the 2^log_n - 1 stage twiddles. Returns the CUDA error code of the
// launch (0 when it was accepted).
int ntt_col_transform(const void* x, void* out, const void* tw, int log_n, long long m_cols,
                      int dit, void* stream) {
  // Per process: the SM count, and the resident blocks per SM of each
  // (dit, log_n, log_tile), found at the first launch of that shape.
  static int sms = 0;
  static int per_sm[2][13][9] = {};
  if (log_n < 1 || log_n > 12 || m_cols < 1) return (int)cudaErrorInvalidValue;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  // the tile: 64 KB slots, narrowed (down to 8 columns) while there would be
  // fewer tiles than SMs
  int log_tile = 13 - log_n < 8 ? 13 - log_n : 8;
  while (log_tile > 3 && ((m_cols + (1 << log_tile) - 1) >> log_tile) < sms) --log_tile;
  const int n = 1 << log_n;
  const size_t smem = ((size_t)n + ((size_t)2 * n << log_tile)) * sizeof(uint64_t);
  const int ng = num_groups(log_n);
  // a thread for every set and column of the smallest (last) group
  int threads = (n >> group_size(log_n, ng, ng - 1)) << log_tile;
  if (threads > kColThreads) threads = kColThreads;
  if (threads < 32) threads = 32;
  const auto kernel = dit ? col_transform_kernel<true> : col_transform_kernel<false>;
  int& blocks = per_sm[dit ? 1 : 0][log_n][log_tile];
  if (blocks == 0) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
    if (err != cudaSuccess) return (int)err;
    if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
  }
  const int64_t ntiles = (m_cols + (1 << log_tile) - 1) >> log_tile;
  int64_t grid = (int64_t)blocks * sms;
  if (grid > ntiles) grid = ntiles;
  kernel<<<(unsigned)grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)out, (const uint64_t*)tw, log_n, m_cols, log_tile);
  return (int)cudaGetLastError();
}

// x: (A, B, w), out: (B, A, w), tw: (A, B) for mode 1, (B, A) for mode 2,
// unused for mode 0.
int ntt_transpose_twiddle(const void* x, void* out, const void* tw,
                          long long A, long long B, int w, int mode,
                          void* stream) {
  const int64_t row = A * w;
  int64_t gx = (row + 255) / 256;
  if (gx > 65535) gx = 65535;
  dim3 grid((unsigned)gx, (unsigned)B);
  transpose_twiddle_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)out, (const uint64_t*)tw, A, B, w, mode);
  return (int)cudaGetLastError();
}

}  // extern "C"
