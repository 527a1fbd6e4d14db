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
// element, so they are bound by bytes (3.35 TB/s), not by the integer
// multiply rate. The designs therefore keep all log n stages of a
// sub-transform in shared memory (one read and one write of the tile per
// launch, instead of one per stage), read and write rows of at least 4
// columns (32 B) so that neighbouring threads touch neighbouring addresses,
// and fold the twiddle multiply into the transpose so that it costs no pass
// of its own. The single-kernel size is 2^12 rows: with the 4-column minimum
// that is a 128 KB tile, the largest power of two that fits the 227 KB of
// shared memory a block may use. Larger transforms go through the four-step
// decomposition in miden_tpu_torch/ntt/ntt.py.
#include <cuda_runtime.h>
#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int kThreads = 512;

// Stage s of a size-2^log_n transform works on blocks of m = n >> s rows and
// pairs (p, p + m/2). Its twiddles tw[off_s + j] = w_m^j (j < m/2), with
// off_s = n - (n >> s): the stage tables of miden_tpu's `_stage_tw_table`
// without the repeated entries.
__global__ void col_transform_kernel(const uint64_t* __restrict__ x,
                                     uint64_t* __restrict__ out,
                                     const uint64_t* __restrict__ tw, int log_n,
                                     int64_t m_cols, int log_tile, int dit) {
  extern __shared__ uint64_t buf[];
  const int n = 1 << log_n;
  const int tile = 1 << log_tile;
  const int64_t c0 = (int64_t)blockIdx.x * tile;
  const int64_t left = m_cols - c0;
  const int ncols = left < tile ? (int)left : tile;
  const int total = n << log_tile;

  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e >> log_tile;
    const int c = e & (tile - 1);
    buf[e] = c < ncols ? x[(int64_t)r * m_cols + c0 + c] : 0;
  }
  __syncthreads();

  const int nb = (n >> 1) << log_tile;  // butterflies per stage
  for (int k = 0; k < log_n; ++k) {
    const int s = dit ? (log_n - 1 - k) : k;
    const int log_half = log_n - 1 - s;
    const int half = 1 << log_half;
    const int off = n - (n >> s);
    for (int t = threadIdx.x; t < nb; t += blockDim.x) {
      const int c = t & (tile - 1);
      const int jg = t >> log_tile;
      const int j = jg & (half - 1);
      const int p = ((jg >> log_half) << (log_half + 1)) + j;
      const int ip = (p << log_tile) + c;
      const int iq = ((p + half) << log_tile) + c;
      const uint64_t w = __ldg(&tw[off + j]);
      const uint64_t a = buf[ip];
      const uint64_t b = buf[iq];
      if (dit) {
        const uint64_t wb = gl::mul(b, w);
        buf[ip] = gl::add(a, wb);
        buf[iq] = gl::sub(a, wb);
      } else {
        buf[ip] = gl::add(a, b);
        buf[iq] = gl::mul(gl::sub(a, b), w);
      }
    }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e >> log_tile;
    const int c = e & (tile - 1);
    if (c < ncols) out[(int64_t)r * m_cols + c0 + c] = buf[e];
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

// x, out: (2^log_n, m_cols) int64 row-major; tw: 2^log_n - 1 stage twiddles.
// Returns the CUDA error code of the launch (0 when it was accepted).
int ntt_col_transform(const void* x, void* out, const void* tw, int log_n,
                      long long m_cols, int log_tile, int dit, void* stream) {
  const int n = 1 << log_n;
  const size_t smem = (size_t)n << log_tile << 3;
  cudaError_t err = cudaFuncSetAttribute(
      col_transform_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t tile = 1 << log_tile;
  const unsigned grid = (unsigned)((m_cols + tile - 1) / tile);
  col_transform_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)x, (uint64_t*)out, (const uint64_t*)tw, log_n, m_cols,
      log_tile, dit);
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
