// D1: the DEEP step of the PCS opening for Hopper (sm_90a), two entries.
//
// It replaces no TPU kernel: miden_tpu computes the step in XLA
// (miden_tpu/stark/pcs.py compute_deep_claims, deep_compose), and the port
// did so in plain torch (stark/pcs.py ood_sums_plain, deep_rows_plain),
// where every Goldilocks product is some 30 elementwise int64 kernels over
// the whole (rows, w, 2) block and each sum 18 halvings: 123k graph nodes
// and about 1 TB of traffic per vm-fib-18 proof.
//
// `deep_ood_sums_kernel` reads one committed (rows, w) matrix (or a rank's
// block of it, at its row offset) once and gives, for up to two opening
// points z_l together, the scaled column sums
//   c_l * sum_i f_c(x_i) * x_i / (z_l - x_i),   c_l = (z_l^m - s^m) / (m s^m),
// z_l = z^(2^log_lift), x_i the block's coset points (a table). Each block
// walks a range of rows in chunks of kOodChunk: first the chunk's weights
// x_i / (z_l - x_i) into shared memory (Montgomery's trick over kInvBatch
// rows a thread, one Fermat inverse for them), then every thread -- tc
// columns by rl row lanes, neighbouring threads on neighbouring columns of
// a row -- adds weight * f for its column into 192-bit sums that reduce
// once (gl::Wide3: two 32x32 multiply chains and three adds an element and
// point, no modular reduction in the loop). The row lanes are summed in
// shared memory, each block writes its column sums to `part`, and the last
// block of a column tile to finish (a ticket in `counters`, which it resets)
// adds them up, scales them by c_l and writes the (np, w, 2) claims. Field
// addition is exact, so the order of the sums does not change a bit.
//
// `deep_rows_kernel` gives the DEEP quotient over the max LDE domain (or a
// rank's block of it): f_red(x) = sum_c alpha^(W-1-c) f_c(x) over the
// aligned columns of all committed matrices, the shorter ones lifted by
// their rows (off + r) mod h, then sum_j beta^j (f_red(z_j) - f_red(x)) /
// (z_j - x). A block takes 128 rows, a thread each; each matrix is staged
// through shared memory kSlice columns at a time (the rows read whole, so
// the loads are coalesced; the tile's row stride is odd, so a thread's row
// meets no bank conflict), and f_red is a Horner sum over the slices:
// acc = acc * alpha^cw + sum_{c<cw} alpha^(cw-1-c) f_c, with alpha^0..32 in
// shared memory and the inner sum in Wide3, and acc * alpha^pad after a
// matrix for its zero columns. f_red(z_j) is the same sum over the claims,
// made by each block (its threads over slices of 32 claims from the end).
// The grid is persistent; a block's chunks are taken in an order that puts
// the lifted copies of a short matrix's rows in neighbouring chunks, so
// that they come from L2.
//
// What bounds them on the H100: the bytes of the committed matrices (each
// read once a pass: ~1.4 GB a vm-fib-18 proof, ~0.42 ms at 3.35 TB/s),
// against 2 (rows) or 4 (OOD) 64x64-bit products an element. The inverses
// are a few per row (the OOD weights batched by four; the DEEP rows'
// 1/(z_j - x) one Fermat inverse each).
#include <cuda_runtime.h>
#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int kMaxPoints = 2;    // opening points a launch takes
constexpr int kOodThreads = 256;  // at most: the launcher's tc x rl
constexpr int kOodChunk = 1024;   // rows whose weights a block holds at once (32 KB)
constexpr int kInvBatch = 4;      // weights a thread inverts together
constexpr int kRowsThreads = 128;  // rows of a chunk of the DEEP rows, one a thread
constexpr int kSlice = 32;        // columns staged at a time
constexpr int kMaxMats = 64;      // matrices in one launch's table

// F_p[phi] / (phi^2 - 7)
struct Ext {
  uint64_t a, b;
};

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ uint64_t mul7(uint64_t x) { return gl::sub(gl::mul_pow2(x, 3), x); }

__device__ __forceinline__ Ext ext_add(Ext x, Ext y) { return {gl::add(x.a, y.a), gl::add(x.b, y.b)}; }

__device__ __forceinline__ Ext ext_sub(Ext x, Ext y) { return {gl::sub(x.a, y.a), gl::sub(x.b, y.b)}; }

__device__ __forceinline__ Ext ext_mul(Ext x, Ext y) {
  return {gl::add(gl::mul(x.a, y.a), mul7(gl::mul(x.b, y.b))),
          gl::add(gl::mul(x.a, y.b), gl::mul(x.b, y.a))};
}

__device__ __forceinline__ Ext ext_sqr_n(Ext x, int n) {
  for (int i = 0; i < n; ++i) x = ext_mul(x, x);
  return x;
}

// x^e for e >= 0
__device__ Ext ext_pow(Ext x, uint32_t e) {
  Ext r = {1, 0};
  for (; e; e >>= 1) {
    if (e & 1) r = ext_mul(r, x);
    x = ext_mul(x, x);
  }
  return r;
}

__device__ __forceinline__ uint64_t sqr_n(uint64_t x, int n) {
  for (int i = 0; i < n; ++i) x = gl::mul(x, x);
  return x;
}

// x^(p - 2), the inverse of x != 0 (0 for 0), by p - 2 = (2^31 - 1) * 2^33 +
// (2^32 - 1), with t_k = x^(2^k - 1): 64 squares and 8 products.
__device__ uint64_t inv(uint64_t x) {
  const uint64_t t2 = gl::mul(gl::mul(x, x), x);
  const uint64_t t3 = gl::mul(gl::mul(t2, t2), x);
  const uint64_t t6 = gl::mul(sqr_n(t3, 3), t3);
  const uint64_t t12 = gl::mul(sqr_n(t6, 6), t6);
  const uint64_t t24 = gl::mul(sqr_n(t12, 12), t12);
  const uint64_t t30 = gl::mul(sqr_n(t24, 6), t6);
  const uint64_t t31 = gl::mul(gl::mul(t30, t30), x);
  const uint64_t t32 = gl::mul(gl::mul(t31, t31), x);
  return gl::mul(sqr_n(t31, 33), t32);
}

// 1 / (a + b phi) = (a - b phi) / (a^2 - 7 b^2)
__device__ __forceinline__ Ext ext_inv(Ext x) {
  const uint64_t d = inv(gl::sub(gl::mul(x.a, x.a), mul7(gl::mul(x.b, x.b))));
  return {gl::mul(x.a, d), gl::neg(gl::mul(x.b, d))};
}

// acc += a * b, the 128-bit product, unreduced
__device__ __forceinline__ void mac(gl::Wide3& acc, uint64_t a, uint64_t b) {
  uint64_t lo, hi;
  gl::mul_wide(a, b, lo, hi);
  acc.add(lo, hi);
}

__global__ void __launch_bounds__(kOodThreads) deep_ood_sums_kernel(
    const uint64_t* __restrict__ m, int64_t rows, int w, int64_t ld, const uint64_t* __restrict__ pts,
    const uint64_t* __restrict__ zs, int np, int log_m, int log_lift, uint64_t sm, uint64_t inv_msm,
    int tc, int rl, int64_t rows_per_block, uint64_t* __restrict__ part,
    unsigned long long* __restrict__ counters, uint64_t* __restrict__ out) {
  // the chunk's weights, [point][component][row]; reused for the row lanes' sums
  __shared__ uint64_t wts[kMaxPoints][2][kOodChunk];
  __shared__ Ext zl[kMaxPoints];
  __shared__ uint64_t zl7[kMaxPoints];  // 7 * b^2 of z_l = a + b phi
  __shared__ Ext scale[kMaxPoints];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int lane = tid % tc, rlane = tid / tc;
  const int col = blockIdx.y * tc + lane;
  const bool active = col < w;
  if (tid < np) {
    const Ext z = ext_sqr_n({zs[2 * tid], zs[2 * tid + 1]}, log_lift);
    zl[tid] = z;
    zl7[tid] = mul7(gl::mul(z.b, z.b));
  }
  __syncthreads();

  gl::Wide3 acc[kMaxPoints][2];
  const int64_t r_begin = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r_end = lmin(rows, r_begin + rows_per_block);
  for (int64_t r0 = r_begin; r0 < r_end; r0 += kOodChunk) {
    const int n = (int)lmin(kOodChunk, r_end - r0);
    for (int g = tid * kInvBatch; g < n; g += blockDim.x * kInvBatch) {
#pragma unroll
      for (int l = 0; l < kMaxPoints; ++l) {
        if (l >= np) break;
        uint64_t x[kInvBatch], a[kInvBatch], nrm[kInvBatch], pre[kInvBatch];
#pragma unroll
        for (int k = 0; k < kInvBatch; ++k) {
          x[k] = g + k < n ? pts[r0 + g + k] : 0;
          a[k] = gl::sub(zl[l].a, x[k]);
          nrm[k] = gl::sub(gl::mul(a[k], a[k]), zl7[l]);
          pre[k] = k ? gl::mul(pre[k - 1], nrm[k]) : nrm[k];
        }
        uint64_t iv = inv(pre[kInvBatch - 1]);
#pragma unroll
        for (int k = kInvBatch - 1; k >= 0; --k) {
          const uint64_t di = k ? gl::mul(iv, pre[k - 1]) : iv;  // 1 / nrm[k]
          if (k) iv = gl::mul(iv, nrm[k]);
          const uint64_t xd = gl::mul(x[k], di);
          wts[l][0][g + k] = gl::mul(xd, a[k]);
          wts[l][1][g + k] = gl::neg(gl::mul(xd, zl[l].b));
        }
      }
    }
    __syncthreads();
    if (active) {
      const uint64_t* p = m + r0 * ld + col;
#pragma unroll 4
      for (int r = rlane; r < n; r += rl) {
        const uint64_t f = __ldg(p + r * ld);
#pragma unroll
        for (int l = 0; l < kMaxPoints; ++l) {
          if (l < np) {
            mac(acc[l][0], wts[l][0][r], f);
            mac(acc[l][1], wts[l][1][r], f);
          }
        }
      }
    }
    __syncthreads();
  }

  // the row lanes' sums, then this block's column sums into `part` (G, w, 4)
  uint64_t* red = &wts[0][0][0];
  if (active) {
#pragma unroll
    for (int l = 0; l < kMaxPoints; ++l) {
      red[tid * 4 + 2 * l] = acc[l][0].value();
      red[tid * 4 + 2 * l + 1] = acc[l][1].value();
    }
  }
  __syncthreads();
  if (rlane == 0 && active) {
    for (int k = 0; k < 2 * np; ++k) {
      uint64_t s = red[lane * 4 + k];
      for (int q = 1; q < rl; ++q) s = gl::add(s, red[(q * tc + lane) * 4 + k]);
      part[((int64_t)blockIdx.x * w + col) * 4 + k] = s;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[blockIdx.y], 1ull) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last block of the column tile: the sum over the blocks, times c_l
  __threadfence();
  if (tid < np) {
    const Ext zm = ext_sqr_n(zl[tid], log_m);
    scale[tid] = {gl::mul(gl::sub(zm.a, sm), inv_msm), gl::mul(zm.b, inv_msm)};
  }
  __syncthreads();
  for (int q = tid; q < tc * np; q += blockDim.x) {
    const int c = blockIdx.y * tc + q % tc, l = q / tc;
    if (c >= w) continue;
    gl::LazySum sa, sb;
#pragma unroll 8
    for (unsigned g = 0; g < gridDim.x; ++g) {
      const uint64_t* src = part + ((int64_t)g * w + c) * 4 + 2 * l;
      sa += __ldcg((const unsigned long long*)src);
      sb += __ldcg((const unsigned long long*)src + 1);
    }
    const Ext v = ext_mul(scale[l], {sa.value(), sb.value()});
    out[((int64_t)l * w + c) * 2] = v.a;
    out[((int64_t)l * w + c) * 2 + 1] = v.b;
  }
  if (tid == 0) counters[blockIdx.y] = 0;
}

// One committed matrix of the DEEP rows: the block's row r is the matrix's
// row (off + r) & mask.
struct DeepMat {
  const uint64_t* ptr;
  int64_t ld;    // row stride, in elements
  int64_t off;
  int64_t mask;  // stored rows - 1 (a power of two)
  int w;
  int pad;  // zero columns after the matrix's own: its aligned width - w
};

struct DeepMats {
  DeepMat m[kMaxMats];
};

__global__ void __launch_bounds__(kRowsThreads) deep_rows_kernel(
    const DeepMats mats, int n_mats, int64_t rows, int log_chunks, int lift_bits,
    const uint64_t* __restrict__ pts, const uint64_t* __restrict__ zs, int np,
    const uint64_t* __restrict__ claims, int64_t width, const uint64_t* __restrict__ alpha,
    const uint64_t* __restrict__ beta, uint64_t* __restrict__ out) {
  __shared__ uint64_t tile[kRowsThreads * (kSlice + 1)];
  __shared__ Ext apow[kSlice + 1];  // alpha^0 .. alpha^kSlice
  __shared__ Ext red[kMaxPoints][kRowsThreads];
  __shared__ Ext fz[kMaxPoints];    // f_red(z_j)
  __shared__ Ext bpow[kMaxPoints];  // beta^j
  const int tid = threadIdx.x;
  if (tid <= kSlice) apow[tid] = ext_pow({alpha[0], alpha[1]}, tid);
  if (tid < kMaxPoints) bpow[tid] = ext_pow({beta[0], beta[1]}, tid);
  __syncthreads();
  // f_red(z_j) = sum_k alpha^k claims_j[W-1-k]: thread t takes the slices
  // s = t, t + 128, ... of 32 powers, slice s weighted by alpha^(32 s)
  const Ext step = ext_pow(apow[kSlice], kRowsThreads);
#pragma unroll
  for (int j = 0; j < kMaxPoints; ++j) {
    Ext sum = {0, 0};
    if (j < np) {
      Ext weight = ext_pow(apow[kSlice], tid);
      for (int64_t s = tid; s * kSlice < width; s += kRowsThreads) {
        Ext slice = {0, 0};
        for (int q = 0; q < kSlice && s * kSlice + q < width; ++q) {
          const uint64_t* c = claims + (j * width + width - 1 - (s * kSlice + q)) * 2;
          slice = ext_add(slice, ext_mul(apow[q], {c[0], c[1]}));
        }
        sum = ext_add(sum, ext_mul(weight, slice));
        weight = ext_mul(weight, step);
      }
    }
    red[j][tid] = sum;
  }
  __syncthreads();
  for (int s = kRowsThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int j = 0; j < kMaxPoints; ++j) red[j][tid] = ext_add(red[j][tid], red[j][tid + s]);
    }
    __syncthreads();
  }
  if (tid < kMaxPoints) fz[tid] = red[tid][0];
  __syncthreads();

  const int64_t n_chunks = int64_t(1) << log_chunks;
  const int64_t low = (int64_t(1) << lift_bits) - 1;
  for (int64_t b = blockIdx.x; b < n_chunks; b += gridDim.x) {
    // chunks b with the same b >> lift_bits lie rows / 2^lift_bits apart:
    // the same rows of every matrix at least that short
    const int64_t chunk = (b >> lift_bits) | ((b & low) << (log_chunks - lift_bits));
    const int64_t r0 = chunk * kRowsThreads;
    const int n = (int)lmin(kRowsThreads, rows - r0);
    Ext acc = {0, 0};
    for (int mi = 0; mi < n_mats; ++mi) {
      const DeepMat mat = mats.m[mi];
      for (int c0 = 0; c0 < mat.w; c0 += kSlice) {
        const int cw = min(kSlice, mat.w - c0);
        const int ws = cw | 1;
        __syncthreads();  // the last slice's readers are done with the tile
        {
          // element e = i * cw + k of the slice, e = tid, tid + 128, ...
          const int di = kRowsThreads / cw, dk = kRowsThreads - di * cw;
          int i = tid / cw, k = tid - i * cw;
          while (i < n) {
            const int64_t src = (mat.off + r0 + i) & mat.mask;
            tile[i * ws + k] = __ldg(mat.ptr + src * mat.ld + c0 + k);
            i += di;
            k += dk;
            if (k >= cw) {
              k -= cw;
              ++i;
            }
          }
        }
        __syncthreads();
        if (tid < n) {
          gl::Wide3 sa, sb;
          for (int k = 0; k < cw; ++k) {
            const uint64_t f = tile[tid * ws + k];
            const Ext p = apow[cw - 1 - k];
            mac(sa, p.a, f);
            mac(sb, p.b, f);
          }
          acc = ext_add(ext_mul(acc, apow[cw]), {sa.value(), sb.value()});
        }
      }
      if (mat.pad && tid < n) acc = ext_mul(acc, apow[mat.pad]);
    }
    if (tid < n) {
      const uint64_t x = pts[r0 + tid];
      Ext v = {0, 0};
#pragma unroll
      for (int j = 0; j < kMaxPoints; ++j) {
        if (j < np) {
          const Ext inv_den = ext_inv({gl::sub(zs[2 * j], x), zs[2 * j + 1]});
          Ext t = ext_mul(ext_sub(fz[j], acc), inv_den);
          if (j) t = ext_mul(t, bpow[j]);
          v = ext_add(v, t);
        }
      }
      out[(r0 + tid) * 2] = v.a;
      out[(r0 + tid) * 2 + 1] = v.b;
    }
  }
}

}  // namespace

extern "C" {

// m: (rows, w) int64 rows of stride ld; pts: (rows,) the block's coset
// points; zs: (np, 2), np <= 2; the tile (tc columns x rl row lanes,
// tc * rl <= 256, tiles = ceil(w / tc)) and the rows a block takes
// (rows_per_block, a multiple of 1024; grid_rows = ceil(rows /
// rows_per_block)) come from stark/pcs.py ood_plan. part: (grid_rows, w, 4)
// scratch; counters: (tiles,) zeros, left zero; out: (np, w, 2).
int deep_ood_sums(const void* m, long long rows, int w, long long ld, const void* pts, const void* zs,
                  int np, int log_m, int log_lift, unsigned long long sm, unsigned long long inv_msm, int tc,
                  int rl, int tiles, long long rows_per_block, int grid_rows, void* part, void* counters,
                  void* out, void* stream) {
  if (np < 1 || np > kMaxPoints || w < 1 || tc < 1 || rl < 1 || tc * rl > kOodThreads || tiles < 1 ||
      tiles > 65535 || rows_per_block % kOodChunk || grid_rows < 1)
    return (int)cudaErrorInvalidValue;
  deep_ood_sums_kernel<<<dim3((unsigned)grid_rows, (unsigned)tiles), tc * rl, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)m, rows, w, ld, (const uint64_t*)pts, (const uint64_t*)zs, np, log_m, log_lift, sm,
      inv_msm, tc, rl, rows_per_block, (uint64_t*)part, (unsigned long long*)counters, (uint64_t*)out);
  return (int)cudaGetLastError();
}

// table: n_mats rows of (pointer, ld, off, mask, w, pad), n_mats <= 64;
// rows = 2^log_rows; pts: (rows,) the block's points of the max LDE domain;
// zs: (np, 2); claims: (np, width, 2); alpha, beta: (2,); out: (rows, 2),
// the DEEP quotient.
int deep_reduce_rows(const long long* table, int n_mats, int log_rows, int lift_bits, const void* pts,
                     const void* zs, int np, const void* claims, long long width, const void* alpha,
                     const void* beta, void* out, void* stream) {
  static int sms = 0, per_sm = 0;
  if (n_mats < 0 || n_mats > kMaxMats || np < 1 || np > kMaxPoints || log_rows < 0 || lift_bits < 0)
    return (int)cudaErrorInvalidValue;
  DeepMats mats = {};
  for (int i = 0; i < n_mats; ++i) {
    const long long* t = table + 6 * i;
    mats.m[i] = {(const uint64_t*)t[0], t[1], t[2], t[3], (int)t[4], (int)t[5]};
    if (mats.m[i].pad > kSlice) return (int)cudaErrorInvalidValue;
  }
  if (per_sm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, deep_rows_kernel, kRowsThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  }
  const int log_chunks = log_rows > 7 ? log_rows - 7 : 0;  // chunks of kRowsThreads = 2^7 rows
  if (lift_bits > log_chunks) lift_bits = log_chunks;
  int64_t grid = (int64_t)per_sm * sms;
  if (grid > (int64_t(1) << log_chunks)) grid = int64_t(1) << log_chunks;
  deep_rows_kernel<<<(unsigned)grid, kRowsThreads, 0, (cudaStream_t)stream>>>(
      mats, n_mats, int64_t(1) << log_rows, log_chunks, lift_bits, (const uint64_t*)pts,
      (const uint64_t*)zs, np, (const uint64_t*)claims, width, (const uint64_t*)alpha,
      (const uint64_t*)beta, (uint64_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
