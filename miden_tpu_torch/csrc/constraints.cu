// Q1: the bytecode constraint evaluator for Hopper (sm_90a). It runs one
// recorded constraint program (stark/interp.py ConstraintProgram: Air.eval
// as a flat base-field SSA stream of ADD / SUB / MUL) over every point of an
// AIR's quotient coset and writes the alpha-folded accumulator, an (nd, 2)
// extension value. It is not the port of a Pallas kernel: miden_tpu runs the
// same program as an XLA lax.scan over the instruction stream
// (miden_tpu/stark/interp.py:273 _run_chunk), which is what its prover calls
// for the VM AIRs and for any quotient domain of 2^21 points or more
// (miden_tpu/stark/prover.py:176-197).
//
// The kernel runs the program's SCHEDULE (stark/interp.py make_schedule),
// made once on the host: the same instructions in a depth-first order, an
// input read again soon loaded into the frame once (a LOAD: the input plus
// the constant 0), and a frame allocated anew. Each instruction is one u64
// (interp.encode): op in bits 0-1, destination kind in 2-3, operand kinds in
// 4-5 and 6-7, "operand is the previous result" in bits 8 and 9, "takes the
// general path" in bit 10, and 16-bit offsets for the destination and both
// operands in bits 16, 32 and 48. An operand lives in one of four places,
// named by its kind, so nothing is compared to find it:
//   KIND_ON      an on-chip frame slot: shared memory, [slot][point] a block,
//                so a warp's access is 256 contiguous bytes;
//   KIND_OFF     an off-chip frame slot: a device scratch [slot][resident
//                point];
//   KIND_SCALAR  the point-independent scalar block, in shared memory;
//   KIND_INPUT   an LDE or coset column, read in place: source in bits 0-1,
//                next row ((i + D) & (nd - 1)) in bit 2, column above.
// A result that only the next instruction reads stays in a register and is
// never stored (destination kind 2).
//
// - Most instructions read only the previous result, on-chip slots and
//   scalars, and store on chip or nowhere: they run one predicated path
//   with no branch but MUL against ADD / SUB. The host marks the rest
//   (off-chip or input operands, off-chip results) for the general path.
//   Branching on each field, or a switch over their combinations (which
//   compiles to a tree of branches), costs more issue than the arithmetic.
// - A persistent grid: each block walks tiles of block x K contiguous
//   points; thread t evaluates points t, t + block, ... of the tile (K of
//   them) with every decoded instruction: K independent chains.
// - A warp fetches 32 instructions at once (one coalesced 256-byte load, the
//   next 32 in flight meanwhile) and broadcasts each with __shfl_sync, the
//   next one while the current one computes; every thread walks the same
//   stream, so each path is warp-uniform.
// - Each thread's frame is its own (its points' columns of the slot rows),
//   so the loop needs no barrier.
// - Arithmetic is goldilocks.cuh's gl::add / gl::sub / gl::mul: canonical in,
//   canonical out, so the output equals the plain twin bit for bit.
//
// What bounds it on the H100: the operations bound is the general products
// (5,219 a point for the VM core, 8 32-bit multiplies each) at the card's
// 32-bit multiply rate. The kernel is far from it and bound by latency: each
// instruction waits on the one before (70 % read the previous result), so
// the time falls with the points in flight an SM, which the shared frame
// limits; fewer on-chip slots and more points win even though more of the
// frame then lives off chip (PERF.md section 6).
#include <cuda_runtime.h>
#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int kMaxBlock = 256;
constexpr int kSources = 4;  // main, preprocessed, aux, selectors + periodic
constexpr int kBatch = 32;   // instructions a warp fetches at once
constexpr uint32_t kOffMask = 0xffff;
constexpr uint32_t kAPrev = 1u << 8, kBPrev = 1u << 9;
constexpr uint32_t kRare = 1u << 10;  // the instruction takes the general path

enum : uint32_t { OP_ADD = 0, OP_SUB = 1, OP_MUL = 2 };
enum : uint32_t { KIND_ON = 0, KIND_OFF = 1, KIND_SCALAR = 2, KIND_INPUT = 3 };

// One per-point input matrix: element (point i, column c) is at
// ptr[i * point_stride + c * col_stride]. A block of a coset that lies on
// several ranks also has a halo, the points that follow the block: a next
// row i >= nd is row i - nd of the halo, at halo[(i - nd) * halo_point_stride
// + c * halo_col_stride].
struct Sources {
  const uint64_t* ptr[kSources];
  int64_t point_stride[kSources];
  int64_t col_stride[kSources];
  const uint64_t* halo[kSources];
  int64_t halo_point_stride[kSources];
  int64_t halo_col_stride[kSources];
};

// What a thread needs to find an operand of its K points.
struct Where {
  uint64_t* s_mem;       // shared memory: the scalars, then the on-chip slots
  uint32_t frame;        // index in s_mem of this thread's first point in on-chip slot 0
  uint32_t tile;         // on-chip slot stride: points of a block
  uint64_t* spill;       // this thread's first point in off-chip slot 0
  int64_t spill_stride;  // off-chip slot stride: points of the grid
  const Sources* src;
  int64_t nd;            // points of the block; a next row past it is in the halo
};

template <int K>
__device__ __forceinline__ void op_apply(uint32_t op, const uint64_t (&a)[K], const uint64_t (&b)[K],
                                         uint64_t (&r)[K]) {
  if (op == OP_MUL) {
#pragma unroll
    for (int j = 0; j < K; ++j) r[j] = gl::mul(a[j], b[j]);
  } else {
    // a + b = a - (p - b): ADD and SUB share one subtract
    const bool add = op == OP_ADD;
#pragma unroll
    for (int j = 0; j < K; ++j) r[j] = gl::sub_wrap(a[j], add ? gl::P - b[j] : b[j]);
  }
}

// The address of input (descriptor off) at a point of row `row`, next row `nxt`.
__device__ __forceinline__ const uint64_t* input_at(uint32_t off, const Where& w, int64_t row, int64_t nxt) {
  const uint32_t s = off & 3;
  const int64_t col = (int64_t)(off >> 3);
  const int64_t r = (off >> 2) & 1 ? nxt : row;
  if (r >= w.nd) return w.src->halo[s] + col * w.src->halo_col_stride[s] + (r - w.nd) * w.src->halo_point_stride[s];
  return w.src->ptr[s] + col * w.src->col_stride[s] + r * w.src->point_stride[s];
}

// Operand (kind, off) of the thread's K points, any kind.
template <int K>
__device__ __forceinline__ void fetch(uint32_t kind, uint32_t off, const Where& w, const int64_t (&row)[K],
                                      const int64_t (&nxt)[K], uint64_t (&v)[K]) {
  if (kind == KIND_ON) {
    const uint32_t at = w.frame + off * w.tile;
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = w.s_mem[at + j * blockDim.x];
  } else if (kind == KIND_SCALAR) {
    const uint64_t x = w.s_mem[off];
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = x;
  } else if (kind == KIND_OFF) {
    const uint64_t* p = w.spill + off * w.spill_stride;
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = p[j * blockDim.x];
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) v[j] = __ldg(input_at(off, w, row[j], nxt[j]));
  }
}

// The general path: any operand kinds, any destination.
template <int K>
__device__ __forceinline__ void run_generic(uint64_t ins, const Where& w, const int64_t (&row)[K],
                                         const int64_t (&nxt)[K], uint64_t (&prev)[K]) {
  const uint32_t lo = (uint32_t)ins;
  uint64_t va[K], vb[K];
#pragma unroll
  for (int j = 0; j < K; ++j) va[j] = vb[j] = prev[j];
  if (!(lo & kAPrev)) fetch<K>((lo >> 4) & 3, (uint32_t)(ins >> 32) & kOffMask, w, row, nxt, va);
  if (!(lo & kBPrev)) fetch<K>((lo >> 6) & 3, (uint32_t)(ins >> 48), w, row, nxt, vb);
  op_apply<K>(lo & 3, va, vb, prev);
  const uint32_t dkind = (lo >> 2) & 3, doff = (lo >> 16) & kOffMask;
  if (dkind == KIND_ON) {
    const uint32_t at = w.frame + doff * w.tile;
#pragma unroll
    for (int j = 0; j < K; ++j) w.s_mem[at + j * blockDim.x] = prev[j];
  } else if (dkind == KIND_OFF) {
    uint64_t* p = w.spill + doff * w.spill_stride;
#pragma unroll
    for (int j = 0; j < K; ++j) p[j * blockDim.x] = prev[j];
  }
}

// Operand of the common path: the previous result, an on-chip slot or a
// scalar, read without a branch (kind KIND_ON or KIND_SCALAR).
template <int K>
__device__ __forceinline__ void take(uint32_t lo, uint64_t ins, int kind_at, int off_at, uint32_t prev_bit,
                                     const Where& w, const uint64_t (&prev)[K], uint64_t (&v)[K]) {
  const uint32_t off = (uint32_t)(ins >> off_at) & kOffMask;
  const bool on = ((lo >> kind_at) & 3) == KIND_ON;
  const uint32_t at = on ? w.frame + off * w.tile : off;
  const uint32_t step = on ? blockDim.x : 0;
  const bool is_prev = lo & prev_bit;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    v[j] = prev[j];
    if (!is_prev) v[j] = w.s_mem[at + j * step];
  }
}

template <int K>
__global__ void __launch_bounds__(kMaxBlock)
    constraints_eval_kernel(const uint64_t* __restrict__ code, int64_t n_run, const uint64_t* __restrict__ scal,
                            uint32_t n_scal, Sources src, uint64_t* __restrict__ spill,
                            uint64_t* __restrict__ out, int64_t nd, int64_t next_offset, int64_t next_mask,
                            uint32_t out0, uint32_t out1) {
  extern __shared__ uint64_t s_mem[];
  __shared__ Sources s_src;  // indexed by a run-time source id: kept out of local memory
  for (uint32_t k = threadIdx.x; k < n_scal; k += blockDim.x) s_mem[k] = scal[k];
  if (threadIdx.x == 0) s_src = src;
  __syncthreads();

  const uint32_t tile = blockDim.x * K;
  const Where w{s_mem, n_scal + threadIdx.x, tile, spill + (int64_t)blockIdx.x * tile + threadIdx.x,
                (int64_t)gridDim.x * tile, &s_src, nd};
  const int lane = threadIdx.x & 31;
  const int64_t tiles = (nd + tile - 1) / tile;
  for (int64_t t0 = blockIdx.x; t0 < tiles; t0 += gridDim.x) {
    int64_t row[K], nxt[K];
    uint64_t prev[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      row[j] = (t0 * tile + j * blockDim.x + threadIdx.x) & (nd - 1);  // past nd: wraps, not written
      nxt[j] = (row[j] + next_offset) & next_mask;  // nd - 1: wraps; all ones: the halo past nd
      prev[j] = 0;
    }
    uint64_t batch = __ldg(code + lane);
    uint64_t ins_next = __shfl_sync(0xffffffffu, (unsigned long long)batch, 0);
    for (int64_t base = 0; base < n_run; base += kBatch) {
      const uint64_t ahead = __ldg(code + base + kBatch + lane);  // the table has one batch of padding
#pragma unroll 2
      for (int i = 0; i < kBatch; ++i) {
        const uint64_t ins = ins_next;
        // the next instruction is broadcast while this one computes
        ins_next = __shfl_sync(0xffffffffu, (unsigned long long)(i + 1 < kBatch ? batch : ahead), (i + 1) & 31);
        const uint32_t lo = (uint32_t)ins;
        if (lo & kRare) {
          run_generic<K>(ins, w, row, nxt, prev);
          continue;
        }
        uint64_t va[K], vb[K];
        take<K>(lo, ins, 4, 32, kAPrev, w, prev, va);
        take<K>(lo, ins, 6, 48, kBPrev, w, prev, vb);
        op_apply<K>(lo & 3, va, vb, prev);
        if (((lo >> 2) & 3) == KIND_ON) {
          const uint32_t at = w.frame + ((lo >> 16) & kOffMask) * tile;
#pragma unroll
          for (int j = 0; j < K; ++j) s_mem[at + j * blockDim.x] = prev[j];
        }
      }
      batch = ahead;
    }
    uint64_t o0[K], o1[K];
    fetch<K>(out0 & 3, out0 >> 2, w, row, nxt, o0);
    fetch<K>(out1 & 3, out1 >> 2, w, row, nxt, o1);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int64_t i = t0 * tile + j * blockDim.x + threadIdx.x;
      if (i < nd) {
        out[2 * i] = o0[j];
        out[2 * i + 1] = o1[j];
      }
    }
  }
}

// The kernel of K points a thread, with its dynamic shared memory allowed.
// The allowance only grows, and is set only where a launch needs more than
// any before it: a launch that a CUDA graph captures after the same launch
// ran once makes no call beside the launch.
cudaError_t kernel_for(int k, size_t smem, const void** fn) {
  static size_t allowed[3] = {48 * 1024, 48 * 1024, 48 * 1024};
  int slot = 0;
  switch (k) {
    case 1: *fn = (const void*)constraints_eval_kernel<1>; slot = 0; break;
    case 2: *fn = (const void*)constraints_eval_kernel<2>; slot = 1; break;
    case 4: *fn = (const void*)constraints_eval_kernel<4>; slot = 2; break;
    default: return cudaErrorInvalidValue;
  }
  if (smem > allowed[slot]) {
    cudaError_t err = cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed[slot] = smem;
  }
  return cudaSuccess;
}

}  // namespace

// Blocks of (k points a thread, block threads, smem bytes) an SM holds at
// once, and the SMs of the card.
extern "C" int constraints_occupancy(int k, int block, int64_t smem, int* per_sm, int* sms) {
  int dev = 0;
  *per_sm = 0;
  const void* fn = nullptr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  int max_smem = 0;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess || smem > max_smem) return (int)err;  // per_sm 0: no block fits
  err = kernel_for(k, (size_t)smem, &fn);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, block, (size_t)smem);
  return (int)err;
}

// code: n_run packed instructions plus one batch of padding; scal: n_scal
// scalars; spill: off-chip slots x blocks x block x k; out: (nd, 2). The
// shared memory holds the scalars and n_on on-chip slots of block x k
// points. nd is a power of two. next_mask: nd - 1 (next rows wrap within
// the block) or -1 (next rows past nd read the halo h0-h2).
extern "C" int constraints_eval(const uint64_t* code, int64_t n_run, const uint64_t* scal, uint32_t n_scal,
                                const uint64_t* p0, const uint64_t* p1, const uint64_t* p2,
                                const uint64_t* p3, int64_t ps0, int64_t ps1, int64_t ps2, int64_t ps3,
                                int64_t cs0, int64_t cs1, int64_t cs2, int64_t cs3, const uint64_t* h0,
                                const uint64_t* h1, const uint64_t* h2, int64_t hps0, int64_t hps1,
                                int64_t hps2, int64_t hcs0, int64_t hcs1, int64_t hcs2, uint64_t* spill,
                                uint32_t n_on, int k, int block, int blocks, uint64_t* out, int64_t nd,
                                int64_t next_offset, int64_t next_mask, uint32_t out0, uint32_t out1,
                                cudaStream_t stream) {
  Sources src{{p0, p1, p2, p3}, {ps0, ps1, ps2, ps3}, {cs0, cs1, cs2, cs3},
              {h0, h1, h2, nullptr}, {hps0, hps1, hps2, 0}, {hcs0, hcs1, hcs2, 0}};
  const size_t smem = ((size_t)n_scal + (size_t)n_on * block * k) * sizeof(uint64_t);
  const void* fn = nullptr;
  cudaError_t err = kernel_for(k, smem, &fn);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&code, &n_run, &scal, &n_scal, &src, &spill, &out, &nd, &next_offset, &next_mask, &out0, &out1};
  err = cudaLaunchKernel(fn, dim3((unsigned)blocks), dim3((unsigned)block), args, smem, stream);
  return (int)(err == cudaSuccess ? cudaGetLastError() : err);
}
