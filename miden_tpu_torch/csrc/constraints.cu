// Q1: the bytecode constraint evaluator for Hopper (sm_90a). It runs one
// recorded constraint program (stark/interp.py ConstraintProgram: Air.eval
// as a flat base-field SSA stream of ADD / SUB / MUL over register ids,
// register-allocated into a frame) over every point of an AIR's quotient
// coset and writes the alpha-folded accumulator, an (nd, 2) extension value.
// It is not the port of a Pallas kernel: miden_tpu runs the same program as
// an XLA lax.scan over the instruction stream (miden_tpu/stark/interp.py:273
// _run_chunk), which is what its prover calls for the VM AIRs and for any
// quotient domain of 2^21 points or more (miden_tpu/stark/prover.py:176-197).
//
// Registers (ConstraintProgram's layout): ids below n_vec are per-point
// inputs, read straight from the LDE views (main, preprocessed and aux
// columns at the current row i and the next row (i + D) & (nd - 1), so no
// rolled copy exists) and from the (3 + p, nd) matrix of selectors and
// periodic columns; ids in [n_vec, n_fixed) are the point-independent
// scalars (publics, randomness, aux values, alpha, constants), kept in
// shared memory and never broadcast; ids from n_fixed on are frame slots.
//
// - One thread evaluates one point at a time, in a grid-stride loop, and
//   every thread of the grid walks the same instruction stream: the
//   instruction and its operand kinds are warp-uniform, so nothing diverges,
//   and a warp's 32 points read one slot or column at once.
// - Instructions are one u64 each (a, b, dst in 20 bits apiece, op above),
//   read through the read-only path: a warp-uniform address is one request
//   broadcast to the warp, and the stream (10,248 instructions, 82 KB for
//   the VM core) stays in L1 / L2 while the grid walks it.
// - The frame (598 slots for the VM core, 4.8 KB a point) fits neither the
//   registers nor shared memory (227 KB an SM holds the frames of ~47
//   threads). It lives in a device scratch laid out [slot][thread], sized by
//   the grid (the threads resident at once), never by nd, and allocated by
//   the wrapper through PyTorch's allocator; a warp's access to one slot is
//   256 contiguous bytes. Not local memory: its size would be fixed at
//   compile time and the CUDA runtime would reserve it for the card's every
//   resident thread outside PyTorch's accounting.
// - Arithmetic is goldilocks.cuh's gl::add / gl::sub / gl::mul: canonical
//   in, canonical out, so the output equals the plain twin bit for bit.
//
// What bounds it on the H100: for the VM core the operations bound is 5,219
// general products a point (8 32-bit multiplies each) at the card's 32-bit
// multiply rate; the frame traffic is 3 x 8 B an instruction a point
// (10,248 instructions: 246 KB a point, 515 GB over 2^21 points), against
// ~1.1 KB a point of inputs and output. The frame traffic is the larger by
// far whenever it misses the caches, and the design leaves it so: the
// linear-scan allocator reuses the most recently freed slot first (LIFO),
// so most reads hit a slot written a few instructions before, which L1
// holds; the rest go to L2. The grid is cut so that the scratch stays
// within a budget (wrapper), which also bounds the frames' L2 footprint.
#include <cuda_runtime.h>
#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kSources = 4;  // main, preprocessed, aux, selectors + periodic
constexpr uint32_t kIdMask = (1u << 20) - 1;

enum : uint32_t { OP_ADD = 0, OP_SUB = 1, OP_MUL = 2 };

// One per-point input matrix: element (point i, column c) is at
// ptr[i * point_stride + c * col_stride].
struct Sources {
  const uint64_t* ptr[kSources];
  int64_t point_stride[kSources];
  int64_t col_stride[kSources];
};

struct Frame {
  uint64_t* base;  // this thread's slot 0
  int64_t stride;  // threads in the grid
};

__device__ __forceinline__ uint64_t load(uint32_t r, uint32_t n_vec, uint32_t n_fixed,
                                         const uint32_t* s_desc, const uint64_t* s_scal,
                                         const Sources& src, int64_t row, int64_t next_row,
                                         const Frame& fr) {
  if (r < n_vec) {
    // desc: source in bits 0-1, next row in bit 2, column above
    const uint32_t d = s_desc[r];
    const uint32_t s = d & 3;
    const int64_t at = ((d >> 2) & 1 ? next_row : row) * src.point_stride[s] +
                       (int64_t)(d >> 3) * src.col_stride[s];
    return __ldg(src.ptr[s] + at);
  }
  if (r < n_fixed) return s_scal[r - n_vec];
  return fr.base[(int64_t)(r - n_fixed) * fr.stride];
}

__global__ void __launch_bounds__(kBlock)
    constraints_eval_kernel(const uint64_t* __restrict__ code, int64_t n_instr,
                            const uint32_t* __restrict__ vec_desc, uint32_t n_vec,
                            const uint64_t* __restrict__ scal, uint32_t n_fixed, Sources src,
                            uint64_t* __restrict__ frame, int64_t threads,
                            uint64_t* __restrict__ out, int64_t nd, int64_t next_offset,
                            uint32_t out0, uint32_t out1) {
  extern __shared__ uint64_t s_mem[];
  __shared__ Sources s_src;  // indexed by a run-time source id: kept out of local memory
  uint64_t* s_scal = s_mem;  // n_fixed - n_vec scalars
  uint32_t* s_desc = reinterpret_cast<uint32_t*>(s_mem + (n_fixed - n_vec));
  for (uint32_t k = threadIdx.x; k < n_fixed - n_vec; k += blockDim.x) s_scal[k] = scal[k];
  for (uint32_t k = threadIdx.x; k < n_vec; k += blockDim.x) s_desc[k] = vec_desc[k];
  if (threadIdx.x == 0) s_src = src;
  __syncthreads();

  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const Frame fr{frame + tid, threads};
  for (int64_t i = tid; i < nd; i += threads) {
    const int64_t nxt = (i + next_offset) & (nd - 1);
#pragma unroll 1
    for (int64_t k = 0; k < n_instr; ++k) {
      const uint64_t ins = __ldg(code + k);
      const uint32_t a = (uint32_t)ins & kIdMask;
      const uint32_t b = (uint32_t)(ins >> 20) & kIdMask;
      const uint32_t dst = (uint32_t)(ins >> 40) & kIdMask;
      const uint32_t op = (uint32_t)(ins >> 60);
      const uint64_t va = load(a, n_vec, n_fixed, s_desc, s_scal, s_src, i, nxt, fr);
      const uint64_t vb = load(b, n_vec, n_fixed, s_desc, s_scal, s_src, i, nxt, fr);
      uint64_t r;
      if (op == OP_MUL) {
        r = gl::mul(va, vb);
      } else if (op == OP_ADD) {
        r = gl::add(va, vb);
      } else {
        r = gl::sub(va, vb);
      }
      fr.base[(int64_t)(dst - n_fixed) * fr.stride] = r;
    }
    out[2 * i] = load(out0, n_vec, n_fixed, s_desc, s_scal, s_src, i, nxt, fr);
    out[2 * i + 1] = load(out1, n_vec, n_fixed, s_desc, s_scal, s_src, i, nxt, fr);
  }
}

size_t shared_bytes(uint32_t n_vec, uint32_t n_fixed) {
  return (size_t)(n_fixed - n_vec) * sizeof(uint64_t) + (size_t)n_vec * sizeof(uint32_t);
}

}  // namespace

// Threads of the grid when every SM holds as many blocks of this kernel as
// it can (occupancy for the given program's shared memory).
extern "C" int constraints_resident_threads(uint32_t n_vec, uint32_t n_fixed, int64_t* threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = shared_bytes(n_vec, n_fixed);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(constraints_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, constraints_eval_kernel, kBlock, smem);
  *threads = (int64_t)sms * per_sm * kBlock;
  return (int)err;
}

// code: n_instr packed instructions; vec_desc: n_vec source descriptors;
// scal: n_fixed - n_vec scalars; frame: frame_slots x threads scratch;
// out: (nd, 2). threads is a multiple of the block size; nd a power of two.
extern "C" int constraints_eval(const uint64_t* code, int64_t n_instr, const uint32_t* vec_desc,
                                uint32_t n_vec, const uint64_t* scal, uint32_t n_fixed,
                                const uint64_t* p0, const uint64_t* p1, const uint64_t* p2,
                                const uint64_t* p3, int64_t ps0, int64_t ps1, int64_t ps2, int64_t ps3,
                                int64_t cs0, int64_t cs1, int64_t cs2, int64_t cs3, uint64_t* frame,
                                int64_t threads, uint64_t* out, int64_t nd, int64_t next_offset,
                                uint32_t out0, uint32_t out1, cudaStream_t stream) {
  const Sources src{{p0, p1, p2, p3}, {ps0, ps1, ps2, ps3}, {cs0, cs1, cs2, cs3}};
  const size_t smem = shared_bytes(n_vec, n_fixed);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        constraints_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = threads / kBlock;
  constraints_eval_kernel<<<(unsigned)blocks, kBlock, smem, stream>>>(
      code, n_instr, vec_desc, n_vec, scal, n_fixed, src, frame, threads, out, nd, next_offset,
      out0, out1);
  return (int)cudaGetLastError();
}
