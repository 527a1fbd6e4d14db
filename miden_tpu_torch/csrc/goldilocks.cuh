// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) for the port's kernels.
//
// Elements are canonical u64 values (< p), stored in the caller's int64
// tensors bit for bit. The 128-bit product is the native 64x64 multiply:
// low half `a * b`, high half `__umul64hi(a, b)`, then the reduction
// 2^64 = 2^32 - 1 and 2^96 = -1 (mod p). Every function returns a canonical
// value, so the results equal the plain torch ops of
// miden_tpu_torch/field/goldilocks.py bit for bit.
#pragma once
#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += EPS;  // carry-out; cannot carry again since a, b < p
  if (s >= P) s -= P;
  return s;
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  if (a < b) d -= EPS;  // borrow: + p == - (2^32 - 1) mod 2^64
  return d;
}

__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  uint64_t hi_hi = hi >> 32;
  uint64_t hi_lo = hi & EPS;
  uint64_t t = lo - hi_hi;
  if (lo < hi_hi) t -= EPS;
  uint64_t t1 = hi_lo * EPS;
  uint64_t r = t + t1;
  if (r < t1) r += EPS;
  if (r >= P) r -= P;
  return r;
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

}  // namespace gl
