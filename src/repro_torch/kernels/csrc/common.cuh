// Shared device helpers for the repro_torch kernels: dtype codes, f32
// conversion with a single rounding, the row-index check, and the
// predicated 16-byte chunk load every tile loader is built from.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cassert>

// The row-index check below is part of the kernels' contract, not a debug
// aid, so the build must keep assert() alive.
#ifdef NDEBUG
#error "the repro_torch kernels check plan indices with assert(); build without NDEBUG"
#endif

namespace repro {

// A plan's index must name a row of the operand it gathers from.  One
// outside [0, n) stops the kernel with a device-side assert, so the next
// synchronisation raises "device-side assert triggered" (as torch's own
// CUDA gather does); the plain versions on the CPU raise from torch.gather
// on the same input.  A bad plan is reported on both devices, never turned
// into a row of zeros.
__device__ __forceinline__ void assert_row(int r, int n) {
  assert((unsigned)r < (unsigned)n && "plan index outside [0, n)");
}

// assert_row on each of `count` plan indices once, spread over all threads
// of a 2-D grid of 1-D blocks.  For the dW kernels, whose every block
// reads every index: an assert inside their unrolled tile loader made them
// 8-14 % slower at the wide projections on an H100; here it runs once per
// index, in the prologue.
__device__ __forceinline__ void assert_rows(const int* __restrict__ idx,
                                            long long count, int n) {
  const long long threads = (long long)gridDim.x * gridDim.y * blockDim.x;
  const long long first =
      ((long long)blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x +
      threadIdx.x;
  for (long long i = first; i < count; i += threads) {
    assert_row(__ldg(idx + i), n);
  }
}

// dtype codes of the C interface (kept in step with kernels/_build.py).
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Elements of T in one 16-byte chunk.
template <typename T>
struct Chunk {
  static constexpr int kElems = 16 / sizeof(T);
};

// row[col0 .. col0+E) as 16 raw bytes, ZERO where the row is not valid or
// the column lies at/after ncols.  A select, never a multiply: nothing out
// of range is read, so no garbage can reach an accumulator.  With `vec`
// (row starts 16-byte aligned and ncols % E == 0) a chunk is wholly inside
// or wholly outside and goes as one 16-byte load.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ row,
                                            int col0, int ncols,
                                            bool row_valid, bool vec) {
  constexpr int E = Chunk<T>::kElems;
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (row_valid) {
    if (vec) {
      if (col0 < ncols) {
        raw = __ldg(reinterpret_cast<const uint4*>(row + col0));
      }
    } else {
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (col0 + j < ncols) e[j] = row[col0 + j];
      }
    }
  }
  return raw;
}

}  // namespace repro
