// row_norms: out[r] = sqrt(sum_c x[r, c]^2), f32 accumulation, f32 output.
//
// Replaces the TPU kernel src/repro/kernels/row_norms.py::row_norms, which
// tiles (block_rows, block_d) and carries partial sums across a sequential
// d-grid.  Here one warp owns one row: 16-byte loads along d, square-and-add
// in f32 registers, a shuffle reduction, one f32 store.  Nothing is carried
// between blocks and x*x is never written anywhere.
//
// Bound on an H100: bytes.  n*d*itemsize read + 4n written against
// 3.35 TB/s; two flops per element is far below any compute limit.  The
// design keeps every load a full 16 bytes on neighbouring lanes and has
// n/8 blocks in flight; ragged n and d are masked (rows past n exit, a
// d that breaks 16-byte row alignment takes the element-wise loop), so the
// caller pads nothing.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
row_norms_kernel(const T* __restrict__ x, float* __restrict__ out, int n,
                 int d, int vec) {
  constexpr int E = Chunk<T>::kElems;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= n) return;  // the whole warp leaves together
  const T* xr = x + row * (long long)d;

  float acc = 0.f;
  if (vec) {
    const int nvec = d / E;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
#pragma unroll 4
    for (int c = lane; c < nvec; c += 32) {
      uint4 raw = __ldg(xv + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float f = to_f32(e[j]);
        acc = fmaf(f, f, acc);
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float f = to_f32(xr[c]);
      acc = fmaf(f, f, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) out[row] = sqrtf(acc);
}

template <typename T>
int launch(const void* x, void* out, int n, int d, cudaStream_t stream) {
  const int vec = aligned16(x) && (d % Chunk<T>::kElems == 0);
  const unsigned blocks = (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  row_norms_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(out), n, d, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() of the launch (0 = accepted), -1 on an unknown
// dtype code.  Does not synchronise and allocates nothing.
extern "C" int repro_row_norms(const void* x, void* out, int n, int d,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32: return launch<float>(x, out, n, d, s);
    case repro::kBF16: return launch<__nv_bfloat16>(x, out, n, d, s);
    case repro::kF16: return launch<__half>(x, out, n, d, s);
    default: return -1;
  }
}
