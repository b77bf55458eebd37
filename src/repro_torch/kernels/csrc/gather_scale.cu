// gather_scale: out[b, t, :] = round_T(f32(x[b, idx[b, t], :]) * scale[b, t])
//
// Replaces the TPU kernel src/repro/kernels/gather_scale.py::gather_scale,
// which prefetches idx into scalar memory and lets each grid step's block
// index map pick its source row, one (1, block_d) DMA per step, with d
// padded to a multiple of block_d by the wrapper.  On Hopper one warp owns
// one output row: its lane 0 reads the row's index and scale, the warp
// copies the source row with 16-byte loads and stores on neighbouring
// lanes, multiplying in f32 and rounding once to the input dtype on the
// way.  Rows whose width breaks 16-byte alignment (a ragged d) take an
// element-wise loop, so nothing is padded.  An index outside [0, n) stops
// the kernel with a device-side assert (common.cuh: assert_row).
//
// Bound on an H100: bytes.  The distinct source rows are read once and the
// B*k output rows written once (2*B*k*d*itemsize at most, plus 8*B*k for
// idx and scale) against 3.35 TB/s; one multiply per element is nothing.
// At the train path's H' gather (B=4, k=307, bf16) that is 3.0 us at
// d=2048 and 16.1 us at d=11008.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_scale_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                    const float* __restrict__ scale, T* __restrict__ out,
                    int nb, int n, int k, int d, int vec) {
  constexpr int E = Chunk<T>::kElems;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= (long long)nb * k) return;  // the whole warp leaves together
  const long long b = row / k;
  int r = 0;
  float s = 0.f;
  if (lane == 0) {
    r = __ldg(idx + row);
    s = __ldg(scale + row);
  }
  r = __shfl_sync(0xffffffffu, r, 0);
  s = __shfl_sync(0xffffffffu, s, 0);
  assert_row(r, n);
  const T* src = x + (b * n + r) * (long long)d;
  T* dst = out + row * (long long)d;

  if (vec) {
    const int nvec = d / E;
    const uint4* sv = reinterpret_cast<const uint4*>(src);
    uint4* dv = reinterpret_cast<uint4*>(dst);
#pragma unroll 4
    for (int c = lane; c < nvec; c += 32) {
      const uint4 raw = __ldg(sv + c);
      uint4 o;
      const T* e = reinterpret_cast<const T*>(&raw);
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < E; ++j) oe[j] = from_f32<T>(to_f32(e[j]) * s);
      dv[c] = o;
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      dst[c] = from_f32<T>(to_f32(src[c]) * s);
    }
  }
}

template <typename T>
int launch(const void* x, const void* idx, const void* scale, void* out,
           int nb, int n, int k, int d, cudaStream_t stream) {
  const int vec = aligned16(x) && aligned16(out) &&
                  (d % Chunk<T>::kElems == 0);
  const long long rows = (long long)nb * k;
  const unsigned blocks =
      (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  gather_scale_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(idx),
      static_cast<const float*>(scale), static_cast<T*>(out), nb, n, k, d,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x (nb, n, d) of `dtype`, idx (nb, k) int32, scale (nb, k) f32, out
// (nb, k, d) of `dtype`; all contiguous.  Returns cudaGetLastError() of the
// launch (0 = accepted), -1 on an unknown dtype code, -2 on an empty shape.
// Does not synchronise and allocates nothing.
extern "C" int repro_gather_scale(const void* x, const void* idx,
                                  const void* scale, void* out, int nb, int n,
                                  int k, int d, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb < 1 || n < 1 || k < 1 || d < 1) return -2;
  switch (dtype) {
    case repro::kF32:
      return launch<float>(x, idx, scale, out, nb, n, k, d, s);
    case repro::kBF16:
      return launch<__nv_bfloat16>(x, idx, scale, out, nb, n, k, d, s);
    case repro::kF16:
      return launch<__half>(x, idx, scale, out, nb, n, k, d, s);
    default:
      return -1;
  }
}
