// fused_sampled_dw: dW[d_in, d_out] (f32) =
//     sum_b hsub[b]^T @ round_T(f32(dz[b, idx[b, :], :]) * scale[b, :, None])
//
// Replaces the TPU kernel
// src/repro/kernels/fused_sampling.py::fused_sampled_dw.  That kernel keeps
// one accumulator in on-chip memory across a sequential (B, k/bk) grid and
// gets idx/scale by scalar prefetch.  On Hopper nothing carries over between
// blocks, so one block owns one (BM, BN) tile of dW and loops over every
// (b, k-block) itself with the f32 sum in registers: the result is
// deterministic, needs no atomics and no second pass, and the gathered,
// scaled dZ' exists only as a shared-memory tile.
//
// Per k-block the block loads the hsub tile (contiguous along d_in) and the
// dz rows its own slice of idx names (each contiguous along d_out), applies
// scale in f32 and rounds ONCE to the input dtype on the way into shared
// memory, then multiplies with f32 accumulation: tensor cores (mma through
// nvcuda::wmma, 16x16x16) for bf16/f16, f32 FMAs for f32 inputs (TF32 would
// cost three decimal digits that the f32 callers are promised).  The next
// tile's global loads are issued into registers before the current tile is
// multiplied, which overlaps the gather with the math without a second
// shared-memory buffer.
//
// Ragged everything: the k tail and the d_in/d_out edges are predicates
// that put ZEROS into shared memory (a select, never 0 * garbage), so the
// caller pads nothing and no divisor constraint exists.  An idx outside
// [0, n) is read as a zero row too, and the prologue's check of every
// index (common.cuh: assert_rows) stops the kernel with a device-side
// assert, so such a launch reports an error and returns no result.
//
// Bound on an H100 (bf16): the larger of 2*B*k*d_in*d_out flops against
// 989 TFLOP/s and 2*(B*k*d_in + B*k*d_out) + 4*d_in*d_out bytes against
// 3.35 TB/s.  At the MLP up-projection of qwen2.5-3b (B=4, k=307,
// 2048 x 11008) that is 55 GFLOP = 56 us against 122 MB = 36 us: operations
// bind there, bytes bind at the narrow k/v projections (2048 x 256).
// This first version does not use wgmma or TMA; its measured distance from
// the bound is recorded in PERF.md.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace repro;
namespace wmma = nvcuda::wmma;

constexpr int kBK = 32;  // contraction slots per shared-memory tile (mma)

// ---------------------------------------------------------------------------
// Tile loader shared by both kernels.  A tile is kBK_ contraction slots of
// flattened step t = (b, k-block); thread-owned 16-byte chunks go global ->
// registers (load) and registers -> shared (store), so the two halves can be
// separated by the multiply of the previous tile.
// ---------------------------------------------------------------------------
template <typename T, int BM, int BN, int BK_, int THREADS>
struct TileLoader {
  static constexpr int E = Chunk<T>::kElems;
  static constexpr int A_CHUNKS = BK_ * BM / E / THREADS;
  static constexpr int B_CHUNKS = BK_ * BN / E / THREADS;
  static_assert(BK_ * BM % (E * THREADS) == 0, "A tile must split evenly");
  static_assert(BK_ * BN % (E * THREADS) == 0, "B tile must split evenly");

  uint4 ra[A_CHUNKS];
  uint4 rb[B_CHUNKS];
  float rs[B_CHUNKS];

  __device__ __forceinline__ void load(
      const T* __restrict__ hsub, const T* __restrict__ dz,
      const int* __restrict__ idx, const float* __restrict__ scale, int t,
      int nkb, int k, int n, int d_in, int d_out, int i0, int j0, int vec_a,
      int vec_b) {
    const int b = t / nkb;
    const int k0 = (t - b * nkb) * BK_;
#pragma unroll
    for (int c = 0; c < A_CHUNKS; ++c) {
      const int ch = threadIdx.x + c * THREADS;
      const int kk = ch / (BM / E);
      const int ic = (ch % (BM / E)) * E;
      const int ks = k0 + kk;
      const bool valid = ks < k;
      const T* row = hsub + ((long long)b * k + (valid ? ks : 0)) * d_in;
      ra[c] = load_chunk<T>(row, i0 + ic, d_in, valid, vec_a);
    }
#pragma unroll
    for (int c = 0; c < B_CHUNKS; ++c) {
      const int ch = threadIdx.x + c * THREADS;
      const int kk = ch / (BN / E);
      const int jc = (ch % (BN / E)) * E;
      const int ks = k0 + kk;
      bool valid = ks < k;
      int r = 0;
      float s = 0.f;
      if (valid) {
        r = __ldg(idx + (long long)b * k + ks);
        // keeps the read inside dz; assert_rows reports the index
        valid = (unsigned)r < (unsigned)n;
        if (valid) s = __ldg(scale + (long long)b * k + ks);
      }
      const T* row = dz + ((long long)b * n + (valid ? r : 0)) * d_out;
      rb[c] = load_chunk<T>(row, j0 + jc, d_out, valid, vec_b);
      rs[c] = s;
    }
  }

  // As: [BK_][LDA], Bs: [BK_][LDB].  The scale is applied here, in f32, and
  // rounded once to T.
  template <int LDA, int LDB>
  __device__ __forceinline__ void store(T* __restrict__ As,
                                        T* __restrict__ Bs) const {
#pragma unroll
    for (int c = 0; c < A_CHUNKS; ++c) {
      const int ch = threadIdx.x + c * THREADS;
      const int kk = ch / (BM / E);
      const int ic = (ch % (BM / E)) * E;
      *reinterpret_cast<uint4*>(As + kk * LDA + ic) = ra[c];
    }
#pragma unroll
    for (int c = 0; c < B_CHUNKS; ++c) {
      const int ch = threadIdx.x + c * THREADS;
      const int kk = ch / (BN / E);
      const int jc = (ch % (BN / E)) * E;
      uint4 in = rb[c];
      uint4 o;
      const T* e = reinterpret_cast<const T*>(&in);
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        oe[j] = from_f32<T>(to_f32(e[j]) * rs[c]);
      }
      *reinterpret_cast<uint4*>(Bs + kk * LDB + jc) = o;
    }
  }
};

// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores.  WARPS_M x WARPS_N warps, each owning a
// (BM/WARPS_M) x (BN/WARPS_N) piece of the tile as 16x16 f32 fragments.
// ---------------------------------------------------------------------------
template <typename T, int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
fused_dw_mma_kernel(const T* __restrict__ hsub, const T* __restrict__ dz,
                    const int* __restrict__ idx,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int nb, int k, int n, int d_in, int d_out, int vec_a,
                    int vec_b) {
  constexpr int THREADS = WARPS_M * WARPS_N * 32;
  constexpr int LDA = BM + 8;  // +16 bytes a row: spreads rows over banks
  constexpr int LDB = BN + 8;
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int FM = WM / 16;
  constexpr int FN = WN / 16;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile is 16x16 fragments");

  __shared__ __align__(32) T As[kBK * LDA];
  __shared__ __align__(32) T Bs[kBK * LDB];
  __shared__ __align__(32) float stage[WARPS_M * WARPS_N][16 * 16];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int i0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BN;
  assert_rows(idx, (long long)nb * k, n);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int m = 0; m < FM; ++m) {
#pragma unroll
    for (int nn = 0; nn < FN; ++nn) wmma::fill_fragment(acc[m][nn], 0.f);
  }

  const int nkb = (k + kBK - 1) / kBK;
  const int steps = nb * nkb;
  TileLoader<T, BM, BN, kBK, THREADS> tile;
  tile.load(hsub, dz, idx, scale, 0, nkb, k, n, d_in, d_out, i0, j0, vec_a,
            vec_b);

  for (int t = 0; t < steps; ++t) {
    tile.template store<LDA, LDB>(As, Bs);
    __syncthreads();
    if (t + 1 < steps) {
      tile.load(hsub, dz, idx, scale, t + 1, nkb, k, n, d_in, d_out, i0, j0,
                vec_a, vec_b);
    }
#pragma unroll
    for (int kk0 = 0; kk0 < kBK; kk0 += 16) {
      // A = hsub^T: element (i, kk) sits at As[kk][i] -> col_major, ld LDA.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf[FN];
#pragma unroll
      for (int m = 0; m < FM; ++m) {
        wmma::load_matrix_sync(a[m], As + kk0 * LDA + wm * WM + m * 16, LDA);
      }
#pragma unroll
      for (int nn = 0; nn < FN; ++nn) {
        wmma::load_matrix_sync(bf[nn], Bs + kk0 * LDB + wn * WN + nn * 16,
                               LDB);
      }
#pragma unroll
      for (int m = 0; m < FM; ++m) {
#pragma unroll
        for (int nn = 0; nn < FN; ++nn) {
          wmma::mma_sync(acc[m][nn], a[m], bf[nn], acc[m][nn]);
        }
      }
    }
    __syncthreads();
  }

  // Epilogue through a per-warp staging tile so the d_in/d_out edges can be
  // masked element by element.
  float* st = stage[warp];
#pragma unroll
  for (int m = 0; m < FM; ++m) {
#pragma unroll
    for (int nn = 0; nn < FN; ++nn) {
      wmma::store_matrix_sync(st, acc[m][nn], 16, wmma::mem_row_major);
      __syncwarp();
      const int gi0 = i0 + wm * WM + m * 16;
      const int gj0 = j0 + wn * WN + nn * 16;
      for (int e = lane; e < 256; e += 32) {
        const int gi = gi0 + (e >> 4);
        const int gj = gj0 + (e & 15);
        if (gi < d_in && gj < d_out) out[(long long)gi * d_out + gj] = st[e];
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// f32: a 64x64 tile, 256 threads, 4x4 outputs a thread, plain FMAs.
// ---------------------------------------------------------------------------
constexpr int kF32Tile = 64;
constexpr int kF32BK = 16;
constexpr int kF32Threads = 256;

__global__ void __launch_bounds__(kF32Threads)
fused_dw_f32_kernel(const float* __restrict__ hsub,
                    const float* __restrict__ dz, const int* __restrict__ idx,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int nb, int k, int n, int d_in, int d_out, int vec_a,
                    int vec_b) {
  constexpr int BM = kF32Tile, BN = kF32Tile;
  __shared__ __align__(16) float As[kF32BK * BM];
  __shared__ __align__(16) float Bs[kF32BK * BN];

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int i0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BN;
  assert_rows(idx, (long long)nb * k, n);

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }

  const int nkb = (k + kF32BK - 1) / kF32BK;
  const int steps = nb * nkb;
  TileLoader<float, BM, BN, kF32BK, kF32Threads> tile;
  tile.load(hsub, dz, idx, scale, 0, nkb, k, n, d_in, d_out, i0, j0, vec_a,
            vec_b);

  for (int t = 0; t < steps; ++t) {
    tile.template store<BM, BN>(As, Bs);
    __syncthreads();
    if (t + 1 < steps) {
      tile.load(hsub, dz, idx, scale, t + 1, nkb, k, n, d_in, d_out, i0, j0,
                vec_a, vec_b);
    }
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(As + kk * BM + ty * 4);
      const float4 b4 = *reinterpret_cast<const float4*>(Bs + kk * BN + tx * 4);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gi = i0 + ty * 4 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gj = j0 + tx * 4 + c;
      if (gi < d_in && gj < d_out) out[(long long)gi * d_out + gj] = acc[r][c];
    }
  }
}

inline unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }

template <typename T>
int launch_mma(const void* hsub, const void* dz, const void* idx,
               const void* scale, void* out, int nb, int k, int n, int d_in,
               int d_out, int tile, cudaStream_t stream) {
  const int vec_a = aligned16(hsub) && (d_in % Chunk<T>::kElems == 0);
  const int vec_b = aligned16(dz) && (d_out % Chunk<T>::kElems == 0);
  if (tile == 0) {
    // 128x128 tiles reuse each loaded element twice as often, but a narrow
    // dW (the k/v projections) would leave most SMs without a tile.
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    tile = (cdiv(d_in, 128) * cdiv(d_out, 128) >= (unsigned)sms) ? 128 : 64;
  }
  const T* h = static_cast<const T*>(hsub);
  const T* z = static_cast<const T*>(dz);
  const int* ix = static_cast<const int*>(idx);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  if (tile == 128) {
    dim3 grid(cdiv(d_in, 128), cdiv(d_out, 128));
    fused_dw_mma_kernel<T, 128, 128, 4, 2><<<grid, 256, 0, stream>>>(
        h, z, ix, sc, o, nb, k, n, d_in, d_out, vec_a, vec_b);
  } else if (tile == 64) {
    dim3 grid(cdiv(d_in, 64), cdiv(d_out, 64));
    fused_dw_mma_kernel<T, 64, 64, 2, 2><<<grid, 128, 0, stream>>>(
        h, z, ix, sc, o, nb, k, n, d_in, d_out, vec_a, vec_b);
  } else {
    return -2;
  }
  return (int)cudaGetLastError();
}

int launch_f32(const void* hsub, const void* dz, const void* idx,
               const void* scale, void* out, int nb, int k, int n, int d_in,
               int d_out, cudaStream_t stream) {
  const int vec_a = aligned16(hsub) && (d_in % 4 == 0);
  const int vec_b = aligned16(dz) && (d_out % 4 == 0);
  dim3 grid(cdiv(d_in, kF32Tile), cdiv(d_out, kF32Tile));
  fused_dw_f32_kernel<<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(hsub), static_cast<const float*>(dz),
      static_cast<const int*>(idx), static_cast<const float*>(scale),
      static_cast<float*>(out), nb, k, n, d_in, d_out, vec_a, vec_b);
  return (int)cudaGetLastError();
}

}  // namespace

// hsub (nb, k, d_in) and dz (nb, n, d_out) of `dtype`, idx (nb, k) int32,
// scale (nb, k) f32, out (d_in, d_out) f32; all contiguous.  `tile`: 0 lets
// the shape decide, 64 or 128 pins the bf16/f16 output tile (f32 inputs
// always take the 64x64 FMA kernel).  Returns cudaGetLastError() of the
// launch (0 = accepted), -1 unknown dtype, -2 unknown tile.  Does not
// synchronise and allocates nothing.
extern "C" int repro_fused_sampled_dw(const void* hsub, const void* dz,
                                      const void* idx, const void* scale,
                                      void* out, int nb, int k, int n,
                                      int d_in, int d_out, int dtype, int tile,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile != 0 && tile != 64 && tile != 128) return -2;
  switch (dtype) {
    case repro::kF32:
      return launch_f32(hsub, dz, idx, scale, out, nb, k, n, d_in, d_out, s);
    case repro::kBF16:
      return launch_mma<__nv_bfloat16>(hsub, dz, idx, scale, out, nb, k, n,
                                       d_in, d_out, tile, s);
    case repro::kF16:
      return launch_mma<__half>(hsub, dz, idx, scale, out, nb, k, n, d_in,
                                d_out, tile, s);
    default:
      return -1;
  }
}
