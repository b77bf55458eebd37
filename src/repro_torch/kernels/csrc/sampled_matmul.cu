// sampled_matmul: dW[d_in, d_out] (f32) =
//     sum_b hsub[b]^T @ round_T(f32(dz[b, idx[b, :], :]) * scale[b, :, None])
// under an even-tiling contract: k % BK, d_in % BM and d_out % BN are all 0.
//
// Replaces the TPU kernel src/repro/kernels/sampled_matmul.py::
// sampled_matmul, the even-tiled form of the sampled weight gradient that the
// reference keeps as the unfused baseline of fused_sampled_dw.  That kernel
// walks a sequential (B, k/bk) grid with one accumulator in on-chip memory
// and DMAs each k-block's dz rows by the prefetched idx into a
// double-buffered scratch; the wrapper pads H' and dZ to block multiples on
// the host (padded slots: idx 0, scale 0).  Here one block owns one
// (BM, BN) tile of dW and loops over every (b, k-block) itself, the f32 sum
// in registers; per k-block it gathers the k-block's dz rows by idx into
// shared memory, applies the scale in f32 and rounds once to the input
// dtype there, then multiplies with f32 accumulation: tensor cores
// (nvcuda::wmma, i.e. mma.sync 16x16x16) for bf16/f16, f32 FMAs for f32.
// The next tile's global loads are issued into registers before the current
// tile is multiplied.  Unlike fused_sampled_dw.cu nothing is predicated on
// a shape edge: the launcher rejects shapes that do not tile evenly (the
// Python wrapper pads, as the reference's does).  An index outside [0, n)
// is read as a zero row, and the prologue's check of every index
// (common.cuh: assert_rows) stops the kernel with a device-side assert, so
// such a launch reports an error and returns no result.
//
// Bound on an H100 (bf16): operations, 2*B*k*d_in*d_out on the unpadded k
// against 989 TFLOP/s — 56 us at 2048 x 11008, B=4, k=307 — and bytes at
// the narrow projections, as for fused_sampled_dw.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace repro;
namespace wmma = nvcuda::wmma;

constexpr int kMmaBK = 32;   // contraction slots per tile, bf16/f16
constexpr int kF32BK = 16;   // contraction slots per tile, f32
constexpr int kF32Tile = 64;
constexpr int kF32Threads = 256;

// One (b, k-block) step of both operands: thread-owned 16-byte chunks go
// global -> registers (load) and registers -> shared (store), so the two
// halves can straddle the multiply of the previous tile.  No predicate on
// any shape edge: the launcher has checked the tiling.
template <typename T, int BM, int BN, int BK, int THREADS>
struct EvenTile {
  static constexpr int E = Chunk<T>::kElems;
  static constexpr int A_CHUNKS = BK * BM / E / THREADS;
  static constexpr int B_CHUNKS = BK * BN / E / THREADS;
  static_assert(BK * BM % (E * THREADS) == 0, "A tile must split evenly");
  static_assert(BK * BN % (E * THREADS) == 0, "B tile must split evenly");

  uint4 ra[A_CHUNKS];
  uint4 rb[B_CHUNKS];
  float rs[B_CHUNKS];

  __device__ __forceinline__ void load(
      const T* __restrict__ hsub, const T* __restrict__ dz,
      const int* __restrict__ idx, const float* __restrict__ scale, int t,
      int nkb, int k, int n, int d_in, int d_out, int i0, int j0) {
    const int b = t / nkb;
    const int k0 = (t - b * nkb) * BK;
#pragma unroll
    for (int c = 0; c < A_CHUNKS; ++c) {
      const int ch = threadIdx.x + c * THREADS;
      const int kk = ch / (BM / E);
      const int ic = (ch % (BM / E)) * E;
      ra[c] = __ldg(reinterpret_cast<const uint4*>(
          hsub + ((long long)b * k + k0 + kk) * d_in + i0 + ic));
    }
#pragma unroll
    for (int c = 0; c < B_CHUNKS; ++c) {
      const int ch = threadIdx.x + c * THREADS;
      const int kk = ch / (BN / E);
      const int jc = (ch % (BN / E)) * E;
      const long long slot = (long long)b * k + k0 + kk;
      const int r = __ldg(idx + slot);
      // keeps the read inside dz; assert_rows reports the index
      const bool valid = (unsigned)r < (unsigned)n;
      rb[c] = make_uint4(0u, 0u, 0u, 0u);
      rs[c] = 0.f;
      if (valid) {
        rb[c] = __ldg(reinterpret_cast<const uint4*>(
            dz + ((long long)b * n + r) * d_out + j0 + jc));
        rs[c] = __ldg(scale + slot);
      }
    }
  }

  // As: [BK][LDA], Bs: [BK][LDB]; the scale is applied here in f32 and
  // rounded once to T.
  template <int LDA, int LDB>
  __device__ __forceinline__ void store(T* __restrict__ As,
                                        T* __restrict__ Bs) const {
#pragma unroll
    for (int c = 0; c < A_CHUNKS; ++c) {
      const int ch = threadIdx.x + c * THREADS;
      *reinterpret_cast<uint4*>(As + (ch / (BM / E)) * LDA +
                                (ch % (BM / E)) * E) = ra[c];
    }
#pragma unroll
    for (int c = 0; c < B_CHUNKS; ++c) {
      const int ch = threadIdx.x + c * THREADS;
      uint4 in = rb[c];
      uint4 o;
      const T* e = reinterpret_cast<const T*>(&in);
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < E; ++j) oe[j] = from_f32<T>(to_f32(e[j]) * rs[c]);
      *reinterpret_cast<uint4*>(Bs + (ch / (BN / E)) * LDB +
                                (ch % (BN / E)) * E) = o;
    }
  }
};

// bf16 / f16: WARPS_M x WARPS_N warps, each owning a (BM/WARPS_M) x
// (BN/WARPS_N) piece of the tile as 16x16 f32 fragments.
template <typename T, int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
sampled_matmul_mma_kernel(const T* __restrict__ hsub,
                          const T* __restrict__ dz,
                          const int* __restrict__ idx,
                          const float* __restrict__ scale,
                          float* __restrict__ out, int nb, int k, int n,
                          int d_in, int d_out) {
  constexpr int THREADS = WARPS_M * WARPS_N * 32;
  constexpr int LDA = BM + 8;  // +16 bytes a row: spreads rows over banks
  constexpr int LDB = BN + 8;
  constexpr int WM = BM / WARPS_M;
  constexpr int WN = BN / WARPS_N;
  constexpr int FM = WM / 16;
  constexpr int FN = WN / 16;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile is 16x16 fragments");

  __shared__ __align__(32) T As[kMmaBK * LDA];
  __shared__ __align__(32) T Bs[kMmaBK * LDB];

  const int warp = threadIdx.x >> 5;
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

  const int nkb = k / kMmaBK;
  const int steps = nb * nkb;
  EvenTile<T, BM, BN, kMmaBK, THREADS> tile;
  tile.load(hsub, dz, idx, scale, 0, nkb, k, n, d_in, d_out, i0, j0);

  for (int t = 0; t < steps; ++t) {
    tile.template store<LDA, LDB>(As, Bs);
    __syncthreads();
    if (t + 1 < steps) {
      tile.load(hsub, dz, idx, scale, t + 1, nkb, k, n, d_in, d_out, i0, j0);
    }
#pragma unroll
    for (int kk0 = 0; kk0 < kMmaBK; kk0 += 16) {
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

  // Even tiles: every fragment lies wholly inside dW.
#pragma unroll
  for (int m = 0; m < FM; ++m) {
#pragma unroll
    for (int nn = 0; nn < FN; ++nn) {
      const long long gi0 = i0 + wm * WM + m * 16;
      const int gj0 = j0 + wn * WN + nn * 16;
      wmma::store_matrix_sync(out + gi0 * d_out + gj0, acc[m][nn], d_out,
                              wmma::mem_row_major);
    }
  }
}

// f32: a 64x64 tile, 256 threads, 4x4 outputs a thread, plain FMAs.
__global__ void __launch_bounds__(kF32Threads)
sampled_matmul_f32_kernel(const float* __restrict__ hsub,
                          const float* __restrict__ dz,
                          const int* __restrict__ idx,
                          const float* __restrict__ scale,
                          float* __restrict__ out, int nb, int k, int n,
                          int d_in, int d_out) {
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

  const int nkb = k / kF32BK;
  const int steps = nb * nkb;
  EvenTile<float, BM, BN, kF32BK, kF32Threads> tile;
  tile.load(hsub, dz, idx, scale, 0, nkb, k, n, d_in, d_out, i0, j0);

  for (int t = 0; t < steps; ++t) {
    tile.template store<BM, BN>(As, Bs);
    __syncthreads();
    if (t + 1 < steps) {
      tile.load(hsub, dz, idx, scale, t + 1, nkb, k, n, d_in, d_out, i0, j0);
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
    const long long gi = i0 + ty * 4 + r;
    *reinterpret_cast<float4*>(out + gi * d_out + j0 + tx * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

bool tiles_evenly(int k, int d_in, int d_out, int bk, int tile) {
  return k % bk == 0 && d_in % tile == 0 && d_out % tile == 0;
}

template <typename T>
int launch_mma(const void* hsub, const void* dz, const void* idx,
               const void* scale, void* out, int nb, int k, int n, int d_in,
               int d_out, int tile, cudaStream_t stream) {
  if (!tiles_evenly(k, d_in, d_out, kMmaBK, tile)) return -3;
  const T* h = static_cast<const T*>(hsub);
  const T* z = static_cast<const T*>(dz);
  const int* ix = static_cast<const int*>(idx);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  const dim3 grid(d_in / tile, d_out / tile);
  if (tile == 128) {
    sampled_matmul_mma_kernel<T, 128, 128, 4, 2><<<grid, 256, 0, stream>>>(
        h, z, ix, sc, o, nb, k, n, d_in, d_out);
  } else if (tile == 64) {
    sampled_matmul_mma_kernel<T, 64, 64, 2, 2><<<grid, 128, 0, stream>>>(
        h, z, ix, sc, o, nb, k, n, d_in, d_out);
  } else {
    return -2;
  }
  return (int)cudaGetLastError();
}

int launch_f32(const void* hsub, const void* dz, const void* idx,
               const void* scale, void* out, int nb, int k, int n, int d_in,
               int d_out, int tile, cudaStream_t stream) {
  if (tile != kF32Tile) return -2;
  if (!tiles_evenly(k, d_in, d_out, kF32BK, tile)) return -3;
  const dim3 grid(d_in / kF32Tile, d_out / kF32Tile);
  sampled_matmul_f32_kernel<<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(hsub), static_cast<const float*>(dz),
      static_cast<const int*>(idx), static_cast<const float*>(scale),
      static_cast<float*>(out), nb, k, n, d_in, d_out);
  return (int)cudaGetLastError();
}

}  // namespace

// hsub (nb, k, d_in) and dz (nb, n, d_out) of `dtype`, idx (nb, k) int32,
// scale (nb, k) f32, out (d_in, d_out) f32; all contiguous and 16-byte
// aligned.  `tile` is the square output tile: 64 or 128 for bf16/f16 (k a
// multiple of 32), 64 for f32 (k a multiple of 16); d_in and d_out must be
// multiples of it.  Returns cudaGetLastError() of the launch (0 =
// accepted), -1 unknown dtype, -2 unknown tile, -3 shapes that do not tile
// evenly, -4 a misaligned pointer or an empty shape.  Does not synchronise
// and allocates nothing.
extern "C" int repro_sampled_matmul(const void* hsub, const void* dz,
                                    const void* idx, const void* scale,
                                    void* out, int nb, int k, int n, int d_in,
                                    int d_out, int dtype, int tile,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb < 1 || k < 1 || n < 1 || d_in < 1 || d_out < 1) return -4;
  if (!aligned16(hsub) || !aligned16(dz) || !aligned16(out)) return -4;
  switch (dtype) {
    case repro::kF32:
      return launch_f32(hsub, dz, idx, scale, out, nb, k, n, d_in, d_out,
                        tile, s);
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
