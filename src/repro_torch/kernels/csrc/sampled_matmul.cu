// sampled_matmul: dW[d_in, d_out] (f32) =
//     sum_b hsub[b]^T @ round_T(f32(dz[b, idx[b, :], :]) * scale[b, :, None])
//
// Replaces the TPU kernel src/repro/kernels/sampled_matmul.py::
// sampled_matmul, the even-tiled form of the sampled weight gradient that the
// reference keeps as the unfused baseline of fused_sampled_dw.  That kernel
// walks a sequential (B, k/bk) grid with one accumulator in on-chip memory
// and DMAs each k-block's dz rows by the prefetched idx into a
// double-buffered scratch; the wrapper pads H' and dZ to block multiples on
// the host (padded slots: idx 0, scale 0).  Here a block owns a tile of dW
// and loops over every (b, k-block) itself, the f32 sum in registers; per
// k-block it gathers the k-block's dz rows by idx into shared memory,
// applies the scale in f32 and rounds once to the input dtype there, then
// multiplies with f32 accumulation.  Three routes, chosen by the caller
// (kernels/sampled_matmul.py::smm_route) and passed in:
//  * wgmma (bf16/f16, d_in and d_out multiples of 8, 16-byte-aligned hsub
//    and dz): the Hopper kernel.  256 (d_in) x 128 (d_out) dW tiles, and
//    two blocks side by side along d_out form a cluster that shares one H'
//    tile: each block TMA-loads half of it with .multicast::cluster into
//    both blocks' shared memory, so H' leaves L2 once per 256 dW columns
//    and dZ' once per 256 rows (433 MB a call at the wide projections of
//    qwen2.5-3b, against 865 MB for 128 x 128 tiles).  Two consumer
//    warpgroups own 128 rows each as two m64n128k16 wgmma chains (A = H'^T
//    and B = dZ', both MN-major from shared memory; 128 f32 accumulators a
//    thread, setmaxnreg moves registers from the producer warpgroups to
//    them).  A loader warpgroup issues the H' half by TMA from a 3-D tensor
//    map (d_in, k, B), which reads the k tail and the d_in edge as zeros,
//    and gathers its own 128 dZ' columns with cp.async straight into the
//    128-byte-swizzled stage; a converter warpgroup scales them in place in
//    f32 and rounds once.  A four-stage ring of 64-slot steps; a stage is
//    refilled only when the consumers of both blocks have released it (each
//    consumer warp arrives on both blocks' `empty` barrier, one lane each,
//    through mapa).  The blocks are persistent, one cluster per pair of
//    SMs, so the ring runs on from one tile pair into the next; each tile
//    leaves through the stage its last step used and TMA stores, which
//    write dW while the next tile's products run.  Narrow dW (the k/v
//    projections) takes 64 x 64 tiles without a cluster, so every SM still
//    gets a tile.  H' and dZ are never copied: the plan's slots past k are
//    fetched as idx 0, scale 0, and the d_out edge and an odd count of
//    d_out tiles are predicated in the kernel, so the wrapper pads nothing.
//    Bound on an H100 by operations, 2*B*k*d_in*d_out against 989 TFLOP/s
//    (56 us at 2048 x 11008, B=4, k=307); what holds it at about 2.8x that
//    is the bytes each SM takes in per step (48 KB of H' and dZ' per 1,024
//    tensor-core cycles), delivered at about 5.7 TB/s summed over the SMs
//    with or without the multicast (PERF.md).
//  * wmma (bf16/f16 shapes the wgmma route does not take): nvcuda::wmma
//    16x16x16 (mma.sync), one 32-slot shared-memory buffer, the next tile's
//    global loads issued into registers before the current tile is
//    multiplied; even tiles only (the Python wrapper pads H' and dZ, as the
//    reference's does).
//  * fma (f32): a 64x64 tile of f32 FMAs, even tiles only.
// An index outside [0, n) is read as a zero row, and the prologue's check
// of every index (common.cuh: assert_rows) stops the kernel with a
// device-side assert, so such a launch reports an error and returns no
// result.
#include <mma.h>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// bf16 / f16, the wgmma route: a (kBM x kBN) dW tile a block, kCluster
// blocks along d_out sharing one H' tile, kBM/128 (at least one) consumer
// warpgroups, a loader and a converter warpgroup, a kWgStages-deep ring.
// ---------------------------------------------------------------------------
constexpr int kWgBK = 64;         // plan slots a step
constexpr int kWgStages = 4;      // ring depth
constexpr int kWgPlanAhead = 4;   // steps a plan is fetched early
// plan slots: step g's plan lands kWgPlanAhead steps before its issue and
// is read until its stage is converted, at most kWgStages steps later
constexpr int kWgPlanSlots = 16;
static_assert(kWgPlanSlots >= kWgPlanAhead + kWgStages,
              "a plan slot is rewritten only after its last read");
// registers a thread after setmaxnreg at the 512-thread wide tile: the two
// consumer warpgroups hold 128 f32 accumulators a thread.  setmaxnreg only
// moves registers within the block's allocation at launch (128 a thread,
// all 65,536 here); an increase past it never returns.
constexpr int kWideConsumerRegs = 216;
constexpr int kWideProducerRegs = 40;
static_assert(2 * 128 * kWideConsumerRegs + 2 * 128 * kWideProducerRegs ==
                  65536,
              "the four warpgroups share the register file exactly");
constexpr int kPieceBytes = 64 * 64 * 4;  // an epilogue piece of f32 dW

// A stage is H' (kBM/64 atom columns of 64 slots x 128 bytes) then dZ'
// (kBN/64 of them).  After the ring come the plan slots (kWgBK row
// indices, then kWgBK scales, each), then the barriers.  The base is
// rounded up to 1024 bytes for the swizzle.
template <int kBM, int kBN, int kCluster>
struct SmmLayout {
  static constexpr int kConsumers = kBM >= 128 ? kBM / 128 : 1;
  static constexpr int kChains = kBM / 64 / kConsumers;  // m64 row blocks
  static constexpr int kThreads = (kConsumers + 2) * 128;
  static constexpr int kAtom = kWgBK * 128;             // one atom column
  static constexpr int kRankAtoms = kBM / 64 / kCluster;  // H' a block loads
  static constexpr int kB = kAtom * (kBM / 64);         // dZ' offset
  static constexpr int kStage = kB + kAtom * (kBN / 64);
  // 16-byte dZ' chunks a producer thread moves (or converts) a step
  static constexpr int kChunks = kWgBK * kBN / 8 / 128;
  static constexpr int kPlan = kWgStages * kStage;
  static constexpr int kBars = kPlan + kWgPlanSlots * kWgBK * 8;
  static constexpr int kBytes = kBars + 3 * 8 * kWgStages + 1024;
  // one arrival per consumer warp of every block reading the stage
  static constexpr int kEmptyArrivals = 4 * kConsumers * kCluster;
  static_assert(kBM / 64 % kCluster == 0, "H' splits evenly over a cluster");
  static_assert(kBytes <= 232448, "the ring fits in shared memory");
  // the epilogue's 64 x 64 f32 pieces, one a consumer, fit in a stage
  static_assert(kConsumers * 64 * 64 * 4 <= kStage, "pieces fit a stage");
};

// A block's steps in order: k-block, then sample, then the block's unit.
struct StepCursor {
  int kb = 0, b = 0, unit = 0;
  __device__ __forceinline__ void next(int nkb, int nb) {
    if (++kb == nkb) {
      kb = 0;
      if (++b == nb) {
        b = 0;
        ++unit;
      }
    }
  }
};

// Two 16-bit values times s in f32, each rounded once back to T.
__device__ __forceinline__ uint32_t scale2(uint32_t w, float s,
                                           __nv_bfloat16) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      __uint_as_float(w << 16) * s, __uint_as_float(w & 0xffff0000u) * s);
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t scale2(uint32_t w, float s, __half) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w));
  const __half2 r = __floats2half2_rn(f.x * s, f.y * s);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// map_h covers hsub's k rows, so H' past k arrives as zeros; the plan
// slots past k are fetched as index 0, scale 0 (the reference's padding).
// A unit is one (kBM x kCluster*kBN) piece of dW, one tile per cluster
// block; units go to clusters round-robin, d_in fastest.
template <typename T, int kBM, int kBN, int kCluster>
__global__ void __launch_bounds__(SmmLayout<kBM, kBN, kCluster>::kThreads, 1)
smm_wgmma_kernel(const __grid_constant__ CUtensorMap map_h,
                 const __grid_constant__ CUtensorMap map_out,
                 const T* __restrict__ dz, const int* __restrict__ idx,
                 const float* __restrict__ scale, int nb, int k, int n,
                 int d_in, int d_out) {
  using namespace repro::hopper;
  using L = SmmLayout<kBM, kBN, kCluster>;
  constexpr int kCpr = kBN / 8;         // 16-byte chunks of a dZ' row
  constexpr int kRowStep = 128 / kCpr;  // slots between a thread's chunks
  // chunk q of a producer thread sits kRowStep * 128 bytes after chunk
  // q - 1: the swizzle phase (slot % 8) is the same for all its chunks
  static_assert(kRowStep % 8 == 0, "one swizzle phase a thread");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* landed = full + kWgStages;
  uint64_t* empty = landed + kWgStages;
  // plan slot of step g: kWgBK row indices, then kWgBK scales
  auto plan = [&](int g) {
    return reinterpret_cast<int*>(sm + L::kPlan) +
           (g % kWgPlanSlots) * 2 * kWgBK;
  };

  const int rank = kCluster > 1 ? (int)cluster_ctarank() : 0;
  const int cid = (int)blockIdx.x / kCluster;
  const int n_clusters = (int)gridDim.x / kCluster;
  const int n_m = (d_in + kBM - 1) / kBM;
  const int n_units = n_m * ((d_out + kBN * kCluster - 1) / (kBN * kCluster));
  const int my_units = (n_units - 1 - cid) / n_clusters + 1;
  const int nkb = (k + kWgBK - 1) / kWgBK;
  const int steps = nb * nkb;
  const int total = my_units * steps;
  assert_rows(idx, (long long)nb * k, n);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 128 + 1);  // every converter + the loader's tx
      mbar_init(&landed[s], 128);    // every loader's cp.async
      mbar_init(&empty[s], L::kEmptyArrivals);
    }
    fence_barrier_init();
  }
  // the peer multicasts into this block's stages and arrives on its
  // barriers only after both blocks have initialised theirs
  if constexpr (kCluster > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }

  const int role = threadIdx.x >> 7;  // warpgroup
  // the producer warpgroups' chunk of a dZ' step: column jc of slots
  // kk0 + q * kRowStep
  const int pt = threadIdx.x & 127;
  const int jc = pt % kCpr;
  const int kk0 = pt / kCpr;
  const int chunk0 =
      L::kB + (jc >> 3) * L::kAtom + swizzle128(kk0, (jc & 7) * 8);

  if (role == L::kConsumers) {
    // ---- loader: this block's half of H' by TMA, multicast to the
    // cluster; its own dZ rows by cp.async straight into the swizzled
    // stage, then an arrival on the stage's `landed` barrier once they are
    // in.  The plan of a step is fetched kWgPlanAhead steps early by the
    // loader's 128 threads (one value each) through its cp.async groups,
    // and a named barrier of the loaders makes it visible to all of them.
    if constexpr (L::kConsumers == 2) setmaxnreg_dec<kWideProducerRegs>();
    StepCursor fetch, issue;
    auto fetch_plan = [&](int g) {
      const int ks = fetch.kb * kWgBK + pt % kWgBK;
      const long long at = (long long)fetch.b * k + min(ks, k - 1);
      cp_async4(plan(g) + pt,
                pt < kWgBK ? static_cast<const void*>(idx + at)
                           : static_cast<const void*>(scale + at),
                ks < k);  // slots past k: index 0, scale 0
      fetch.next(nkb, nb);
    };
    for (int g = 0; g < kWgPlanAhead; ++g) {
      if (g < total) fetch_plan(g);
      cp_async_commit();
    }
    int unit_seen = -1, h0 = 0, col = 0;
    for (int g = 0; g < total; ++g) {
      const int st = g % kWgStages;
      if (issue.unit != unit_seen) {
        unit_seen = issue.unit;
        const int u = cid + unit_seen * n_clusters;
        h0 = (u % n_m) * kBM + rank * L::kRankAtoms * 64;
        col = ((u / n_m) * kCluster + rank) * kBN + jc * 8;
      }
      unsigned char* stage = sm + st * L::kStage;
      cp_async_wait<kWgPlanAhead - 1>();  // step g's plan has landed ...
      named_barrier(1, 128);              // ... for every loader
      const int* rows = plan(g);
      // free in both blocks: the peer's consumers arrive here too
      mbar_wait(&empty[st], ((g / kWgStages) & 1) ^ 1);
      if (pt == 0) {
        // the bytes of the whole H' tile: this half and the peer's
        mbar_arrive_expect_tx(&full[st], L::kB);
#pragma unroll
        for (int c = 0; c < L::kRankAtoms; ++c) {
          unsigned char* dst =
              stage + (rank * L::kRankAtoms + c) * L::kAtom;
          if constexpr (kCluster > 1) {
            tma_load_3d_multicast(dst, &map_h, &full[st], h0 + 64 * c,
                                  issue.kb * kWgBK, issue.b,
                                  (uint16_t)((1u << kCluster) - 1));
          } else {
            tma_load_3d(dst, &map_h, &full[st], h0 + 64 * c,
                        issue.kb * kWgBK, issue.b);
          }
        }
      }
      const T* zb = dz + (long long)issue.b * n * d_out + col;
      const bool col_ok = col < d_out;
#pragma unroll
      for (int q = 0; q < L::kChunks; ++q) {
        const int r = rows[kk0 + q * kRowStep];
        // keeps the read inside dz; assert_rows reports the index
        const bool ok = col_ok && (unsigned)r < (unsigned)n;
        cp_async16(stage + chunk0 + q * kRowStep * 128,
                   ok ? zb + (long long)r * d_out : dz, ok);
      }
      issue.next(nkb, nb);
      if (g + kWgPlanAhead < total) fetch_plan(g + kWgPlanAhead);
      cp_async_mbar_arrive(&landed[st]);
      cp_async_commit();
    }
    if constexpr (kCluster > 1) cluster_sync();
  } else if (role == L::kConsumers + 1) {
    // ---- converter: once a stage's dZ rows have landed, scale them in
    // place in f32, round once to T (packed conversions), fence the async
    // proxy and arrive on the stage's `full` barrier
    if constexpr (L::kConsumers == 2) setmaxnreg_dec<kWideProducerRegs>();
    for (int u = 0; u < total; ++u) {
      const int st = u % kWgStages;
      unsigned char* stage = sm + st * L::kStage;
      const float* scales = reinterpret_cast<const float*>(plan(u) + kWgBK);
      mbar_wait(&landed[st], (u / kWgStages) & 1);
#pragma unroll
      for (int q = 0; q < L::kChunks; ++q) {
        uint4* c =
            reinterpret_cast<uint4*>(stage + chunk0 + q * kRowStep * 128);
        const float sc = scales[kk0 + q * kRowStep];
        uint4 v = *c;
        v.x = scale2(v.x, sc, T());
        v.y = scale2(v.y, sc, T());
        v.z = scale2(v.z, sc, T());
        v.w = scale2(v.w, sc, T());
        *c = v;
      }
      fence_proxy_async();
      mbar_arrive(&full[st]);
    }
    if constexpr (kCluster > 1) cluster_sync();
  } else {
    // ---- consumers: dW rows [i0 + 64 * kChains * wg, + 64 * kChains) x
    // [j0, j0 + kBN), one m64 wgmma chain per 64 rows ----
    if constexpr (L::kConsumers == 2) setmaxnreg_inc<kWideConsumerRegs>();
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g4 = lane >> 2;
    const int t4 = lane & 3;
    const bool leader = (threadIdx.x & 127) == 0;
    // one arrival per warp on the stage's `empty` barrier of every block of
    // the cluster, lane r arriving at rank r
    auto release = [&](int st) {
      __syncwarp();
      if constexpr (kCluster > 1) {
        if (lane < kCluster) mbar_arrive_cluster(&empty[st], (uint32_t)lane);
      } else {
        if (lane == 0) mbar_arrive(&empty[st]);
      }
    };
    float acc[L::kChains][kBN / 2];
    for (int g = 0; g < total; g += steps) {
      const int u = cid + (g / steps) * n_clusters;
      const int i0 = (u % n_m) * kBM;
      const int j0 = ((u / n_m) * kCluster + rank) * kBN;
#pragma unroll
      for (int c = 0; c < L::kChains; ++c) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) acc[c][i] = 0.f;
      }
      for (int s = g; s < g + steps; ++s) {
        const int st = s % kWgStages;
        const unsigned char* stage = sm + st * L::kStage;
        mbar_wait(&full[st], (s / kWgStages) & 1);
#pragma unroll
        for (int c = 0; c < L::kChains; ++c) fence_regs(acc[c]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) {
#pragma unroll
          for (int c = 0; c < L::kChains; ++c) {
            // A = H'^T and B = dZ', both MN-major: 16 slots = 2048 bytes
            wgmma_ss<T, kBN, 1, 1>(
                acc[c],
                desc_sw128(stage + (wg * L::kChains + c) * L::kAtom +
                               kk * 2048,
                           L::kAtom, 1024),
                desc_sw128(stage + L::kB + kk * 2048, L::kAtom, 1024), 1);
          }
        }
        wgmma_commit();
        // release the stage as soon as its products are done; the unit's
        // last stage is kept for the epilogue
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < L::kChains; ++c) fence_regs(acc[c]);
        if (s + 1 < g + steps) release(st);
      }

      // Epilogue: each 64 x 64 piece of this warpgroup's rows goes into the
      // kept stage (its own H' atoms, which only it read) as two 32-column
      // boxes of the 128-byte swizzle, and out by TMA store.  The stores
      // write dW in the background while the next unit's products run;
      // the edges of dW are clipped by the tensor map.
      const int st = (g + steps - 1) % kWgStages;
      unsigned char* piece = sm + st * L::kStage + wg * kPieceBytes;
#pragma unroll
      for (int c = 0; c < L::kChains; ++c) {
#pragma unroll
        for (int h = 0; h < kBN / 64; ++h) {
          if (c + h > 0) {  // the previous piece has been read out
            if (leader) bulk_wait_read<0>();
            named_barrier(2 + wg, 128);
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int col = q * 8 + 2 * t4;  // of the piece
            const int cc = col & 31;
            const int i = 4 * (8 * h + q);   // acc[c][i + 2 * half + 0/1]
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = warp * 16 + g4 + 8 * half;
              *reinterpret_cast<float2*>(
                  piece + (col >> 5) * 8192 + r * 128 +
                  ((((cc >> 2) ^ r) & 7) << 4) + (cc & 3) * 4) =
                  make_float2(acc[c][i + 2 * half], acc[c][i + 2 * half + 1]);
            }
          }
          fence_proxy_async();
          named_barrier(2 + wg, 128);
          if (leader) {
            const int row = i0 + (wg * L::kChains + c) * 64;
            const int col = j0 + h * 64;
            tma_store_2d(&map_out, piece, col, row);
            tma_store_2d(&map_out, piece + 8192, col + 32, row);
            bulk_commit();
          }
        }
      }
      if (leader) bulk_wait_read<0>();
      named_barrier(2 + wg, 128);
      release(st);
    }
    if (leader) bulk_wait<0>();
    // no block leaves while its peer can still multicast into its shared
    // memory or arrive on its barriers
    if constexpr (kCluster > 1) cluster_sync();
  }
}

inline unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }

template <typename T, int kBM, int kBN, int kCluster>
int launch_wgmma_tile(const void* hsub, const void* dz, const void* idx,
                      const void* scale, void* out, int nb, int k, int n,
                      int d_in, int d_out, cudaStream_t stream) {
  using L = SmmLayout<kBM, kBN, kCluster>;
  auto kernel = smm_wgmma_kernel<T, kBM, kBN, kCluster>;
  CUtensorMap map_h, map_out;
  if (!hopper::make_map_3d(&map_h, hsub, d_in, k, nb, kWgBK) ||
      !hopper::make_map_2d_f32(&map_out, out, d_out, d_in, 64)) {
    return -4;
  }
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const long long units =
      (long long)cdiv(d_in, kBM) * cdiv(d_out, kBN * kCluster);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // persistent: as many clusters as the card holds at once
  int slots = 0;
  if (kCluster > 1) {
    cfg.gridDim = dim3((unsigned)(kCluster * (units < 1024 ? units : 1024)));
    e = cudaOccupancyMaxActiveClusters(&slots, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
  } else {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&slots, cudaDevAttrMultiProcessorCount, dev);
  }
  if (slots < 1) return -5;
  cfg.gridDim = dim3((unsigned)(kCluster * (units < slots ? units : slots)));
  e = cudaLaunchKernelEx(&cfg, kernel, map_h, map_out,
                         static_cast<const T*>(dz),
                         static_cast<const int*>(idx),
                         static_cast<const float*>(scale), nb, k, n, d_in,
                         d_out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgmma(const void* hsub, const void* dz, const void* idx,
                 const void* scale, void* out, int nb, int k, int n, int d_in,
                 int d_out, int tile, cudaStream_t stream) {
  // TMA needs 16-byte strides and base; dZ' rows go in 16-byte chunks
  if (d_in % 8 != 0 || d_out % 8 != 0 || !aligned16(hsub) || !aligned16(dz)) {
    return -2;
  }
  if (tile == 256) {
    return launch_wgmma_tile<T, 256, 128, 2>(hsub, dz, idx, scale, out, nb, k,
                                             n, d_in, d_out, stream);
  }
  if (tile == 64) {
    return launch_wgmma_tile<T, 64, 64, 1>(hsub, dz, idx, scale, out, nb, k,
                                           n, d_in, d_out, stream);
  }
  return -2;
}

// Routes of the C interface (kept in step with kernels/sampled_matmul.py).
enum Route : int { kRouteFma = 0, kRouteWmma = 1, kRouteWgmma = 2 };

}  // namespace

// hsub (nb, k, d_in) and dz (nb, n, d_out) of `dtype`, idx (nb, k) int32,
// scale (nb, k) f32, out (d_in, d_out) f32; all contiguous.  `route`:
//  0 fma (f32): `tile` 64; k a multiple of 16, d_in and d_out of 64.
//  1 wmma (bf16/f16): `tile` 64 or 128, the square output tile; k a
//    multiple of 32, d_in and d_out of the tile.
//  2 wgmma (bf16/f16): `tile` 256 (256 x 128 tiles in clusters of two along
//    d_out) or 64 (64 x 64 tiles, no cluster); d_in and d_out multiples of
//    8, hsub and dz 16-byte aligned, any k.
// Returns cudaGetLastError() of the launch (0 = accepted), -1 unknown
// dtype, -2 unknown tile or a route the dtype or shape does not fit, -3
// shapes that do not tile evenly, -4 a misaligned pointer, an empty shape
// or a tensor map that cuTensorMapEncodeTiled refused, -5 a cluster that
// does not fit on the card.  Does not synchronise and allocates nothing.
extern "C" int repro_sampled_matmul(const void* hsub, const void* dz,
                                    const void* idx, const void* scale,
                                    void* out, int nb, int k, int n, int d_in,
                                    int d_out, int dtype, int tile, int route,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb < 1 || k < 1 || n < 1 || d_in < 1 || d_out < 1) return -4;
  if (!aligned16(out)) return -4;
  if (dtype != repro::kF32 && dtype != repro::kBF16 && dtype != repro::kF16) {
    return -1;
  }
  if ((dtype == repro::kF32) != (route == kRouteFma)) return -2;
  const bool bf16 = dtype == repro::kBF16;
  switch (route) {
    case kRouteFma:
      if (!aligned16(hsub) || !aligned16(dz)) return -4;
      return launch_f32(hsub, dz, idx, scale, out, nb, k, n, d_in, d_out,
                        tile, s);
    case kRouteWmma:
      if (!aligned16(hsub) || !aligned16(dz)) return -4;
      return bf16 ? launch_mma<__nv_bfloat16>(hsub, dz, idx, scale, out, nb,
                                              k, n, d_in, d_out, tile, s)
                  : launch_mma<__half>(hsub, dz, idx, scale, out, nb, k, n,
                                       d_in, d_out, tile, s);
    case kRouteWgmma:
      return bf16 ? launch_wgmma<__nv_bfloat16>(hsub, dz, idx, scale, out, nb,
                                                k, n, d_in, d_out, tile, s)
                  : launch_wgmma<__half>(hsub, dz, idx, scale, out, nb, k, n,
                                         d_in, d_out, tile, s);
    default:
      return -2;
  }
}
