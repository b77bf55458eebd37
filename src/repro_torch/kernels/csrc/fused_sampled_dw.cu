// fused_sampled_dw: dW[e, d_in, d_out] (f32) =
//     sum_b hsub[e, b]^T @ round_T(f32(dz[e, b, idx[e, b, :], :])
//                                   * scale[e, b, :, None])
// for every expert e of ne (ne = 1: the plain sampled dW of one weight).
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
// scale in f32 and rounds ONCE to the input dtype in shared memory, then
// multiplies with f32 accumulation.  Three routes, chosen by the caller
// (kernels/fused_sampling.py::dw_route) and passed in; a route the shape
// does not fit returns -2:
//  * wgmma (bf16/f16, d_in and d_out multiples of 8, 16-byte-aligned hsub
//    and dz): the Hopper kernel.  kTile/64 consumer warpgroups own 64 rows
//    each of a kTile x kTile dW tile (kTile 128 or 64); a loader and a
//    converter warpgroup fill a four-stage shared-memory ring of 64-slot
//    steps.  The blocks are persistent (one an SM, tiles round-robin), so
//    the ring runs on from one tile into the next and the next tile's
//    loads overlap this tile's epilogue.  The loader brings the H' tile by
//    TMA from a 3-D tensor map (d_in, k, B), so the k tail and the d_in
//    edge arrive as zeros.  TMA cannot gather rows, so it copies the named
//    dz rows' 16-byte chunks with cp.async straight into the
//    128-byte-swizzled stage and has their landing signalled on the
//    stage's `landed` barrier; it fetches each step's plan (row indices,
//    scales) once per block, four steps ahead, into a shared plan slot.
//    The converter scales the landed chunks in place in f32, rounds them
//    once (packed bf16x2/f16x2 conversions), fences the async proxy and
//    arrives on the stage's `full` barrier.  The consumers run wgmma with
//    A = H'^T and B = dZ', both MN-major from shared memory, keep the sum
//    in registers, release each stage as soon as its products are done,
//    and write the f32 tile with 16-byte stores.  The tensor map is
//    encoded on the host at each call (a few microseconds).  On an H100
//    this route is bound by L2-to-SM traffic: every column tile reads all
//    of H' and every row tile all of dZ' (PERF.md).
//  * wmma (bf16/f16 shapes the wgmma route does not take): nvcuda::wmma
//    16x16x16, one 32-slot shared-memory buffer, the next tile's global
//    loads issued into registers before the current tile is multiplied.
//  * fma (f32): f32 FMAs (TF32 would cost three decimal digits that the
//    f32 callers are promised).
//
// The expert axis is the counterpart of the reference's jax.vmap over its
// experts' sampled linears (src/repro/models/mlp.py::_expert_ffn), under
// which the Pallas kernel becomes one batched pallas_call with the expert
// as an extra grid axis.  Here the wgmma route's persistent blocks walk
// (expert, tile) pairs, expert-major, and the wmma and fma routes put the
// expert on blockIdx.z; each expert's dW tile sums that expert's B samples
// in the same order as an ne = 1 call, so ne = 1 is that call bit for bit.
// One launch serves all of a layer's experts: at granite-moe-1b-a400m's 32
// experts of 1024 x 512 one expert fills only 32 of 132 SMs.
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
// The measured distance of each route from the bound is in PERF.md.
#include <mma.h>

#include "hopper.cuh"

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
// bf16 / f16, the wmma route.  WARPS_M x WARPS_N warps, each owning a
// (BM/WARPS_M) x (BN/WARPS_N) piece of the tile as 16x16 f32 fragments.
// ---------------------------------------------------------------------------
template <typename T, int BM, int BN, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
fused_dw_mma_kernel(const T* __restrict__ hsub, const T* __restrict__ dz,
                    const int* __restrict__ idx,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int nb, int k, int n, int d_in, int d_out, int vec_a,
                    int vec_b) {
  // expert blockIdx.z: its samples, plan and dW
  const long long e = blockIdx.z;
  hsub += e * nb * k * d_in;
  dz += e * nb * n * d_out;
  idx += e * nb * k;
  scale += e * nb * k;
  out += e * d_in * d_out;
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
// bf16 / f16, the wgmma route: a (kTile x kTile) dW tile, kTile/64 consumer
// warpgroups of 64 rows and one producer warpgroup, a kWgStages-deep ring.
// ---------------------------------------------------------------------------
constexpr int kWgBK = 64;                // contraction slots a step
constexpr int kWgStages = 4;             // ring depth
constexpr int kWgPlanAhead = 4;          // steps a plan is fetched early
// plan slots: step g's plan lands kWgPlanAhead steps before its issue and
// is read until its stage is converted, at most kWgStages steps later
constexpr int kWgPlanSlots = 16;
static_assert(kWgPlanSlots >= kWgPlanAhead + kWgStages,
              "a plan slot is rewritten only after its last read");

// A stage is H' (kTile/64 atom columns of 64 slots x 128 bytes) then dZ'
// (the same).  After the ring come the plan slots (kWgBK row indices, then
// kWgBK scales, each), then the barriers.  The base is rounded up to 1024
// bytes for the swizzle.
template <int kTile>
struct DwLayout {
  static constexpr int kConsumers = kTile / 64;
  static constexpr int kThreads = (kConsumers + 2) * 128;
  static constexpr int kAtom = kWgBK * 128;           // one atom column
  static constexpr int kB = kAtom * (kTile / 64);     // dZ' offset = H' bytes
  static constexpr int kStage = 2 * kB;
  // 16-byte dZ' chunks a producer thread moves (or converts) a step
  static constexpr int kChunks = kWgBK * kTile / 8 / 128;
  static constexpr int kPlan = kWgStages * kStage;
  static constexpr int kBars = kPlan + kWgPlanSlots * kWgBK * 8;
  static constexpr int kBytes = kBars + 3 * 8 * kWgStages + 1024;
};

// A block's steps in order: k-block, then sample, then the block's tile.
struct StepCursor {
  int kb = 0, b = 0, tile = 0;
  __device__ __forceinline__ void next(int nkb, int nb) {
    if (++kb == nkb) {
      kb = 0;
      if (++b == nb) {
        b = 0;
        ++tile;
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

// kExperts: ne > 1.  The one-weight instance (ne = 1) compiles the expert
// arithmetic away: the loader is this route's bottleneck, and an expert
// lookup on its path cost the plain sampled dW 1-5 % (PERF.md).
template <typename T, int kTile, bool kExperts>
__global__ void __launch_bounds__(DwLayout<kTile>::kThreads, 1)
fused_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_h,
                      const T* __restrict__ dz, const int* __restrict__ idx,
                      const float* __restrict__ scale,
                      float* __restrict__ out, int ne, int nb, int k, int n,
                      int d_in, int d_out) {
  using namespace repro::hopper;
  using L = DwLayout<kTile>;
  constexpr int kCpr = kTile / 8;          // 16-byte chunks of a dZ' row
  constexpr int kRowStep = 128 / kCpr;     // slots between a thread's chunks
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

  // A persistent block: (expert, tile) pairs blockIdx.x, + gridDim.x, ...
  // (expert-major, d_in tiles fastest, so the blocks running together
  // share dZ' columns in L2), all through one ring, so the next tile's
  // loads overlap this one's epilogue.  g counts the block's steps over all
  // its tiles; the samples of expert e are e * nb ... e * nb + nb - 1.
  const int n_m = (d_in + kTile - 1) / kTile;
  const int per_expert = n_m * ((d_out + kTile - 1) / kTile);
  const int n_tiles = ne * per_expert;
  const int my_tiles = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int nkb = (k + kWgBK - 1) / kWgBK;
  const int steps = nb * nkb;
  const int total = my_tiles * steps;
  // the expert and the tile within it of the block's local tile t
  auto expert_of = [&](int t) -> int {
    if constexpr (kExperts) {
      return ((int)blockIdx.x + t * (int)gridDim.x) / per_expert;
    } else {
      return 0;
    }
  };
  auto tile_of = [&](int t) -> int {
    if constexpr (kExperts) {
      return ((int)blockIdx.x + t * (int)gridDim.x) % per_expert;
    } else {
      return (int)blockIdx.x + t * (int)gridDim.x;
    }
  };
  assert_rows(idx, (long long)ne * nb * k, n);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 128 + 1);    // every converter + the TMA's tx
      mbar_init(&landed[s], 128);      // every loader's cp.async
      mbar_init(&empty[s], 4 * L::kConsumers);  // one per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int role = threadIdx.x >> 7;  // warpgroup
  // the producer warpgroups' chunk of a dZ' step: column jc of slots
  // kk0 + q * kRowStep
  const int pt = threadIdx.x & 127;
  const int jc = pt % kCpr;
  const int kk0 = pt / kCpr;
  const int chunk0 =
      L::kB + (jc >> 3) * L::kAtom + swizzle128(kk0, (jc & 7) * 8);

  if (role == L::kConsumers) {
    // ---- loader: H' by TMA, the named dZ rows by cp.async straight into
    // the swizzled stage, then an arrival on the stage's `landed` barrier
    // once they are in.  The plan (row indices, scales) of a step is
    // fetched kWgPlanAhead steps early by the loader's 128 threads (one
    // value each) through its cp.async groups, and a named barrier of the
    // loaders makes it visible to all of them.  The loader waits on nothing
    // but a free stage and a plan fetched steps ago.
    StepCursor fetch, issue;
    // the fetched tile's expert's first plan entry, found once a tile: a
    // division on every step would sit on the loader's critical path
    int fetch_tile = -1;
    long long fetch_base = 0;
    auto fetch_plan = [&](int g) {
      if (kExperts && fetch.tile != fetch_tile) {
        fetch_tile = fetch.tile;
        fetch_base = (long long)expert_of(fetch_tile) * nb * k;
      }
      const int kk = pt % kWgBK;
      const int ks = fetch.kb * kWgBK + kk;
      const long long at = fetch_base + (long long)fetch.b * k +
                           min(ks, k - 1);
      cp_async4(plan(g) + pt,
                pt < kWgBK ? static_cast<const void*>(idx + at)
                           : static_cast<const void*>(scale + at),
                ks < k);  // slots past k: index and scale 0
      fetch.next(nkb, nb);
    };
    for (int g = 0; g < kWgPlanAhead; ++g) {
      if (g < total) fetch_plan(g);
      cp_async_commit();
    }
    int tile_seen = -1, i0 = 0, col = 0, sb = 0;
    for (int g = 0; g < total; ++g) {
      const int st = g % kWgStages;
      if (issue.tile != tile_seen) {
        tile_seen = issue.tile;
        const int tile = tile_of(tile_seen);
        i0 = (tile % n_m) * kTile;
        col = (tile / n_m) * kTile + jc * 8;
        sb = expert_of(tile_seen) * nb;
      }
      unsigned char* stage = sm + st * L::kStage;
      cp_async_wait<kWgPlanAhead - 1>();  // step g's plan has landed ...
      named_barrier(1, 128);              // ... for every loader
      const int* rows = plan(g);
      mbar_wait(&empty[st], ((g / kWgStages) & 1) ^ 1);
      if (pt == 0) {
        mbar_arrive_expect_tx(&full[st], L::kB);
#pragma unroll
        for (int c = 0; c < kTile / 64; ++c) {
          tma_load_3d(stage + c * L::kAtom, &map_h, &full[st], i0 + 64 * c,
                      issue.kb * kWgBK, sb + issue.b);
        }
      }
      const int ks0 = issue.kb * kWgBK + kk0;
      const T* zb = dz + (long long)(sb + issue.b) * n * d_out + col;
      const bool col_ok = col < d_out;
#pragma unroll
      for (int q = 0; q < L::kChunks; ++q) {
        const int ks = ks0 + q * kRowStep;
        const int r = rows[kk0 + q * kRowStep];
        // keeps the read inside dz; assert_rows reports the index
        const bool ok = col_ok && ks < k && (unsigned)r < (unsigned)n;
        cp_async16(stage + chunk0 + q * kRowStep * 128,
                   ok ? zb + (long long)r * d_out : dz, ok);
      }
      issue.next(nkb, nb);
      if (g + kWgPlanAhead < total) fetch_plan(g + kWgPlanAhead);
      cp_async_mbar_arrive(&landed[st]);
      cp_async_commit();
    }
  } else if (role == L::kConsumers + 1) {
    // ---- converter: once a stage's dZ rows have landed, scale them in
    // place in f32, round once to T (packed conversions), fence the async
    // proxy and arrive on the stage's `full` barrier
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
  } else {
    // ---- consumers: dW rows [i0 + 64 wg, +64) x [j0, j0 + kTile) ----
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g4 = lane >> 2;
    const int t4 = lane & 3;
    const bool odd = t4 & 1;
    float acc[kTile / 2];
    for (int g = 0; g < total; g += steps) {
      const int tile = tile_of(g / steps);
      const int i0 = (tile % n_m) * kTile;
      const int j0 = (tile / n_m) * kTile;
      float* eout = out + (long long)expert_of(g / steps) * d_in * d_out;
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) acc[i] = 0.f;
      for (int u = g; u < g + steps; ++u) {
        const int st = u % kWgStages;
        const unsigned char* stage = sm + st * L::kStage;
        mbar_wait(&full[st], (u / kWgStages) & 1);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) {
          // A = H'^T and B = dZ', both MN-major: 16 slots = 2048 bytes
          wgmma_ss<T, kTile, 1, 1>(
              acc,
              desc_sw128(stage + wg * L::kAtom + kk * 2048, L::kAtom, 1024),
              desc_sw128(stage + L::kB + kk * 2048, L::kAtom, 1024), 1);
        }
        wgmma_commit();
        // release the stage as soon as its products are done, so the
        // producer never waits on a round trip through this warpgroup
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
      }

      // 16-byte stores: each lane pair swaps halves so the even lane
      // writes four columns of row g4 and the odd lane four of row g4 + 8
      const int row = i0 + wg * 64 + warp * 16 + g4 + (odd ? 8 : 0);
#pragma unroll
      for (int nb8 = 0; nb8 < kTile / 8; ++nb8) {
        const float a0 = acc[4 * nb8], a1 = acc[4 * nb8 + 1];
        const float a2 = acc[4 * nb8 + 2], a3 = acc[4 * nb8 + 3];
        const float y0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : a2, 1);
        const float y1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : a3, 1);
        const int c = j0 + nb8 * 8 + 2 * (t4 & 2);
        if (row < d_in && c < d_out) {
          *reinterpret_cast<float4*>(eout + (long long)row * d_out + c) =
              odd ? make_float4(y0, y1, a2, a3) : make_float4(a0, a1, y0, y1);
        }
      }
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
  // expert blockIdx.z: its samples, plan and dW
  const long long e = blockIdx.z;
  hsub += e * nb * k * d_in;
  dz += e * nb * n * d_out;
  idx += e * nb * k;
  scale += e * nb * k;
  out += e * d_in * d_out;
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

// tile 0 lets the shape decide: 128x128 tiles reuse each loaded element
// twice as often as 64x64, but a narrow dW (the k/v projections) would
// leave most SMs without a tile.  The experts' tiles all count.
int pick_tile(int tile, int ne, int d_in, int d_out) {
  if (tile != 0) return tile;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return ((long long)ne * cdiv(d_in, 128) * cdiv(d_out, 128) >= sms) ? 128
                                                                     : 64;
}

template <typename T>
int launch_mma(const void* hsub, const void* dz, const void* idx,
               const void* scale, void* out, int ne, int nb, int k, int n,
               int d_in, int d_out, int tile, cudaStream_t stream) {
  // an expert's operands start a whole number of rows after the first's,
  // so they keep its 16-byte alignment when the rows are whole chunks
  const int vec_a = aligned16(hsub) && (d_in % Chunk<T>::kElems == 0);
  const int vec_b = aligned16(dz) && (d_out % Chunk<T>::kElems == 0);
  tile = pick_tile(tile, ne, d_in, d_out);
  const T* h = static_cast<const T*>(hsub);
  const T* z = static_cast<const T*>(dz);
  const int* ix = static_cast<const int*>(idx);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  if (tile == 128) {
    dim3 grid(cdiv(d_in, 128), cdiv(d_out, 128), ne);
    fused_dw_mma_kernel<T, 128, 128, 4, 2><<<grid, 256, 0, stream>>>(
        h, z, ix, sc, o, nb, k, n, d_in, d_out, vec_a, vec_b);
  } else {
    dim3 grid(cdiv(d_in, 64), cdiv(d_out, 64), ne);
    fused_dw_mma_kernel<T, 64, 64, 2, 2><<<grid, 128, 0, stream>>>(
        h, z, ix, sc, o, nb, k, n, d_in, d_out, vec_a, vec_b);
  }
  return (int)cudaGetLastError();
}

template <typename T, int kTile, bool kExperts>
int launch_wgmma_tile(const void* hsub, const void* dz, const void* idx,
                      const void* scale, void* out, int ne, int nb, int k,
                      int n, int d_in, int d_out, cudaStream_t stream) {
  using L = DwLayout<kTile>;
  CUtensorMap map_h;  // every expert's samples along the third axis
  if (!hopper::make_map_3d(&map_h, hsub, d_in, k, (uint64_t)ne * nb, kWgBK)) {
    return -4;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      fused_dw_wgmma_kernel<T, kTile, kExperts>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles =
      (long long)ne * cdiv(d_in, kTile) * cdiv(d_out, kTile);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  fused_dw_wgmma_kernel<T, kTile, kExperts>
      <<<grid, L::kThreads, L::kBytes, stream>>>(
      map_h, static_cast<const T*>(dz), static_cast<const int*>(idx),
      static_cast<const float*>(scale), static_cast<float*>(out), ne, nb, k,
      n, d_in, d_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgmma(const void* hsub, const void* dz, const void* idx,
                 const void* scale, void* out, int ne, int nb, int k, int n,
                 int d_in, int d_out, int tile, cudaStream_t stream) {
  // TMA needs 16-byte strides and base; dZ' rows go in 16-byte chunks
  if (d_in % 8 != 0 || d_out % 8 != 0 || !aligned16(hsub) || !aligned16(dz)) {
    return -2;
  }
  const bool wide = pick_tile(tile, ne, d_in, d_out) == 128;
  if (ne > 1) {
    return wide ? launch_wgmma_tile<T, 128, true>(hsub, dz, idx, scale, out,
                                                  ne, nb, k, n, d_in, d_out,
                                                  stream)
                : launch_wgmma_tile<T, 64, true>(hsub, dz, idx, scale, out,
                                                 ne, nb, k, n, d_in, d_out,
                                                 stream);
  }
  return wide ? launch_wgmma_tile<T, 128, false>(hsub, dz, idx, scale, out,
                                                 ne, nb, k, n, d_in, d_out,
                                                 stream)
              : launch_wgmma_tile<T, 64, false>(hsub, dz, idx, scale, out, ne,
                                                nb, k, n, d_in, d_out, stream);
}

int launch_f32(const void* hsub, const void* dz, const void* idx,
               const void* scale, void* out, int ne, int nb, int k, int n,
               int d_in, int d_out, cudaStream_t stream) {
  const int vec_a = aligned16(hsub) && (d_in % 4 == 0);
  const int vec_b = aligned16(dz) && (d_out % 4 == 0);
  dim3 grid(cdiv(d_in, kF32Tile), cdiv(d_out, kF32Tile), ne);
  fused_dw_f32_kernel<<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(hsub), static_cast<const float*>(dz),
      static_cast<const int*>(idx), static_cast<const float*>(scale),
      static_cast<float*>(out), nb, k, n, d_in, d_out, vec_a, vec_b);
  return (int)cudaGetLastError();
}

// Routes of the C interface (kept in step with kernels/fused_sampling.py).
enum Route : int { kRouteFma = 0, kRouteWmma = 1, kRouteWgmma = 2 };

}  // namespace

// hsub (ne, nb, k, d_in) and dz (ne, nb, n, d_out) of `dtype`, idx
// (ne, nb, k) int32, scale (ne, nb, k) f32, out (ne, d_in, d_out) f32; all
// contiguous; ne experts (1 for one weight, up to 65535).  `tile`: 0 lets
// the shape decide, 64 or 128 pins the bf16/f16 output tile (f32 inputs
// always take the 64x64 FMA kernel).  `route`: 0 fma (f32), 1 wmma, 2
// wgmma (bf16/f16; d_in and d_out multiples of 8, hsub and dz 16-byte
// aligned).  Returns cudaGetLastError() of the launch (0 = accepted), -1
// unknown dtype, -2 unknown tile or a route the shape does not fit, -4 a
// tensor map that cuTensorMapEncodeTiled refused.  Does not synchronise
// and allocates nothing.
extern "C" int repro_fused_sampled_dw(const void* hsub, const void* dz,
                                      const void* idx, const void* scale,
                                      void* out, int ne, int nb, int k,
                                      int n, int d_in, int d_out, int dtype,
                                      int tile, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile != 0 && tile != 64 && tile != 128) return -2;
  if (ne < 1 || ne > 65535) return -2;
  if (dtype != repro::kF32 && dtype != repro::kBF16 && dtype != repro::kF16) {
    return -1;
  }
  if ((dtype == repro::kF32) != (route == kRouteFma)) return -2;
  const bool bf16 = dtype == repro::kBF16;
  switch (route) {
    case kRouteFma:
      return launch_f32(hsub, dz, idx, scale, out, ne, nb, k, n, d_in, d_out,
                        s);
    case kRouteWmma:
      return bf16 ? launch_mma<__nv_bfloat16>(hsub, dz, idx, scale, out, ne,
                                              nb, k, n, d_in, d_out, tile, s)
                  : launch_mma<__half>(hsub, dz, idx, scale, out, ne, nb, k,
                                       n, d_in, d_out, tile, s);
    case kRouteWgmma:
      return bf16 ? launch_wgmma<__nv_bfloat16>(hsub, dz, idx, scale, out, ne,
                                                nb, k, n, d_in, d_out, tile, s)
                  : launch_wgmma<__half>(hsub, dz, idx, scale, out, ne, nb, k,
                                         n, d_in, d_out, tile, s);
    default:
      return -2;
  }
}
