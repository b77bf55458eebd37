// flash_attention_bwd: the gradient of flash_attention_fwd's wgmma route
// (causal or not, GQA) with respect to q, k and v, given dO.
//
//   S = q k^T (f32 sums of exact bf16/f16 products), s = S * scale
//   lse_i = log sum_j exp(s_ij)  (f32, over the visible keys)
//   P = exp(s - lse)            (f32; masked keys 0)
//   dP = dO v^T                 (f32)
//   D_i = sum_j P_ij dP_ij      (f32)
//   dS = P * (dP - D)           (f32)
//   dV = sum over the group of bf16(P)^T dO
//   dK = scale * sum over the group of dS^T q
//   dQ = scale * dS k
//
// with the causal mask aligned at position 0 (key j visible to query i iff
// i >= j, also when Sq != Skv).  The forward rounds P once to the input
// dtype before P V, and so dV takes that rounded P.  dS enters both of its
// products as two bf16/f16 halves, hi = round(dS) and lo = round(dS - hi),
// each product summed in f32: about 16 significant bits of dS where the
// eager path multiplied an f32 dS by upcast q and k.  dK and dV are summed
// over the group's heads in f32 registers and dQ over the kv tiles, each
// rounded once.  No sum crosses blocks, so there are no atomics and the
// result is the same from run to run.
//
// Replaces no TPU kernel: the reference differentiates the jnp code of its
// blockwise training attention (repro/models/attention.py, under
// jax.checkpoint), and the port's eager copy of that code recomputed every
// block in f32 on CUDA cores.  It was added because that backward took
// 1147 of a nemotron-4-15b train step's 2287 device-ms on an H100.
//
// Bound on an H100: operations.  The counted work is two forwards' worth,
// 8 * BH * Dh * sum_i(#visible keys of query i) flops; these kernels do
// 22 (S and dP three times, P^T dO once, dS^T q and dS k twice each),
// against bytes (3 * BH * Sq + 4 * BKVH * Skv) * Dh * itemsize.  At
// nemotron's train shape (B=16, S=2048, 48/8 heads of 128) a layer's is
// 4.5 TFLOP of their own work = 4.6 ms at 989 TFLOP/s (1.65 TFLOP
// counted) against 1.5 GB = 0.44 ms at 3.35 TB/s.  The design keeps every product on wgmma, everything
// between the products in registers, and the forward's saved state to q,
// k and v:
//  * flash_bwd_dq_kernel: one block a (bh, 128-row q tile), the forward's
//    layout (a producer warpgroup keeps K and V tiles in flight by TMA,
//    two consumer warpgroups of 64 q rows, setmaxnreg), the longest causal
//    rows first.  Pass 1 recomputes S and dP a kv tile at a time and keeps
//    the forward's online softmax (m, l) beside an online sum of exp(s -
//    m) * dP: each row's lse and D = rowsum(P * dP), in registers and to
//    the caller's scratch, so the forward saves neither O nor its
//    statistics.  Pass 2 walks the kv tiles again: S and dP, then dS in
//    the register A layout (as the forward's P) against K read MN-major
//    (as the forward's V), dQ summed in f32 registers.
//  * flash_bwd_dkv_kernel: one block a (b, kv head, 128-row kv tile), kv
//    tile 0 first (under the causal mask it has the most query rows); K
//    and V are loaded once, and the producer streams (Q, dO, lse, D) tiles
//    of 64 query rows of each of the group's heads, at or below the causal
//    bound, through a three-stage TMA ring.  Each consumer warpgroup owns
//    64 kv rows and keeps its dK and dV (64 x Dh each, f32) in registers
//    across every head and tile.  A tile computes S^T = K Q^T and dP^T =
//    V dO^T (kv rows as M, so P^T and dS^T come out in the register A
//    layout), then dV += P^T dO and dK += dS^T q with the stage's Q / dO
//    read MN-major.
// Any Sq, Skv >= 1: rows and columns past the ends arrive as zeros and are
// masked.  Dh is a multiple of 8 up to 128, held at a 64- or 128-column
// capacity as in the forward; q, k, v, dO are 16-byte aligned.
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 3 * 128;  // consumers 0 and 1, producer 2
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <typename T>
__device__ __forceinline__ uint16_t bits(T x);
template <>
__device__ __forceinline__ uint16_t bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
template <>
__device__ __forceinline__ uint16_t bits(__half x) {
  return __half_as_ushort(x);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(T lo, T hi) {
  return (uint32_t)bits(lo) | ((uint32_t)bits(hi) << 16);
}

// hi = round(x), lo = round(x - hi): both halves of one value
template <typename T>
__device__ __forceinline__ void split2(float x, T& hi, T& lo) {
  hi = from_f32<T>(x);
  lo = from_f32<T>(x - to_f32(hi));
}

// ---------------------------------------------------------------------------
// lse, D and dQ: one block a (bh, 128-row q tile), two passes over its kv
// tiles
// ---------------------------------------------------------------------------
constexpr float kNegInf = -1e30f;
constexpr int kQBQ = 128;
constexpr int kQBK = 128;
constexpr int kQStages = 2;

// Q and dO (kCap/64 atom columns of 128 rows each), then the K and V ring,
// then the barriers
template <int kSteps>
struct DqLayout {
  static constexpr int kCap = kSteps > 4 ? 128 : 64;
  static constexpr int kColBytes = 128 * 128;
  static constexpr int kTileBytes = kColBytes * (kCap / 64);
  static constexpr int kDO = kTileBytes;
  static constexpr int kK = 2 * kTileBytes;
  static constexpr int kV = kK + kQStages * kTileBytes;
  static constexpr int kBars = kV + kQStages * kTileBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kQStages) + 1024;
};

template <typename T, int kSteps>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_do,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    T* __restrict__ dq, float* __restrict__ lse,
                    float* __restrict__ dsum, int ld, int n_bh, int group,
                    int sq, int skv, int dh, int causal, float scale,
                    float scale_log2, int n_qtiles) {
  using namespace repro::hopper;
  using L = DqLayout<kSteps>;
  constexpr int kCap = L::kCap;
  constexpr int kCols = kCap / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + kQStages;
  uint64_t* empty = full_v + kQStages;

  // the longest causal rows first
  const int tile = n_qtiles - 1 - (int)(blockIdx.x / n_bh);
  const int bh = (int)(blockIdx.x % n_bh);
  const int kvh = bh / group;
  const int q0 = tile * kQBQ;
  const int q_last = min(q0 + kQBQ, sq) - 1;
  const int kv_end = causal ? min(skv, q_last + 1) : skv;
  const int n_kv = (kv_end + kQBK - 1) / kQBK;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: Q and dO once, then the kv tiles twice ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(full_q, 2 * L::kTileBytes);
      for (int c = 0; c < kCols; ++c) {
        tma_load_3d(sm + c * L::kColBytes, &map_q, full_q, 64 * c, q0, bh);
        tma_load_3d(sm + L::kDO + c * L::kColBytes, &map_do, full_q, 64 * c,
                    q0, bh);
      }
      for (int j = 0; j < 2 * n_kv; ++j) {
        const int s = j % kQStages;
        const int k0 = (j % n_kv) * kQBK;
        mbar_wait(&empty[s], ((j / kQStages) & 1) ^ 1);
        unsigned char* k_st = sm + L::kK + s * L::kTileBytes;
        unsigned char* v_st = sm + L::kV + s * L::kTileBytes;
        mbar_arrive_expect_tx(&full_k[s], L::kTileBytes);
        for (int c = 0; c < kCols; ++c) {
          tma_load_3d(k_st + c * L::kColBytes, &map_k, &full_k[s], 64 * c, k0,
                      kvh);
        }
        mbar_arrive_expect_tx(&full_v[s], L::kTileBytes);
        for (int c = 0; c < kCols; ++c) {
          tma_load_3d(v_st + c * L::kColBytes, &map_v, &full_v[s], 64 * c, k0,
                      kvh);
        }
      }
    }
    return;
  }

  // ---- consumers: 64 q rows each ----
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = q0 + wg * 64;
  const int row_a = r0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const unsigned char* q_wg = sm + wg * 64 * 128;
  const unsigned char* do_wg = sm + L::kDO + wg * 64 * 128;

  // S = Q K^T and dP = dO V^T of ring step j: 64 q rows x 128 kv columns,
  // all operands K-major; the stage is still held
  auto scores = [&](int j, float (&sc)[kQBK / 2], float (&dp)[kQBK / 2]) {
    const int s = j % kQStages;
    const uint32_t phase = (j / kQStages) & 1;
    const unsigned char* k_st = sm + L::kK + s * L::kTileBytes;
    const unsigned char* v_st = sm + L::kV + s * L::kTileBytes;
    mbar_wait(&full_k[s], phase);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int off = (kk >> 2) * L::kColBytes + (kk & 3) * 32;
      wgmma_ss<T, kQBK, 0, 0>(sc, desc_sw128(q_wg + off, 16, 1024),
                              desc_sw128(k_st + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    mbar_wait(&full_v[s], phase);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int off = (kk >> 2) * L::kColBytes + (kk & 3) * 32;
      wgmma_ss<T, kQBK, 0, 0>(dp, desc_sw128(do_wg + off, 16, 1024),
                              desc_sw128(v_st + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
  };
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % kQStages]);
  };
  // masked scores to -1e30, only on a tile crossing Skv or the diagonal
  auto mask = [&](int k0, float (&sc)[kQBK / 2]) {
    if (k0 + kQBK > skv || (causal && k0 + kQBK - 1 > r0)) {
#pragma unroll
      for (int i = 0; i < kQBK / 2; ++i) {
        const int col = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        const int row = ((i >> 1) & 1) ? row_b : row_a;
        if (col >= skv || (causal && row < col)) sc[i] = kNegInf;
      }
    }
  };

  // pass 1: the forward's online softmax on the raw scores (m in raw
  // units, p = 2^(s*c - m*c), c = scale * log2(e)) and, beside l, the
  // online sum of p * dP
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};
  mbar_wait(full_q, 0);
  for (int j = 0; j < n_kv; ++j) {
    float sc[kQBK / 2], dp[kQBK / 2];
    scores(j, sc, dp);
    release(j);
    mask(j * kQBK, sc);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kQBK / 2; ++i) {
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float ms[2], ls[2] = {0.f, 0.f}, ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float corr = exp2f((m[r] - mx[r]) * scale_log2);
      l[r] *= corr;
      pd[r] *= corr;
      m[r] = mx[r];
      ms[r] = mx[r] * scale_log2;
    }
#pragma unroll
    for (int i = 0; i < kQBK / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = exp2f(fmaf(sc[i], scale_log2, -ms[r]));
      ls[r] += p;
      ps[r] = fmaf(p, dp[i], ps[r]);
    }
    l[0] += ls[0];
    l[1] += ls[1];
    pd[0] += ps[0];
    pd[1] += ps[1];
  }
  // every row of the tile sees key 0, so l >= 1; rows past Sq have zero Q
  // (finite statistics) and zero dO (D = 0).  lse in log2 units of c * s:
  // P = 2^(c * s - lse2)
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], 1);
    pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], 2);
    lse2[r] = m[r] * scale_log2 + log2f(l[r]);
    dd[r] = pd[r] / l[r];
  }
  if (t == 0) {
    const long long o = (long long)bh * ld;
    lse[o + row_a] = lse2[0];
    lse[o + row_b] = lse2[1];
    dsum[o + row_a] = dd[0];
    dsum[o + row_b] = dd[1];
  }

  // pass 2: dS = P (dP - D) and dQ += dS K, dS as two halves in the
  // register A layout (the accumulator of kv columns [16 kk, 16 kk + 16)
  // is A's k-slice kk), K read MN-major as the forward reads V
  float acc[kCap / 2];
#pragma unroll
  for (int i = 0; i < kCap / 2; ++i) acc[i] = 0.f;
  for (int j2 = 0; j2 < n_kv; ++j2) {
    const int j = n_kv + j2;
    float sc[kQBK / 2], dp[kQBK / 2];
    scores(j, sc, dp);
    mask(j2 * kQBK, sc);
    uint32_t ha[kQBK / 16][4], la[kQBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kQBK / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int i = 8 * kk + 2 * h;
        const int r = (i >> 1) & 1;
        T hv[2], lv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(sc[i + e], scale_log2, -lse2[r]));
          split2(p * (dp[i + e] - dd[r]), hv[e], lv[e]);
        }
        ha[kk][h] = pack2(hv[0], hv[1]);
        la[kk][h] = pack2(lv[0], lv[1]);
      }
    }
    const unsigned char* k_st = sm + L::kK + (j % kQStages) * L::kTileBytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQBK / 16; ++kk) {
      wgmma_rs<T, kCap, 1>(acc, ha[kk],
                           desc_sw128(k_st + kk * 2048, L::kColBytes, 1024),
                           1);
    }
#pragma unroll
    for (int kk = 0; kk < kQBK / 16; ++kk) {
      wgmma_rs<T, kCap, 1>(acc, la[kk],
                           desc_sw128(k_st + kk * 2048, L::kColBytes, 1024),
                           1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    release(j);
  }

  // dQ = scale * acc, rounded once; the padded columns are 0
  T* ob = dq + (long long)bh * sq * dh;
  const int dh8 = dh / 8;
#pragma unroll
  for (int nb = 0; nb < kCap / 8; ++nb) {
    if (nb >= dh8) break;
    const int col = nb * 8 + 2 * t;
    if (row_a < sq) {
      *reinterpret_cast<uint32_t*>(ob + (long long)row_a * dh + col) =
          pack2(from_f32<T>(acc[4 * nb] * scale),
                from_f32<T>(acc[4 * nb + 1] * scale));
    }
    if (row_b < sq) {
      *reinterpret_cast<uint32_t*>(ob + (long long)row_b * dh + col) =
          pack2(from_f32<T>(acc[4 * nb + 2] * scale),
                from_f32<T>(acc[4 * nb + 3] * scale));
    }
  }
}

// ---------------------------------------------------------------------------
// dK and dV: one block a (b, kv head, 128-row kv tile)
// ---------------------------------------------------------------------------
constexpr int kBK = 128;  // kv rows a block (64 a consumer warpgroup)
constexpr int kBQ = 64;   // q rows a tile of the stream
constexpr int kStages = 3;

// K and V (kCap/64 atom columns of 128 rows), then the stages: Q and dO at
// kCap/64 atom columns of 64 rows, then lse and D (64 floats each), padded
// to 1024 bytes; then the barriers
template <int kSteps>
struct KvLayout {
  static constexpr int kCap = kSteps > 4 ? 128 : 64;
  static constexpr int kCols = kCap / 64;
  static constexpr int kKVCol = kBK * 128;  // an atom column of K or V
  static constexpr int kKVBytes = kKVCol * kCols;
  static constexpr int kQCol = kBQ * 128;   // an atom column of Q or dO
  static constexpr int kQBytes = kQCol * kCols;
  static constexpr int kV = kKVBytes;
  static constexpr int kStage0 = 2 * kKVBytes;
  static constexpr int kStageDO = kQBytes;
  static constexpr int kStageLse = 2 * kQBytes;
  static constexpr int kStageD = kStageLse + 256;
  static constexpr int kStageBytes = 2 * kQBytes + 1024;
  static constexpr int kBars = kStage0 + kStages * kStageBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <typename T, int kSteps>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, int ld,
                     T* __restrict__ dk, T* __restrict__ dv, int n_bkvh,
                     int group, int sq, int skv, int dh, int causal,
                     float scale, float scale_log2, int n_qtiles) {
  using namespace repro::hopper;
  using L = KvLayout<kSteps>;
  constexpr int kCap = L::kCap;
  constexpr int kCols = L::kCols;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full_kv = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  // kv tile 0 first: under the causal mask it has the most query rows
  const int n = (int)(blockIdx.x / n_bkvh);
  const int bkvh = (int)(blockIdx.x % n_bkvh);
  const int kv0 = n * kBK;
  const int t_first = causal ? kv0 / kBQ : 0;
  const int n_t = max(n_qtiles - t_first, 0);
  const int steps = group * n_t;  // (head, q tile) pairs, head-major

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256 && steps > 0) {
      mbar_arrive_expect_tx(full_kv, 2 * L::kKVBytes);
      for (int c = 0; c < kCols; ++c) {
        tma_load_3d(sm + c * L::kKVCol, &map_k, full_kv, 64 * c, kv0, bkvh);
        tma_load_3d(sm + L::kV + c * L::kKVCol, &map_v, full_kv, 64 * c, kv0,
                    bkvh);
      }
      for (int u = 0; u < steps; ++u) {
        const int s = u % kStages;
        const int bh = bkvh * group + u / n_t;
        const int q0 = (t_first + u % n_t) * kBQ;
        mbar_wait(&empty[s], ((u / kStages) & 1) ^ 1);
        unsigned char* st = sm + L::kStage0 + s * L::kStageBytes;
        mbar_arrive_expect_tx(&full[s], 2 * L::kQBytes + 512);
        for (int c = 0; c < kCols; ++c) {
          tma_load_3d(st + c * L::kQCol, &map_q, &full[s], 64 * c, q0, bh);
          tma_load_3d(st + L::kStageDO + c * L::kQCol, &map_do, &full[s],
                      64 * c, q0, bh);
        }
        bulk_load(st + L::kStageLse, lse + (long long)bh * ld + q0, 256,
                  &full[s]);
        bulk_load(st + L::kStageD, dsum + (long long)bh * ld + q0, 256,
                  &full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kr0 = kv0 + wg * 64;  // first kv row of this warpgroup
  // this thread's kv rows, of acc[i] with (i >> 1) even / odd
  const int row_a = kr0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const unsigned char* k_wg = sm + wg * 64 * 128;
  const unsigned char* v_wg = sm + L::kV + wg * 64 * 128;

  float dkacc[kCap / 2], dvacc[kCap / 2];
#pragma unroll
  for (int i = 0; i < kCap / 2; ++i) dkacc[i] = dvacc[i] = 0.f;

  if (steps > 0) mbar_wait(full_kv, 0);
  for (int u = 0; u < steps; ++u) {
    const int s = u % kStages;
    const uint32_t phase = (u / kStages) & 1;
    const int q0 = (t_first + u % n_t) * kBQ;
    const unsigned char* st = sm + L::kStage0 + s * L::kStageBytes;
    const unsigned char* do_st = st + L::kStageDO;
    const float* lse_st = reinterpret_cast<const float*>(st + L::kStageLse);
    const float* d_st = reinterpret_cast<const float*>(st + L::kStageD);

    // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x 64 q columns each, all
    // four operands K-major in shared memory
    float st_[kBQ / 2], dpt[kBQ / 2];
    mbar_wait(&full[s], phase);
    fence_regs(st_);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int kv_off = (kk >> 2) * L::kKVCol + (kk & 3) * 32;
      const int q_off = (kk >> 2) * L::kQCol + (kk & 3) * 32;
      wgmma_ss<T, kBQ, 0, 0>(st_, desc_sw128(k_wg + kv_off, 16, 1024),
                             desc_sw128(st + q_off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int kv_off = (kk >> 2) * L::kKVCol + (kk & 3) * 32;
      const int q_off = (kk >> 2) * L::kQCol + (kk & 3) * 32;
      wgmma_ss<T, kBQ, 0, 0>(dpt, desc_sw128(v_wg + kv_off, 16, 1024),
                             desc_sw128(do_st + q_off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st_);
    fence_regs(dpt);

    // P^T and dS^T, straight into the register A operands (k = the tile's
    // 64 q columns): bf16(P^T) and dS^T's halves.  A tile is masked only
    // where it crosses Sq, Skv or the diagonal of these kv rows.
    const bool edge = q0 + kBQ > sq || kr0 + 64 > skv ||
                      (causal && q0 < kr0 + 63);
    uint32_t pa[kBQ / 16][4], ha[kBQ / 16][4], la[kBQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int i = 8 * kk + 2 * h;
        T pv[2], hv[2], lv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = (i >> 2) * 8 + 2 * t + e;  // q column in the tile
          float p = exp2f(fmaf(st_[i + e], scale_log2, -lse_st[cl]));
          if (edge) {
            const int col = q0 + cl;
            const int row = (h & 1) ? row_b : row_a;
            if (col >= sq || row >= skv || (causal && col < row)) p = 0.f;
          }
          pv[e] = from_f32<T>(p);
          split2(p * (dpt[i + e] - d_st[cl]), hv[e], lv[e]);
        }
        pa[kk][h] = pack2(pv[0], pv[1]);
        ha[kk][h] = pack2(hv[0], hv[1]);
        la[kk][h] = pack2(lv[0], lv[1]);
      }
    }

    // dV += P^T dO, dK += dS^T Q (hi, then lo): B is the stage's dO / Q
    // tile read MN-major (64 q rows of k, Dh columns of N)
    fence_regs(dvacc);
    fence_regs(dkacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      wgmma_rs<T, kCap, 1>(dvacc, pa[kk],
                           desc_sw128(do_st + kk * 2048, L::kQCol, 1024), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      wgmma_rs<T, kCap, 1>(dkacc, ha[kk],
                           desc_sw128(st + kk * 2048, L::kQCol, 1024), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      wgmma_rs<T, kCap, 1>(dkacc, la[kk],
                           desc_sw128(st + kk * 2048, L::kQCol, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dvacc);
    fence_regs(dkacc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // Q, dO, lse and D are read
  }

  // dK (scaled) and dV, rounded once; the padded columns are 0
  const long long kvbase = (long long)bkvh * skv * dh;
#pragma unroll
  for (int nb = 0; nb < kCap / 8; ++nb) {
    const int col = nb * 8 + 2 * t;
    if (col >= dh) break;
    if (row_a < skv) {
      const long long o = kvbase + (long long)row_a * dh + col;
      *reinterpret_cast<uint32_t*>(dk + o) =
          pack2(from_f32<T>(dkacc[4 * nb] * scale),
                from_f32<T>(dkacc[4 * nb + 1] * scale));
      *reinterpret_cast<uint32_t*>(dv + o) =
          pack2(from_f32<T>(dvacc[4 * nb]), from_f32<T>(dvacc[4 * nb + 1]));
    }
    if (row_b < skv) {
      const long long o = kvbase + (long long)row_b * dh + col;
      *reinterpret_cast<uint32_t*>(dk + o) =
          pack2(from_f32<T>(dkacc[4 * nb + 2] * scale),
                from_f32<T>(dkacc[4 * nb + 3] * scale));
      *reinterpret_cast<uint32_t*>(dv + o) =
          pack2(from_f32<T>(dvacc[4 * nb + 2]),
                from_f32<T>(dvacc[4 * nb + 3]));
    }
  }
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------
inline unsigned cdiv(long long a, long long b) {
  return (unsigned)((a + b - 1) / b);
}

struct Args {
  const void *q, *k, *v, *dout;
  float *lse, *dsum;
  int ld;
  void *dq, *dk, *dv;
  int bh, bkvh, sq, skv, dh, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int kSteps>
int launch(const Args& a) {
  using LQ = DqLayout<kSteps>;
  using LK = KvLayout<kSteps>;
  const int group = a.bh / a.bkvh;
  const float scale_log2 = (float)((double)a.scale * 1.4426950408889634);
  CUtensorMap mq128, mdo128, mq64, mdo64, mk, mv;
  if (!hopper::make_map_3d(&mq128, a.q, a.dh, a.sq, a.bh, kQBQ) ||
      !hopper::make_map_3d(&mdo128, a.dout, a.dh, a.sq, a.bh, kQBQ) ||
      !hopper::make_map_3d(&mq64, a.q, a.dh, a.sq, a.bh, kBQ) ||
      !hopper::make_map_3d(&mdo64, a.dout, a.dh, a.sq, a.bh, kBQ) ||
      !hopper::make_map_3d(&mk, a.k, a.dh, a.skv, a.bkvh, kBK) ||
      !hopper::make_map_3d(&mv, a.v, a.dh, a.skv, a.bkvh, kBK)) {
    return -4;
  }
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, kSteps>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, LQ::kBytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, kSteps>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           LK::kBytes);
  if (e != cudaSuccess) return (int)e;

  const int n_q_tiles = (int)cdiv(a.sq, kQBQ);
  const long long q_blocks = (long long)a.bh * n_q_tiles;
  const long long kv_blocks = (long long)a.bkvh * cdiv(a.skv, kBK);
  if (q_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL) return -3;
  flash_bwd_dq_kernel<T, kSteps>
      <<<(unsigned)q_blocks, kThreads, LQ::kBytes, a.stream>>>(
          mq128, mdo128, mk, mv, static_cast<T*>(a.dq), a.lse, a.dsum, a.ld,
          a.bh, group, a.sq, a.skv, a.dh, a.causal, a.scale, scale_log2,
          n_q_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkv_kernel<T, kSteps>
      <<<(unsigned)kv_blocks, kThreads, LK::kBytes, a.stream>>>(
          mq64, mdo64, mk, mv, a.lse, a.dsum, a.ld, static_cast<T*>(a.dk),
          static_cast<T*>(a.dv), a.bkvh, group, a.sq, a.skv, a.dh, a.causal,
          a.scale, scale_log2, (int)cdiv(a.sq, kBQ));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a) {
  if (a.dh <= 64) return launch<T, 4>(a);
  if (a.dh <= 80) return launch<T, 5>(a);
  if (a.dh <= 96) return launch<T, 6>(a);
  if (a.dh <= 112) return launch<T, 7>(a);
  return launch<T, 8>(a);
}

}  // namespace

// q, dout, dq (bh, sq, dh); k, v, dk, dv (bkvh, skv, dh); all of `dtype`
// (bf16 or f16), contiguous and 16-byte aligned; query head h reads kv head
// h / (bh / bkvh).  Scratch the caller allocates: stats f32 (2, bh, ld)
// with ld = sq rounded up to 128 (each row's lse, then its D).  Returns cudaGetLastError() of the launches (0 =
// accepted), -1 unknown dtype, -2 a shape the kernel does not take, -3 too
// many blocks, -4 a tensor map that cuTensorMapEncodeTiled refused.  Does
// not synchronise and allocates nothing.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         void* stats, void* dq, void* dk,
                                         void* dv, int bh, int bkvh, int sq,
                                         int skv, int dh, int causal,
                                         int dtype, void* stream) {
  if (bh < 1 || bkvh < 1 || bh % bkvh != 0 || sq < 1 || skv < 1 || dh < 8 ||
      dh > 128 || dh % 8 != 0) {
    return -2;
  }
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(dout) &&
        aligned16(stats) && aligned16(dq) && aligned16(dk) &&
        aligned16(dv))) {
    return -2;
  }
  const int ld = (int)cdiv(sq, 128) * 128;
  float* lse = static_cast<float*>(stats);
  Args a{q, k, v, dout, lse, lse + (long long)bh * ld, ld, dq, dk, dv, bh,
         bkvh, sq, skv, dh, causal ? 1 : 0,
         // the reference's 1 / math.sqrt(dh), rounded once to f32
         (float)(1.0 / sqrt((double)dh)), static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case repro::kBF16:
      return dispatch<__nv_bfloat16>(a);
    case repro::kF16:
      return dispatch<__half>(a);
    default:
      return -1;
  }
}
