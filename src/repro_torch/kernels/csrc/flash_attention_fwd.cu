// flash_attention_fwd: causal / non-causal GQA attention, forward only.
//
//   out[bh, i, :] = sum_j softmax_j(q[bh, i] . k[bh / group, j] * scale) *
//                   v[bh / group, j, :]          scale = 1 / sqrt(Dh)
//
// with the causal mask aligned at position 0 (key j is visible to query i
// iff i >= j, also when Sq != Skv), masked scores set to -1e30 (not -inf),
// online softmax (m, l, acc) in f32 and the output acc / max(l, 1e-30)
// rounded once to the input dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_fwd, whose grid is (BH, nq, nk) with nk innermost and the
// (m, l, acc) state carried across kv steps in on-chip scratch.  On Hopper
// nothing carries over between blocks, so one block owns one (bh, q tile)
// and walks the kv tiles itself, keeping m, l and the f32 accumulator in
// registers and writing the normalised tile once.  It stops at the causal
// bound (the last kv tile holding a key its last query sees), which skips
// the blocks above the diagonal as the TPU kernel's pl.when does, and the
// blocks of the longest rows start first.  Each K/V tile is read from head
// bh / group of k/v, so grouped heads share the same rows and no repeated
// K/V copy exists.  Any Sq, Skv >= 1 is taken: rows and columns past the
// end are zero-filled on load and masked, so the "must tile evenly"
// padding of the TPU wrapper is gone.  Dh is a multiple of 8 up to 256.
//
// Three routes, chosen by the caller (kernels/flash_attention.py::
// flash_route) and passed in; a route the shape does not fit returns -2:
//  * wgmma (bf16/f16, Dh up to 128, 16-byte-aligned q/k/v): the Hopper
//    kernel below.  One block owns one (bh, 128-row q tile): two consumer
//    warpgroups of 64 q rows and one producer warpgroup (setmaxnreg moves
//    its registers to the consumers).  The producer loads Q once and each
//    128-row K and V tile through a two-stage shared-memory ring by TMA,
//    from 3-D tensor maps (Dh, S, heads), so rows past Sq / Skv arrive as
//    zeros inside their own head.  Shared memory holds a tile at a
//    capacity of 64 columns (Dh <= 64) or 128 (64 < Dh <= 128), whole
//    64-column atoms of the 128-byte swizzle; the maps span the true Dh,
//    so the columns past it arrive as zeros too (Dh 80: 48 zero columns
//    at capacity 128).  S = Q K^T is one wgmma chain of max(4, ceil(Dh /
//    16)) k-steps, fixed at compile time (an instance a step count), with
//    both operands in shared memory; the online softmax runs on the f32
//    accumulator in registers (exp2f with scale * log2(e) folded in), and
//    only the tiles that cross the diagonal or Skv are masked.  p is
//    rounded once to the input dtype and fed as the register A operand of
//    P V, whose B operand is the V tile read MN-major at the full capacity
//    (the zero columns give zero sums, which are not stored).  K and V
//    have separate barriers, so Q K^T starts before V has landed.  The tensor maps are encoded on the host at each call (a
//    few microseconds).
//  * mma (bf16/f16, Dh over 128, or a misaligned base): mma.sync
//    m16n8k16, 64-row q tiles, single-buffered, K/V through registers.
//  * fma (f32): a separate FMA kernel (32x32 tiles, four threads a q row):
//    TF32 would cost the three decimal digits the f32 callers are promised.

// Numerics (the TPU kernel upcasts q/k/v to f32 before BOTH products):
// Q K^T multiplies bf16/f16 values exactly into f32 sums, so it is the
// reference's f32 dot up to summation order.  Every bf16/f16 route rounds
// p once to the input dtype before P V and sums l from the f32 p, as the
// model's own attention does (models/attention.py) and as the TPU's MXU
// does at default precision; the f32 route keeps p in f32.
//
// Bound on an H100: useful flops are 4 * BH * Dh * sum_i(#visible keys of
// query i), about 2 * BH * Dh * S * (S + 1) causal at Sq = Skv = S; bytes
// are (2 * BH * Sq + 2 * BKVH * Skv) * Dh * itemsize.  At the prefill shape
// of qwen2.5-3b (B=4, S=2048, H=16, KVH=2, Dh=128, bf16) that is 68.7 GFLOP
// = 69 us at 989 TFLOP/s against 71 MB = 21 us at 3.35 TB/s: operations
// bind.  The measured distance of each route from the bound is in PERF.md.
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace repro;

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bf16 / f16, the mma route: mma.sync, 64-row q tiles
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;             // q rows a block (16 a warp)
constexpr int kBK = 64;             // kv rows a tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ uint16_t bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ __forceinline__ uint16_t bits(__half x) { return __half_as_ushort(x); }

// Two 16-bit values in one register, the lower column in the low half (the
// mma fragment convention).
template <typename T>
__device__ __forceinline__ uint32_t pack2(T lo, T hi) {
  return (uint32_t)bits(lo) | ((uint32_t)bits(hi) << 16);
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row-major) * b (16x8, column-major), f32 accumulation.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1,
                                         __nv_bfloat16) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1, __half) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [row0, row0 + ROWS) of a (nrows, dh) matrix into shared memory with
// row stride kDh + 8; rows past nrows and columns past dh become zeros.
template <typename T, int kDh, int ROWS>
__device__ __forceinline__ void load_tile(T* s, const T* g, int row0,
                                          int nrows, int dh, bool vec) {
  constexpr int E = Chunk<T>::kElems;
  constexpr int kCpr = kDh / E;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < ROWS * kCpr; c += kThreads) {
    const int r = c / kCpr;
    const int col = (c % kCpr) * E;
    const int gr = row0 + r;
    const uint4 raw = load_chunk(g + (long long)gr * dh, col, dh, gr < nrows,
                                 vec);
    *reinterpret_cast<uint4*>(s + r * (kDh + 8) + col) = raw;
  }
}

template <typename T, int kDh>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int group,
                     int sq, int skv, int dh, int causal, float scale,
                     int n_qtiles, int vec) {
  constexpr int S = kDh + 8;   // padded row: conflict-free fragment loads
  constexpr int kND = kDh / 8; // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kBQ * S;
  T* sV = sK + kBK * S;

  // the longest causal rows first, so the short tiles fill the tail
  const int tile = n_qtiles - 1 - (int)(blockIdx.x % n_qtiles);
  const long long bh = blockIdx.x / n_qtiles;
  const long long kvh = bh / group;
  const int q0 = tile * kBQ;
  const T* qb = q + bh * sq * dh;
  const T* kb = k + kvh * skv * dh;
  const T* vb = v + kvh * skv * dh;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in group
  const int row_a = q0 + warp * 16 + g;  // query of c0/c1; c2/c3: row_a + 8
  const int row_b = row_a + 8;
  const int dh16 = (dh + 15) / 16;
  const int dh8 = dh / 8;

  load_tile<T, kDh, kBQ>(sQ, qb, q0, sq, dh, vec);

  float o[kND][4];
#pragma unroll
  for (int dt = 0; dt < kND; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int q_last = min(q0 + kBQ, sq) - 1;
  const int kv_end = causal ? min(skv, q_last + 1) : skv;
  const int n_kv = (kv_end + kBK - 1) / kBK;

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the previous tile is consumed (and sQ is written)
    load_tile<T, kDh, kBK>(sK, kb, k0, skv, dh, vec);
    load_tile<T, kDh, kBK>(sV, vb, k0, skv, dh, vec);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 kv columns
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      if (kk < dh16) {
        const T* qa = sQ + (warp * 16 + g) * S + kk * 16 + t * 2;
        const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * S), ld32(qa + 8),
                               ld32(qa + 8 * S + 8)};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const T* kp = sK + (nt * 8 + g) * S + kk * 16 + t * 2;
          mma16816(s[nt], a, ld32(kp), ld32(kp + 8), T());
        }
      }
    }

    // scale, mask, online softmax update
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + nt * 8 + t * 2 + (c & 1);
        const int row = (c < 2) ? row_a : row_b;
        const bool ok = col < skv && (!causal || row >= col);
        const float x = ok ? s[nt][c] * scale : kNegInf;
        s[nt][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[nt][c] - m[c >> 1]);
        s[nt][c] = p;
        ls[c >> 1] += p;
      }
    }
    l[0] = l[0] * corr[0] + ls[0];
    l[1] = l[1] * corr[1] + ls[1];
#pragma unroll
    for (int dt = 0; dt < kND; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // O += P V, p rounded once to T (the accumulator layout of S is the
    // A-operand layout of the next mma, so p never leaves registers)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t pa[4];
      pa[0] = pack2(from_f32<T>(s[2 * c][0]), from_f32<T>(s[2 * c][1]));
      pa[1] = pack2(from_f32<T>(s[2 * c][2]), from_f32<T>(s[2 * c][3]));
      pa[2] = pack2(from_f32<T>(s[2 * c + 1][0]),
                    from_f32<T>(s[2 * c + 1][1]));
      pa[3] = pack2(from_f32<T>(s[2 * c + 1][2]),
                    from_f32<T>(s[2 * c + 1][3]));
      const T* vp = sV + (c * 16 + t * 2) * S + g;
#pragma unroll
      for (int dt = 0; dt < kND; ++dt) {
        if (dt < dh8) {
          const T* vq = vp + dt * 8;
          const uint32_t b0 = pack2(vq[0], vq[S]);
          const uint32_t b1 = pack2(vq[8 * S], vq[9 * S]);
          mma16816(o[dt], pa, b0, b1, T());
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  T* ob = out + bh * sq * dh;
#pragma unroll
  for (int dt = 0; dt < kND; ++dt) {
    if (dt < dh8) {
      const int col = dt * 8 + t * 2;
      if (row_a < sq) {
        *reinterpret_cast<uint32_t*>(ob + (long long)row_a * dh + col) =
            pack2(from_f32<T>(o[dt][0] / l[0]), from_f32<T>(o[dt][1] / l[0]));
      }
      if (row_b < sq) {
        *reinterpret_cast<uint32_t*>(ob + (long long)row_b * dh + col) =
            pack2(from_f32<T>(o[dt][2] / l[1]), from_f32<T>(o[dt][3] / l[1]));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / f16, the wgmma route: Dh up to 128, TMA ring, warp-specialised
// ---------------------------------------------------------------------------
constexpr int kWgBQ = 128;          // q rows a block (64 a consumer warpgroup)
constexpr int kWgBK = 128;          // kv rows a tile
constexpr int kWgStages = 2;        // K/V ring depth
constexpr int kWgThreads = 3 * 128; // consumers 0 and 1, producer 2
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// kSteps: Q K^T's k16 steps, max(4, ceil(Dh / 16)), a compile-time chain
// (a branch between the wgmmas of one chain makes ptxas fence each one).
// A tile's column capacity kCap is 64 at 4 steps, else 128.  Shared
// memory: Q (kCap/64 atom columns of 128 rows x 128 bytes), then kWgStages
// K tiles and kWgStages V tiles of the same shape, then the barriers; the
// base is rounded up to 1024 bytes for the swizzle.
template <int kSteps>
struct WgLayout {
  static constexpr int kCap = kSteps > 4 ? 128 : 64;
  static constexpr int kColBytes = kWgBQ * 128;  // a 64-column atom column
  static constexpr int kTileBytes = kColBytes * (kCap / 64);
  static constexpr int kK = kTileBytes;                // offset of K stage 0
  static constexpr int kV = kK + kWgStages * kTileBytes;
  static constexpr int kBars = kV + kWgStages * kTileBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kWgStages) + 1024;
};

template <typename T, int kSteps>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       T* __restrict__ out, int n_bh, int group, int sq,
                       int skv, int dh, int causal, float scale_log2,
                       int n_qtiles) {
  using namespace repro::hopper;
  using L = WgLayout<kSteps>;
  constexpr int kCap = L::kCap;
  constexpr int kCols = kCap / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + kWgStages;
  uint64_t* empty = full_v + kWgStages;

  // the longest causal rows first (all blocks of the last q tile, then the
  // one before, ...); neighbouring blocks share a kv head
  const int tile = n_qtiles - 1 - (int)(blockIdx.x / n_bh);
  const int bh = (int)(blockIdx.x % n_bh);
  const int kvh = bh / group;
  const int q0 = tile * kWgBQ;
  const int q_last = min(q0 + kWgBQ, sq) - 1;
  const int kv_end = causal ? min(skv, q_last + 1) : skv;
  const int n_kv = (kv_end + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(full_q, L::kTileBytes);
      for (int c = 0; c < kCols; ++c) {
        tma_load_3d(sm + c * L::kColBytes, &map_q, full_q, 64 * c, q0, bh);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kWgStages;
        mbar_wait(&empty[s], ((j / kWgStages) & 1) ^ 1);
        unsigned char* k_st = sm + L::kK + s * L::kTileBytes;
        unsigned char* v_st = sm + L::kV + s * L::kTileBytes;
        mbar_arrive_expect_tx(&full_k[s], L::kTileBytes);
        for (int c = 0; c < kCols; ++c) {
          tma_load_3d(k_st + c * L::kColBytes, &map_k, &full_k[s], 64 * c,
                      j * kWgBK, kvh);
        }
        mbar_arrive_expect_tx(&full_v[s], L::kTileBytes);
        for (int c = 0; c < kCols; ++c) {
          tma_load_3d(v_st + c * L::kColBytes, &map_v, &full_v[s], 64 * c,
                      j * kWgBK, kvh);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r0 = q0 + wg * 64;           // first query of this warpgroup
    const int row_a = r0 + warp * 16 + g;  // query of acc[i], (i >> 1) even
    const int row_b = row_a + 8;           // query of acc[i], (i >> 1) odd
    const unsigned char* q_wg = sm + wg * 64 * 128;

    float o[kCap / 2];
#pragma unroll
    for (int i = 0; i < kCap / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max of the raw scores
    float l[2] = {0.f, 0.f};          // this thread's share of the row sums

    mbar_wait(full_q, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % kWgStages;
      const uint32_t phase = (j / kWgStages) & 1;
      const int k0 = j * kWgBK;
      const unsigned char* k_st = sm + L::kK + s * L::kTileBytes;
      const unsigned char* v_st = sm + L::kV + s * L::kTileBytes;

      // S = Q K^T: 64 x 128, both operands K-major in shared memory
      float sc[kWgBK / 2];
      mbar_wait(&full_k[s], phase);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const int off = (kk >> 2) * L::kColBytes + (kk & 3) * 32;
        wgmma_ss<T, kWgBK, 0, 0>(sc, desc_sw128(q_wg + off, 16, 1024),
                                 desc_sw128(k_st + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // mask only a tile that crosses Skv or the diagonal of these rows
      if (k0 + kWgBK > skv || (causal && k0 + kWgBK - 1 > r0)) {
#pragma unroll
        for (int i = 0; i < kWgBK / 2; ++i) {
          const int col = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
          const int row = ((i >> 1) & 1) ? row_b : row_a;
          if (col >= skv || (causal && row < col)) sc[i] = kNegInf;
        }
      }

      // online softmax on the raw scores: m in raw units, p = 2^(s*c - m*c)
      // with c = scale * log2(e)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kWgBK / 2; ++i) {
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
      float corr[2], ms[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f((m[r] - mx[r]) * scale_log2);
        m[r] = mx[r];
        ms[r] = mx[r] * scale_log2;
      }
#pragma unroll
      for (int i = 0; i < kWgBK / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float p = exp2f(fmaf(sc[i], scale_log2, -ms[r]));
        sc[i] = p;
        ls[r] += p;
      }
      l[0] = l[0] * corr[0] + ls[0];
      l[1] = l[1] * corr[1] + ls[1];
#pragma unroll
      for (int i = 0; i < kCap / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // p rounded once to T, in the register A layout of m64k16: the
      // accumulator of kv columns [16 kk, 16 kk + 16) is A's k-slice kk
      uint32_t pa[kWgBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          pa[kk][h] = pack2(from_f32<T>(sc[8 * kk + 2 * h]),
                            from_f32<T>(sc[8 * kk + 2 * h + 1]));
        }
      }

      // O += P V: V (kv x Dh) is the MN-major B operand
      mbar_wait(&full_v[s], phase);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        wgmma_rs<T, kCap, 1>(o, pa[kk],
                             desc_sw128(v_st + kk * 2048, L::kColBytes, 1024),
                             1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    // the dh / 8 column groups of the true Dh; the padded ones are 0
    T* ob = out + (long long)bh * sq * dh;
    const int dh8 = dh / 8;
#pragma unroll
    for (int nb = 0; nb < kCap / 8; ++nb) {
      if (nb >= dh8) break;
      const int col = nb * 8 + 2 * t;
      if (row_a < sq) {
        *reinterpret_cast<uint32_t*>(ob + (long long)row_a * dh + col) =
            pack2(from_f32<T>(o[4 * nb] / l[0]),
                  from_f32<T>(o[4 * nb + 1] / l[0]));
      }
      if (row_b < sq) {
        *reinterpret_cast<uint32_t*>(ob + (long long)row_b * dh + col) =
            pack2(from_f32<T>(o[4 * nb + 2] / l[1]),
                  from_f32<T>(o[4 * nb + 3] / l[1]));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA kernel.  A block owns 32 q rows, four threads a row; scores and
// the row statistics stay in registers, p goes through shared memory for
// the P V product.
// ---------------------------------------------------------------------------
constexpr int kF32BQ = 32;
constexpr int kF32BK = 32;
constexpr int kF32Threads = 128;

template <int kDh>
__device__ __forceinline__ void load_tile_f32(float* s, const float* g,
                                              int row0, int nrows, int dh) {
  constexpr int S = kDh + 1;
  for (int c = threadIdx.x; c < kF32BK * kDh; c += kF32Threads) {
    const int r = c / kDh;
    const int col = c % kDh;
    const int gr = row0 + r;
    s[r * S + col] = (gr < nrows && col < dh) ? g[(long long)gr * dh + col]
                                              : 0.f;
  }
}

template <int kDh>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int group, int sq, int skv, int dh, int causal,
                     float scale, int n_qtiles) {
  constexpr int S = kDh + 1;   // odd stride: conflict-free column walks
  constexpr int kPS = kF32BK + 1;
  constexpr int kE = kDh / 4;  // output columns a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kF32BQ * S;
  float* sV = sK + kF32BK * S;
  float* sP = sV + kF32BK * S;

  const int tile = n_qtiles - 1 - (int)(blockIdx.x % n_qtiles);
  const long long bh = blockIdx.x / n_qtiles;
  const long long kvh = bh / group;
  const int q0 = tile * kF32BQ;
  const float* qb = q + bh * sq * dh;
  const float* kb = k + kvh * skv * dh;
  const float* vb = v + kvh * skv * dh;

  const int r = threadIdx.x >> 2;   // q row in the tile
  const int qd = threadIdx.x & 3;   // quarter of the row this thread owns
  const int row = q0 + r;

  load_tile_f32<kDh>(sQ, qb, q0, sq, dh);

  float o[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) o[e] = 0.f;
  float m = kNegInf, l = 0.f;

  const int q_last = min(q0 + kF32BQ, sq) - 1;
  const int kv_end = causal ? min(skv, q_last + 1) : skv;
  const int n_kv = (kv_end + kF32BK - 1) / kF32BK;

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kF32BK;
    __syncthreads();
    load_tile_f32<kDh>(sK, kb, k0, skv, dh);
    load_tile_f32<kDh>(sV, vb, k0, skv, dh);
    __syncthreads();

    float s[kF32BK / 4];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kF32BK / 4; ++c) {
      const int jj = qd + 4 * c;
      float acc = 0.f;
      for (int d = 0; d < dh; ++d) acc = fmaf(sQ[r * S + d], sK[jj * S + d], acc);
      const int col = k0 + jj;
      const bool ok = col < skv && (!causal || row >= col);
      s[c] = ok ? acc * scale : kNegInf;
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    m = m_new;
    float ls = 0.f;
#pragma unroll
    for (int c = 0; c < kF32BK / 4; ++c) {
      const float p = expf(s[c] - m);
      sP[r * kPS + qd + 4 * c] = p;
      ls += p;
    }
    l = l * corr + ls;
    __syncwarp();  // the row's four threads share their p
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int d = qd + 4 * e;
      if (d < dh) {
        float acc = 0.f;
#pragma unroll 8
        for (int jj = 0; jj < kF32BK; ++jj) {
          acc = fmaf(sP[r * kPS + jj], sV[jj * S + d], acc);
        }
        o[e] = o[e] * corr + acc;
      }
    }
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  l = fmaxf(l, 1e-30f);
  if (row < sq) {
    float* orow = out + bh * sq * dh + (long long)row * dh;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int d = qd + 4 * e;
      if (d < dh) orow[d] = o[e] / l;
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
inline unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int bh, group, sq, skv, dh, causal;
  float scale;
  cudaStream_t stream;
};

// the reference's 1 / sqrt(dh) rounded once to f32, times log2(e)
inline float scale_log2(const Args& a) {
  return (float)((double)a.scale * 1.4426950408889634);
}

// The maps span the true Dh, so a box's columns past it arrive as zeros;
// each box still lands whole, so every stage's transaction count is its
// full tile bytes.
template <typename T, int kSteps>
int launch_wgmma(const Args& a) {
  using L = WgLayout<kSteps>;
  const int bkvh = a.bh / a.group;
  CUtensorMap mq, mk, mv;
  if (!hopper::make_map_3d(&mq, a.q, a.dh, a.sq, a.bh, kWgBQ) ||
      !hopper::make_map_3d(&mk, a.k, a.dh, a.skv, bkvh, kWgBK) ||
      !hopper::make_map_3d(&mv, a.v, a.dh, a.skv, bkvh, kWgBK)) {
    return -4;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<T, kSteps>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int n_qtiles = (int)cdiv(a.sq, kWgBQ);
  const long long blocks = (long long)a.bh * n_qtiles;
  if (blocks > 0x7fffffffLL) return -3;
  flash_fwd_wgmma_kernel<T, kSteps>
      <<<(unsigned)blocks, kWgThreads, L::kBytes, a.stream>>>(
          mq, mk, mv, static_cast<T*>(a.out), a.bh, a.group, a.sq, a.skv,
          a.dh, a.causal, scale_log2(a), n_qtiles);
  return (int)cudaGetLastError();
}

template <typename T, int kDh>
int launch_mma(const Args& a) {
  const int smem = (kBQ + 2 * kBK) * (kDh + 8) * (int)sizeof(T);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<T, kDh>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qtiles = (int)cdiv(a.sq, kBQ);
  const long long blocks = (long long)a.bh * n_qtiles;
  if (blocks > 0x7fffffffLL) return -3;
  const int vec = aligned16(a.q) && aligned16(a.k) && aligned16(a.v);
  flash_fwd_mma_kernel<T, kDh><<<(unsigned)blocks, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.group, a.sq,
      a.skv, a.dh, a.causal, a.scale, n_qtiles, vec);
  return (int)cudaGetLastError();
}

template <int kDh>
int launch_f32(const Args& a) {
  const int smem = (kF32BQ * (kDh + 1) + 2 * kF32BK * (kDh + 1) +
                    kF32BQ * (kF32BK + 1)) * (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<kDh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qtiles = (int)cdiv(a.sq, kF32BQ);
  const long long blocks = (long long)a.bh * n_qtiles;
  if (blocks > 0x7fffffffLL) return -3;
  flash_fwd_f32_kernel<kDh><<<(unsigned)blocks, kF32Threads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.group,
      a.sq, a.skv, a.dh, a.causal, a.scale, n_qtiles);
  return (int)cudaGetLastError();
}

// the smallest Dh capacity that holds dh
template <typename T>
int dispatch_mma(const Args& a) {
  if (a.dh <= 16) return launch_mma<T, 16>(a);
  if (a.dh <= 32) return launch_mma<T, 32>(a);
  if (a.dh <= 64) return launch_mma<T, 64>(a);
  if (a.dh <= 128) return launch_mma<T, 128>(a);
  return launch_mma<T, 256>(a);
}

int dispatch_f32(const Args& a) {
  if (a.dh <= 16) return launch_f32<16>(a);
  if (a.dh <= 32) return launch_f32<32>(a);
  if (a.dh <= 64) return launch_f32<64>(a);
  if (a.dh <= 128) return launch_f32<128>(a);
  return launch_f32<256>(a);
}

// Routes of the C interface (kept in step with kernels/flash_attention.py).
enum Route : int { kRouteFma = 0, kRouteMma = 1, kRouteWgmma = 2 };

// Q K^T's k-steps for dh (a multiple of 8 from 8 up): every Dh up to 64
// runs the 64-column tile's four (no published config has Dh < 64), the
// rest ceil(dh / 16) of the 128-column tile's eight
template <typename T>
int dispatch_wgmma(const Args& a) {
  if (!(aligned16(a.q) && aligned16(a.k) && aligned16(a.v))) return -2;
  if (a.dh <= 64) return launch_wgmma<T, 4>(a);
  if (a.dh <= 80) return launch_wgmma<T, 5>(a);
  if (a.dh <= 96) return launch_wgmma<T, 6>(a);
  if (a.dh <= 112) return launch_wgmma<T, 7>(a);
  if (a.dh <= 128) return launch_wgmma<T, 8>(a);
  return -2;
}

}  // namespace

// q (bh, sq, dh), k/v (bkvh, skv, dh), out (bh, sq, dh), all of `dtype` and
// contiguous; query head h reads kv head h / (bh / bkvh).  `route`: 0 fma
// (f32), 1 mma, 2 wgmma (bf16/f16).  Returns cudaGetLastError() of the
// launch (0 = accepted), -1 unknown dtype, -2 a shape or route the kernel
// does not take, -3 too many blocks, -4 a tensor map that
// cuTensorMapEncodeTiled refused.  Does not synchronise and allocates
// nothing.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* out, int bh,
                                         int bkvh, int sq, int skv, int dh,
                                         int causal, int dtype, int route,
                                         void* stream) {
  if (bh < 1 || bkvh < 1 || bh % bkvh != 0 || sq < 1 || skv < 1 || dh < 8 ||
      dh > 256 || dh % 8 != 0) {
    return -2;
  }
  Args a{q, k, v, out, bh, bh / bkvh, sq, skv, dh, causal ? 1 : 0,
         // the reference's 1 / math.sqrt(dh), rounded once to f32
         (float)(1.0 / sqrt((double)dh)), static_cast<cudaStream_t>(stream)};
  if (dtype != repro::kF32 && dtype != repro::kBF16 && dtype != repro::kF16) {
    return -1;
  }
  if ((dtype == repro::kF32) != (route == kRouteFma)) return -2;
  switch (route) {
    case kRouteFma:
      return dispatch_f32(a);
    case kRouteMma:
      return dtype == repro::kBF16 ? dispatch_mma<__nv_bfloat16>(a)
                                   : dispatch_mma<__half>(a);
    case kRouteWgmma:
      return dtype == repro::kBF16 ? dispatch_wgmma<__nv_bfloat16>(a)
                                   : dispatch_wgmma<__half>(a);
    default:
      return -2;
  }
}
