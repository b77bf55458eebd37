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
// nothing carries over between blocks, so one block owns one (bh, 64-row
// q tile) and walks the kv tiles itself, keeping m, l and the f32
// accumulator in registers and writing the normalised tile once.  It stops
// at the causal bound ceil((q0 + 64) / 64), which skips the blocks above the
// diagonal as the TPU kernel's pl.when does.  The q tile is staged in
// shared memory once; each K/V tile is read from row bh / group of k/v, so
// grouped heads share the same rows and no repeated K/V copy exists.  Any
// Sq, Skv >= 1 is taken: rows and columns past the end are zero-filled on
// load and masked, so the "must tile evenly" padding of the TPU wrapper is
// gone.  Dh is a multiple of 8 up to 256; the kernel is instantiated for
// Dh capacities 16/32/64/128/256 and zero-fills the columns in between.
//
// Numerics (the TPU kernel upcasts q/k/v to f32 before BOTH products):
//  * bf16/f16: Q K^T runs on tensor cores (mma.sync m16n8k16) with f32
//    accumulation.  A product of two bf16 (or f16) values is exact in f32,
//    so this is the reference's f32 dot up to summation order.
//  * P V keeps p in f32 as the TPU kernel does: p is split into a hi and a
//    lo part, hi = round(p), lo = round(p - hi), both in the input dtype, and
//    P V = hi V + lo V on tensor cores.  hi + lo carries 16 significant bits
//    of p in bf16 (22 in f16), so the split's error is below 2^-16 of p,
//    far under the one rounding of the output to bf16/f16 that both the
//    kernel and the plain version make.  The accumulator registers of
//    S = Q K^T are laid out exactly as the A operand of the next mma, so p
//    never leaves registers.
//  * f32 inputs take a separate FMA kernel (32x32 tiles, four threads a q
//    row): TF32 would cost the three decimal digits the f32 callers are
//    promised.
//
// Bound on an H100: useful flops are 4 * BH * Dh * sum_i(#visible keys of
// query i), about 2 * BH * Dh * S * (S + 1) causal at Sq = Skv = S; bytes
// are (2 * BH * Sq + 2 * BKVH * Skv) * Dh * itemsize.  At the prefill shape
// of qwen2.5-3b (B=4, S=2048, H=16, KVH=2, Dh=128, bf16) that is 68.7 GFLOP
// = 69 us at 989 TFLOP/s against 71 MB = 21 us at 3.35 TB/s: operations
// bind.  This first version is single-buffered, uses mma.sync (not wgmma)
// and spends twice the tensor-core work on P V for the hi/lo split; its
// measured distance from the bound is recorded in PERF.md.
#include <math.h>

#include "common.cuh"

namespace {

using namespace repro;

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bf16 / f16: tensor-core kernel
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

// p ~= hi + lo, both in T; returns the two packed pairs for (x0, x1).
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const T h0 = from_f32<T>(x0), h1 = from_f32<T>(x1);
  hi = pack2(h0, h1);
  lo = pack2(from_f32<T>(x0 - to_f32(h0)), from_f32<T>(x1 - to_f32(h1)));
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

    // O += P V, p kept to 2^-16 by the hi/lo split
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t hi[4], lo[4];
      split2<T>(s[2 * c][0], s[2 * c][1], hi[0], lo[0]);
      split2<T>(s[2 * c][2], s[2 * c][3], hi[1], lo[1]);
      split2<T>(s[2 * c + 1][0], s[2 * c + 1][1], hi[2], lo[2]);
      split2<T>(s[2 * c + 1][2], s[2 * c + 1][3], hi[3], lo[3]);
      const T* vp = sV + (c * 16 + t * 2) * S + g;
#pragma unroll
      for (int dt = 0; dt < kND; ++dt) {
        if (dt < dh8) {
          const T* vq = vp + dt * 8;
          const uint32_t b0 = pack2(vq[0], vq[S]);
          const uint32_t b1 = pack2(vq[8 * S], vq[9 * S]);
          mma16816(o[dt], hi, b0, b1, T());
          mma16816(o[dt], lo, b0, b1, T());
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

}  // namespace

// q (bh, sq, dh), k/v (bkvh, skv, dh), out (bh, sq, dh), all of `dtype` and
// contiguous; query head h reads kv head h / (bh / bkvh).  Returns
// cudaGetLastError() of the launch (0 = accepted), -1 unknown dtype, -2 a
// shape the kernel does not take, -3 too many blocks.  Does not synchronise
// and allocates nothing.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* out, int bh,
                                         int bkvh, int sq, int skv, int dh,
                                         int causal, int dtype, void* stream) {
  if (bh < 1 || bkvh < 1 || bh % bkvh != 0 || sq < 1 || skv < 1 || dh < 8 ||
      dh > 256 || dh % 8 != 0) {
    return -2;
  }
  Args a{q, k, v, out, bh, bh / bkvh, sq, skv, dh, causal ? 1 : 0,
         // the reference's 1 / math.sqrt(dh), rounded once to f32
         (float)(1.0 / sqrt((double)dh)), static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case repro::kF32: return dispatch_f32(a);
    case repro::kBF16: return dispatch_mma<__nv_bfloat16>(a);
    case repro::kF16: return dispatch_mma<__half>(a);
    default: return -1;
  }
}
