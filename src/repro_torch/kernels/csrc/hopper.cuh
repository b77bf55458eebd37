// Hopper (sm_90a) building blocks shared by the redesigned kernels, as
// inline PTX: mbarriers, the async-proxy fence, cp.async with zero fill,
// TMA tile loads from a tensor map (multicast to the blocks of a cluster
// too), 1-D bulk loads and TMA tile stores, thread block clusters (rank,
// cluster barrier, an arrival on a peer block's mbarrier), wgmma
// (shared-memory descriptors with the 128-byte swizzle, fence / commit /
// wait, m64nNk16 bf16/f16 -> f32 with A from shared memory or registers),
// setmaxnreg and named barriers; on the host, the tensor-map encoder
// (cuTensorMapEncodeTiled) looked up at run time through the CUDA runtime,
// so the library needs no -lcuda.
//
// Shared-memory tiles are stacks of 128-byte swizzle atoms: 8 rows of 128
// bytes (64 16-bit values), 16-byte chunk c of row r stored at chunk
// c ^ (r % 8), each atom 1024-byte aligned.  A TMA load through a tensor
// map with CU_TENSOR_MAP_SWIZZLE_128B and a 64-element inner box writes
// exactly that; `swizzle128` gives the same address for a store from
// registers.  wgmma reads such a tile through `desc_sw128`:
//  * K-major operand (the contraction dimension contiguous): rows are M or
//    N, 8-row groups 1024 bytes apart (SBO); the k16 step s starts 32 * s
//    bytes into the atom; LBO is unused.
//  * MN-major operand (M or N contiguous, the transpose flag set): rows
//    are k, 8-row groups 1024 bytes apart (SBO), the next 64 values of M/N
//    LBO bytes on (the next atom column); the k16 step s starts
//    2048 * s bytes on.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace repro {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and the
// other threads; follow with a __syncthreads().
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival, and `bytes` more expected from async copies this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Blocks until the phase of parity `parity` has completed.  A fresh
// barrier is in phase 0, so waiting on parity 1 passes at once: the
// producer of a ring waits on (round & 1) ^ 1 for a free stage, the
// consumer on (round & 1) for a full one.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this thread's generic-proxy shared-memory writes before later
// reads by the async proxy (wgmma, TMA store).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bar.sync on named barrier `id` (1..15; 0 is __syncthreads) by `threads`.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// cp.async: global -> shared in this thread's commit groups
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes (one index or scale); zeros in place of an invalid source.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
// An arrival on `bar` once every cp.async this thread issued so far has
// landed (the barrier's count must include it: .noinc).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------
// One tile of a 3-D tensor map at coordinates (c0 innermost, c1, c2) into
// shared memory; completion is counted in bytes on `bar`.  Elements past
// the tensor's extent arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The same tile written into the shared memory of every block of the
// cluster named in `cta_mask` (bit r: rank r), each at the offset `dst` has
// in this block, its bytes counted on the barrier at `bar`'s offset in each
// of them.
__device__ __forceinline__ void tma_load_3d_multicast(
    void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
    uint16_t cta_mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "h"(cta_mask)
      : "memory");
}

// A 1-D bulk copy, no tensor map: `bytes` contiguous bytes (a multiple of
// 16, both addresses 16-byte aligned) from global into shared memory,
// counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// thread block clusters
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives, then waits for all:
// shared-memory writes and barrier inits before it are visible to the whole
// cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// One arrival on the barrier at `bar`'s offset in the shared memory of
// cluster block `rank` (this block's own included).  The default .release
// at CTA scope: a cluster-scope release here made every arrival wait on the
// thread's outstanding memory operations and cost about 1 us a pipeline
// step on an H100 (PERF.md).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}

// ---------------------------------------------------------------------------
// TMA stores: shared -> global in this thread's bulk groups
// ---------------------------------------------------------------------------
// One tile of a 2-D tensor map at coordinates (c0 innermost, c1) from
// shared memory; elements past the tensor's extent are not written.  The
// generic-proxy writes of the tile must be fenced (fence_proxy_async) and
// synchronised with the issuing thread first.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's bulk groups still read their
// shared-memory source (the source may then be rewritten).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Waits until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// shared-memory layout and wgmma descriptors
// ---------------------------------------------------------------------------
// Byte offset of 16-bit element (row, col) in a stack of 128-byte swizzle
// atoms of 64 columns (col < 64).
__device__ __forceinline__ uint32_t swizzle128(int row, int col) {
  return (uint32_t)(row * 128 + ((((col >> 3) ^ row) & 7) << 4) +
                    ((col & 7) << 1));
}

// wgmma matrix descriptor of a 128-byte-swizzled tile starting at `smem`.
__device__ __forceinline__ uint64_t desc_sw128(const void* smem,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;  // layout type 1: 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups of this warp are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the accumulator registers in place across a wgmma issue or wait, so
// the compiler neither reads them before the wait nor moves them between
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define REPRO_WGMMA_D64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define REPRO_WGMMA_OUT64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define REPRO_WGMMA_D128 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define REPRO_WGMMA_OUT128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// D (64 x N, f32) = A (64 x 16) * B (16 x N) [+ D when `accumulate`].
// wgmma_ss: A and B from shared-memory descriptors, kTA / kTB = 1 for an
// MN-major operand.  wgmma_rs: A from registers (four 32-bit registers a
// thread, the mma.sync m16n8k16 A-fragment of the warp's 16 rows), B from
// a descriptor.
#define REPRO_DEFINE_WGMMA(TY, CT)                                           \
  template <int kTA, int kTB>                                                \
  __device__ __forceinline__ void wgmma_ss64(CT, float (&d)[32], uint64_t da, \
                                             uint64_t db, int acc) {         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY    \
                 " " REPRO_WGMMA_D64 ", %32, %33, p, 1, 1, %35, %36;\n}\n"   \
                 : REPRO_WGMMA_OUT64(d)                                      \
                 : "l"(da), "l"(db), "r"(acc), "n"(kTA), "n"(kTB));          \
  }                                                                          \
  template <int kTA, int kTB>                                                \
  __device__ __forceinline__ void wgmma_ss128(CT, float (&d)[64],            \
                                              uint64_t da, uint64_t db,      \
                                              int acc) {                     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY   \
                 " " REPRO_WGMMA_D128 ", %64, %65, p, 1, 1, %67, %68;\n}\n"  \
                 : REPRO_WGMMA_OUT128(d)                                     \
                 : "l"(da), "l"(db), "r"(acc), "n"(kTA), "n"(kTB));          \
  }                                                                          \
  template <int kTB>                                                         \
  __device__ __forceinline__ void wgmma_rs64(CT, float (&d)[32],             \
                                             const uint32_t (&a)[4],         \
                                             uint64_t db, int acc) {         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY    \
                 " " REPRO_WGMMA_D64                                         \
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"           \
                 : REPRO_WGMMA_OUT64(d)                                      \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                   "r"(acc), "n"(kTB));                                      \
  }                                                                          \
  template <int kTB>                                                         \
  __device__ __forceinline__ void wgmma_rs128(CT, float (&d)[64],            \
                                              const uint32_t (&a)[4],        \
                                              uint64_t db, int acc) {        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY   \
                 " " REPRO_WGMMA_D128                                        \
                 ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"           \
                 : REPRO_WGMMA_OUT128(d)                                     \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                   "r"(acc), "n"(kTB));                                      \
  }

REPRO_DEFINE_WGMMA("bf16", __nv_bfloat16)
REPRO_DEFINE_WGMMA("f16", __half)
#undef REPRO_DEFINE_WGMMA

template <typename T, int N, int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int acc) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 64) {
    wgmma_ss64<kTA, kTB>(T(), d, da, db, acc);
  } else {
    wgmma_ss128<kTA, kTB>(T(), d, da, db, acc);
  }
}

template <typename T, int N, int kTB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  if constexpr (N == 64) {
    wgmma_rs64<kTB>(T(), d, a, db, acc);
  } else {
    wgmma_rs128<kTB>(T(), d, a, db, acc);
  }
}

// ---------------------------------------------------------------------------
// register reallocation between warpgroups (all four warps execute it)
// ---------------------------------------------------------------------------
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------
// cuTensorMapEncodeTiled, looked up once through the CUDA runtime's
// entry-point query (no link against libcuda); null if it is missing.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over a contiguous (d2, d1, d0) tensor of 16-bit elements
// (d0 innermost) with box (64, box1, 1) and the 128-byte swizzle; reads
// past any extent give zeros.  Needs a 16-byte-aligned base and d0 % 8 ==
// 0 (every stride a multiple of 16 bytes).  Returns false if the encoder
// refuses.  Costs a few microseconds of host time a map.
inline bool make_map_3d(CUtensorMap* map, const void* base, uint64_t d0,
                        uint64_t d1, uint64_t d2, uint32_t box1) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {64, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  // the data type only sets the element size here: TMA copies bits
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D map over a contiguous (d1, d0) f32 tensor (d0 innermost) with box
// (32, box1) and the 128-byte swizzle: rows of 32 floats, 16-byte chunk c
// of row r at chunk c ^ (r % 8).  A store writes nothing past any extent.
// Needs a 16-byte-aligned base and d0 % 4 == 0.
inline bool make_map_2d_f32(CUtensorMap* map, void* base, uint64_t d0,
                            uint64_t d1, uint32_t box1) {
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {d0, d1};
  const cuuint64_t strides[1] = {d0 * 4};
  const cuuint32_t box[2] = {32, box1};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace repro
