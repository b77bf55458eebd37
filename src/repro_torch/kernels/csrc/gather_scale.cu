// gather_scale: out[b, t, :] = round_T(f32(x[b, idx[b, t], :]) * scale[b, t])
//
// Replaces the TPU kernel src/repro/kernels/gather_scale.py::gather_scale,
// which prefetches idx into scalar memory and lets each grid step's block
// index map pick its source row, one (1, block_d) DMA per step, with d
// padded to a multiple of block_d by the wrapper.
//
// Bound on an H100: bytes.  The distinct source rows are read once and the
// B*k output rows written once (2*B*k*d*itemsize at most, plus 8*B*k for
// idx and scale) against 3.35 TB/s; one multiply per element is nothing.
// At the train path's H' gather (B=4, k=307, bf16) that is 3.0 us at
// d=2048 and 16.1 us at d=11008.  What keeps a gather from that bound is
// bytes in flight: holding 3.35 TB/s over a DRAM round trip of ~0.7 us
// takes ~2.5 MB in flight, spread over every SM.
//
// Two routes (kernels/gather_scale.py: gather_route picks one):
//
//  * bulk (a row of d*itemsize bytes a multiple of 16, x and out 16-byte
//    aligned): the work is sized by bytes, not rows.  The flattened output
//    (B*k rows) is cut into items of at most kChunk = 4 KB: up to
//    kRowsPerItem whole rows where rows are narrow, nearly equal pieces of
//    one row where they are wide.  A persistent grid of min(items, SMs *
//    blocks an SM) blocks strides over the items, so 614 rows of 48 KB
//    fill every SM as 12,288 rows of 1 KB do.  Each block has a ring of
//    kStages = 2 stages in shared memory and keeps both in flight: warp 0's
//    lanes read their rows' indices and scales one item ahead, assert each
//    index before the copy from it is issued, and issue one 1-D bulk async
//    copy a row (a piece) onto the stage's mbarrier, so the copy engine and
//    not the threads' registers holds the bytes in flight.  The block waits
//    on the stage (one phase bit a stage, flipping every lap of the ring),
//    scales it with 16-byte vectors (f32 multiply, one rounding) and stores
//    them straight to the output, whose rows of an item are contiguous; a
//    block barrier then frees the stage for its next item.  Storing from
//    registers beat a 1-D bulk store of the scaled stage at the narrow
//    shapes, where the bulk store's fence, barrier and read-back wait lie
//    on each item's path (PERF.md).
//  * warp (any other width or alignment): one warp owns one output row: its
//    lane 0 reads the row's index and scale, the warp copies the source
//    row with 16-byte loads and stores on neighbouring lanes (an
//    element-wise loop where a ragged d breaks 16-byte alignment),
//    multiplying in f32 and rounding once on the way.
//
// Nothing is padded.  An index outside [0, n) stops the kernel with a
// device-side assert (common.cuh: assert_row) on both routes.
#include "hopper.cuh"

namespace {

using namespace repro;

// ---------------------------------------------------------------------------
// warp route
// ---------------------------------------------------------------------------
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
int launch_warp(const void* x, const void* idx, const void* scale, void* out,
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

// ---------------------------------------------------------------------------
// bulk route
// ---------------------------------------------------------------------------
// The ring: kStages stages of kChunk bytes a block.  Chosen on an H100
// against 2-8 stages of 2-32 KB at 64-256 threads (PERF.md): deeper rings
// buy nothing once every SM holds ten blocks' copies in flight, and small
// stages keep the narrow main-path shapes as fast as the warp route.
constexpr int kChunk = 4096;
constexpr int kStages = 2;
constexpr int kBulkThreads = 128;
constexpr int kRowsPerItem = 32;  // one row a lane of the producer warp
// the stages, their mbarriers and their rows' scales
constexpr int kBulkSmem =
    kStages * kChunk + kStages * 8 + kStages * kRowsPerItem * 4;

// How the flattened output is cut into items: `per_item` whole rows an item
// (pieces == 1), or a row cut into `pieces` pieces of `piece` bytes, the
// last one no longer (per_item == 1).
struct BulkGeometry {
  long long rows;       // B*k
  long long items;
  long long row_bytes;  // d * itemsize, a multiple of 16
  int per_item;
  int pieces;
  int piece;            // bytes, a multiple of 16
};

// Item `i`'s first output row, its row count, its byte offset inside that
// row and its bytes (a multiple of 16, at most a stage).
struct Span {
  long long row0;
  long long off;
  int nrows;
  int bytes;
};

__device__ __forceinline__ Span item_span(const BulkGeometry& g,
                                          long long i) {
  Span sp;
  if (g.pieces == 1) {
    sp.row0 = i * g.per_item;
    const long long left = g.rows - sp.row0;
    sp.nrows = (int)(left < g.per_item ? left : g.per_item);
    sp.off = 0;
    sp.bytes = (int)(sp.nrows * g.row_bytes);
  } else {
    sp.row0 = i / g.pieces;
    sp.off = (i % g.pieces) * (long long)g.piece;
    const long long left = g.row_bytes - sp.off;
    sp.nrows = 1;
    sp.bytes = (int)(left < g.piece ? left : g.piece);
  }
  return sp;
}

template <typename T>
__global__ void __launch_bounds__(kBulkThreads)
gather_scale_bulk_kernel(const T* __restrict__ x,
                         const int* __restrict__ idx,
                         const float* __restrict__ scale, T* __restrict__ out,
                         int n, int k, BulkGeometry geo) {
  constexpr int E = Chunk<T>::kElems;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * kChunk);
  float* scales = reinterpret_cast<float*>(bars + kStages);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long first = blockIdx.x;
  const long long stride = gridDim.x;
  // the launch makes gridDim.x <= items, so every block has an item
  const long long mine = (geo.items - first + stride - 1) / stride;

  // Warp 0, lane l: the index and scale of the l-th row of the block's
  // j-th item, read ahead of its copy so the read's latency overlaps the
  // ring's work.
  auto fetch = [&](long long j, int& r, float& f) {
    const Span sp = item_span(geo, first + j * stride);
    if (lane < sp.nrows) {
      const long long g = sp.row0 + lane;
      r = __ldg(idx + g);
      f = __ldg(scale + g);
    }
  };
  // Warp 0: the block's j-th item into stage j % kStages.  Each lane checks
  // its row's index before it issues the row's copy; the scale goes beside
  // the stage.  The lanes' scale writes are ordered before lane 0's arrival
  // (__syncwarp), whose release the consumers' wait acquires.
  auto issue = [&](long long j, int r, float f) {
    const Span sp = item_span(geo, first + j * stride);
    const int s = (int)(j % kStages);
    if (lane < sp.nrows) {
      assert_row(r, n);
      scales[s * kRowsPerItem + lane] = f;
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive_expect_tx(&bars[s], (uint32_t)sp.bytes);
    __syncwarp();
    if (lane < sp.nrows) {
      const long long b = (sp.row0 + lane) / k;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(x) +
                                 ((b * n + r) * geo.row_bytes + sp.off);
      const uint32_t bytes =
          sp.nrows == 1 ? (uint32_t)sp.bytes : (uint32_t)geo.row_bytes;
      hopper::bulk_load(smem + s * kChunk + lane * geo.row_bytes, src, bytes,
                        &bars[s]);
    }
  };

  // Every stage in flight before the first is consumed.  The first
  // indices are read while the barriers are made.
  int r[kStages];
  float f[kStages];
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < kStages; ++j) {
      r[j] = 0;
      f[j] = 0.f;
      if (j < mine) fetch(j, r[j], f[j]);
    }
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&bars[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < kStages; ++j) {
      if (j < mine) issue(j, r[j], f[j]);
    }
  }
  const int vec_per_row = (int)(geo.row_bytes / 16);
  for (long long j = 0; j < mine; ++j) {
    const int s = (int)(j % kStages);
    const long long next = j + kStages;  // the item refilling this stage
    int nr = 0;
    float nf = 0.f;
    if (warp == 0 && next < mine) fetch(next, nr, nf);
    const Span sp = item_span(geo, first + j * stride);
    // a stage's (j / kStages)-th fill completes its barrier's phase of
    // that parity
    hopper::mbar_wait(&bars[s], (uint32_t)((j / kStages) & 1));
    const uint4* stage = reinterpret_cast<const uint4*>(smem + s * kChunk);
    uint4* dst = reinterpret_cast<uint4*>(
        reinterpret_cast<unsigned char*>(out) + sp.row0 * geo.row_bytes +
        sp.off);
    const float* sc = scales + s * kRowsPerItem;
    const int nvec = sp.bytes / 16;
    for (int v = tid; v < nvec; v += kBulkThreads) {
      const float m = sc[sp.nrows == 1 ? 0 : v / vec_per_row];
      uint4 raw = stage[v];
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int q = 0; q < E; ++q) e[q] = from_f32<T>(to_f32(e[q]) * m);
      dst[v] = raw;
    }
    // every thread has read stage s: warp 0 may refill it
    __syncthreads();
    if (warp == 0 && next < mine) issue(next, nr, nf);
  }
}

// The resident blocks an SM (on an H100 the registers bound it: ten in
// bf16, at 48 registers a thread), read once per dtype instance; a
// negative count carries the error of the query.
template <typename T>
int bulk_blocks_per_sm() {
  static const int per_sm = [] {
    int blocks = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, gather_scale_bulk_kernel<T>, kBulkThreads, kBulkSmem);
    return e == cudaSuccess ? blocks : -(int)e;
  }();
  return per_sm;
}

template <typename T>
int launch_bulk(const void* x, const void* idx, const void* scale, void* out,
                int nb, int n, int k, int d, cudaStream_t stream) {
  BulkGeometry geo;
  geo.row_bytes = (long long)d * (long long)sizeof(T);
  // the bulk copies move multiples of 16 bytes between 16-byte boundaries
  if (geo.row_bytes % 16 != 0 || !aligned16(x) || !aligned16(out)) return -2;
  const int per_sm = bulk_blocks_per_sm<T>();
  if (per_sm < 0) return -per_sm;
  if (per_sm == 0) return -5;
  geo.rows = (long long)nb * k;
  if (geo.row_bytes <= kChunk) {
    const long long fit = kChunk / geo.row_bytes;
    geo.per_item = (int)(fit < kRowsPerItem ? fit : kRowsPerItem);
    geo.pieces = 1;
    geo.piece = (int)(geo.per_item * geo.row_bytes);
    geo.items = (geo.rows + geo.per_item - 1) / geo.per_item;
  } else {
    // pieces of one size, so a block's share of bytes does not hang on
    // which pieces the grid's stride hands it
    const long long cut = (geo.row_bytes + kChunk - 1) / kChunk;
    geo.piece = (int)(((geo.row_bytes + cut - 1) / cut + 15) / 16 * 16);
    geo.pieces = (int)((geo.row_bytes + geo.piece - 1) / geo.piece);
    geo.per_item = 1;
    geo.items = geo.rows * geo.pieces;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long slots = (long long)sms * per_sm;
  const unsigned grid = (unsigned)(geo.items < slots ? geo.items : slots);
  gather_scale_bulk_kernel<T><<<grid, kBulkThreads, kBulkSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(idx),
      static_cast<const float*>(scale), static_cast<T*>(out), n, k, geo);
  return (int)cudaGetLastError();
}

// Routes of the C interface (kept in step with kernels/gather_scale.py).
enum Route : int { kRouteWarp = 0, kRouteBulk = 1 };

template <typename T>
int launch(const void* x, const void* idx, const void* scale, void* out,
           int nb, int n, int k, int d, int route, cudaStream_t stream) {
  switch (route) {
    case kRouteWarp:
      return launch_warp<T>(x, idx, scale, out, nb, n, k, d, stream);
    case kRouteBulk:
      return launch_bulk<T>(x, idx, scale, out, nb, n, k, d, stream);
    default:
      return -2;
  }
}

}  // namespace

// x (nb, n, d) of `dtype`, idx (nb, k) int32, scale (nb, k) f32, out
// (nb, k, d) of `dtype`; all contiguous.  `route`: 0 warp (any shape), 1
// bulk (d * itemsize a multiple of 16, x and out 16-byte aligned).
// Returns cudaGetLastError() of the launch (0 = accepted), -1 on an
// unknown dtype code, -2 on an empty shape or a route the operands do not
// fit, -5 if no block of the bulk route fits on an SM.  Does not
// synchronise and allocates nothing.
extern "C" int repro_gather_scale(const void* x, const void* idx,
                                  const void* scale, void* out, int nb, int n,
                                  int k, int d, int dtype, int route,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb < 1 || n < 1 || k < 1 || d < 1) return -2;
  switch (dtype) {
    case repro::kF32:
      return launch<float>(x, idx, scale, out, nb, n, k, d, route, s);
    case repro::kBF16:
      return launch<__nv_bfloat16>(x, idx, scale, out, nb, n, k, d, route,
                                   s);
    case repro::kF16:
      return launch<__half>(x, idx, scale, out, nb, n, k, d, route, s);
    default:
      return -1;
  }
}
