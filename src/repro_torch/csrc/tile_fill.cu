// The fill table of the neighbor_mean policy: for every logical tile of a
// 2-D view, the f32 mean of its non-fatal lanes, rounded to the storage
// dtype, as a bit pattern.
//
// Replaces the neighbor_mean branch of src/repro/kernels/common.py:153
// (`repair_value`), which every Pallas kernel reaches through `repair_tile`
// on its VMEM tile.  The Hopper kernels do not run on the reference's
// tiles (their physical tiles are larger, smaller or split across blocks),
// and the paged kernels see one KV head of a page at a time, so none of
// them can form the mean of the logical tile in passing.  This kernel
// writes one entry per logical tile before the kernel that repairs runs on
// the same stream; that kernel reads the entry of a fatal lane's tile
// (repro::Fill), and the in-place scrub finds the table complete before it
// writes any lane.
//
// What it computes, per tile T (the reference's arithmetic):
//   fill(T) = dtype(sum_{x in T, not fatal} f32(x) / max(#{not fatal}, 1))
// with an IEEE f32 division (the build has no --use_fast_math) and
// round-to-nearest-even into the storage dtype; an all-fatal tile takes 0.
// The detector's count-valid bound (slot 6) plays no part: lanes that are
// not counted are still in the mean.
//
// The view: `rows` rows of `cols` lanes, row r at x + r * row_stride, or,
// with a page map, at x + ids[r / rows_per_page] * page_stride +
// (r % rows_per_page) * row_stride (scrub_pages' gathered view; the paged
// pools' layer is the plain form with one row per page).  Tiles are
// (br, bc), row-major over the grid of rows / br by cols / bc.
//
// What bounds it on an H100: bytes, the view read once over 3.35 TB/s.
// One block per tile, each thread summing lanes e, e + 256, ... of the tile
// in order (row and column stepped without a division per lane, four loads
// in flight), then a fixed-order tree over the block: no atomics, so the
// table is the same from run to run.  A call with few large tiles (the
// matmul's 256 x 512 A tiles) fills few SMs; the scans that already read
// each tile could form the sums instead (ROADMAP).
#include "repair.cuh"

namespace {

using repro::Detector;
using repro::Storage;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // loads in flight a thread

struct View {
  long long cols, row_stride, br, bc, n_tc;
  const int* ids;  // null: no page map
  long long rows_per_page, page_stride;
};

template <typename bits_t>
__device__ __forceinline__ const bits_t* row_at(const bits_t* x, const View& v,
                                                long long r) {
  if (!v.ids) return x + r * v.row_stride;
  const long long p = r / v.rows_per_page;
  return x + (long long)__ldg(v.ids + p) * v.page_stride +
         (r - p * v.rows_per_page) * v.row_stride;
}

template <int DT>
__global__ void __launch_bounds__(kThreads)
    tile_fill(const typename Storage<DT>::bits_t* __restrict__ x, View v,
              Detector det, uint32_t* __restrict__ fills) {
  __shared__ float s_sum[kThreads];
  __shared__ int s_cnt[kThreads];
  const long long tile = blockIdx.x;
  const long long tr = tile / v.n_tc;
  const long long r0 = tr * v.br, c0 = (tile - tr * v.n_tc) * v.bc;
  // lane e of the tile: row e / bc, column e % bc; a step of kThreads
  // lanes is dr rows and dc columns
  const long long dr = kThreads / v.bc, dc = kThreads - dr * v.bc;
  long long r = threadIdx.x / v.bc, c = threadIdx.x - r * v.bc;
  float sum = 0.f;
  int cnt = 0;
  long long at = -1;
  const typename Storage<DT>::bits_t* row = nullptr;
  while (r < v.br) {
    // kUnroll independent loads in flight, then their sums in lane order
    uint32_t b[kUnroll];
    bool in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      in[u] = r < v.br;
      b[u] = 0u;
      if (in[u]) {
        if (r != at) {
          row = row_at(x, v, r0 + r) + c0;
          at = r;
        }
        b[u] = row[c];
      }
      c += dc;
      r += dr;
      if (c >= v.bc) {
        c -= v.bc;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (in[u] && !repro::classify(b[u], det)) {
        sum += Storage<DT>::to_float(b[u]);
        ++cnt;
      }
  }
  s_sum[threadIdx.x] = sum;
  s_cnt[threadIdx.x] = cnt;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      s_sum[threadIdx.x] += s_sum[threadIdx.x + s];
      s_cnt[threadIdx.x] += s_cnt[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float n = (float)(s_cnt[0] > 1 ? s_cnt[0] : 1);
    fills[tile] = Storage<DT>::from_float(s_sum[0] / n);
  }
}

}  // namespace

// x: the storage (dtype 0 f32, 1 bf16, 2 f16) on the device; the view of
// `rows` x `cols` lanes as above (ids: device int32 page ids, or null);
// (br, bc) the logical tile, which must divide (rows, cols); det: host
// int32[8]; fills: uint32[(rows / br) * (cols / bc)] out, each entry the
// fill's bit pattern in the storage dtype (16-bit patterns zero-extended).
// Returns cudaGetLastError() after the one launch.
extern "C" int repro_tile_fill(const void* x, int dtype, long long rows,
                               long long cols, long long row_stride,
                               long long br, long long bc, const int* ids,
                               long long rows_per_page, long long page_stride,
                               const int* det, unsigned int* fills,
                               void* stream) {
  if (rows < 0 || cols < 0 || br < 1 || bc < 1 || rows % br || cols % bc ||
      (ids && rows_per_page < 1))
    return (int)cudaErrorInvalidValue;
  const long long n_tc = cols / bc, tiles = rows / br * n_tc;
  if (tiles == 0) return (int)cudaSuccess;
  if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const View v{cols, row_stride, br, bc, n_tc, ids, rows_per_page, page_stride};
  const Detector d = repro::detector_from(det);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::DT_F32:
      tile_fill<repro::DT_F32><<<(unsigned)tiles, kThreads, 0, s>>>(
          static_cast<const uint32_t*>(x), v, d, fills);
      break;
    case repro::DT_BF16:
      tile_fill<repro::DT_BF16><<<(unsigned)tiles, kThreads, 0, s>>>(
          static_cast<const uint16_t*>(x), v, d, fills);
      break;
    case repro::DT_F16:
      tile_fill<repro::DT_F16><<<(unsigned)tiles, kThreads, 0, s>>>(
          static_cast<const uint16_t*>(x), v, d, fills);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
