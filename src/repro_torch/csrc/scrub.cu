// In-place scrub of a buffer, or of a list of its pages: the memory-
// repairing mechanism (paper §3.4) as one pass over HBM.
//
// Replaces src/repro/kernels/scrub.py::_scrub_kernel (the Pallas kernel
// behind `scrub` and `scrub_pages`).  Differences from the TPU version:
//   * It writes back in place into the caller's tensor (the JAX version
//     returns a new array that XLA aliases onto the input).  Only fatal
//     lanes are written.
//   * `scrub_pages` reads the pages where they lie, through the id list,
//     instead of gathering them into a contiguous view and scattering back.
//     Counts stay on the reference's logical grid: tiles of
//     fit_blocks(n_ids * rows_per_page, cols) over the *gathered* view, so a
//     tile may straddle two pages.  Rows at or past the count-valid bound
//     (the bucketed plan's padding duplicates) are not counted and, since
//     they duplicate valid pages, not visited at all: the wrapper checks
//     that they are duplicates, which keeps two blocks from racing on one
//     page.
// What bounds it on an H100: bytes.  Every lane is read once (an 8-byte
// word of work per lane at most) and only fatal lanes are written, so the
// floor is the buffer's size over 3.35 TB/s.  The design keeps the loads
// coalesced (consecutive threads read consecutive columns of one row) and
// spreads each logical tile over several blocks, which add their counts
// into a per-tile pair with integer atomics; a one-block epilogue turns the
// per-tile pairs into [nan, inf, tiles with >= 1 counted fatal lane].
#include "repair.cuh"

namespace {

using repro::Detector;

constexpr int kThreads = 256;
constexpr long long kChunk = 8192;  // lanes per block

template <typename bits_t>
__global__ void scrub_tiles(bits_t* x, const int* ids, long long rows_per_page,
                            long long page_stride, long long cols,
                            long long rows_process, long long count_rows,
                            long long br, long long bc, long long rb,
                            long long n_tiles_c, Detector det, bits_t fill,
                            int* tile_counts) {
  __shared__ int cnt[2];
  if (threadIdx.x < 2) cnt[threadIdx.x] = 0;
  __syncthreads();
  const long long tile = blockIdx.x;
  const long long tr = tile / n_tiles_c, tc = tile % n_tiles_c;
  const long long row0 = tr * br + (long long)blockIdx.y * rb;
  long long row1 = row0 + rb;
  if (row1 > tr * br + br) row1 = tr * br + br;
  if (row1 > rows_process) row1 = rows_process;
  const long long n = row0 < row1 ? (row1 - row0) * bc : 0;
  int n_nan = 0, n_inf = 0;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    const long long r = row0 + i / bc;
    const long long c = tc * bc + i % bc;
    const long long page = r / rows_per_page;
    const long long base = (ids ? (long long)ids[page] : page) * page_stride;
    bits_t* p = x + base + (r % rows_per_page) * cols + c;
    const uint32_t b = *p;
    const int cls = repro::classify(b, det);
    if (cls) {
      *p = fill;
      if (count_rows == 0 || r < count_rows) {
        n_nan += cls & 1;
        n_inf += cls >> 1;
      }
    }
  }
  repro::block_add(&cnt[0], n_nan);
  repro::block_add(&cnt[1], n_inf);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (cnt[0]) atomicAdd(&tile_counts[2 * tile], cnt[0]);
    if (cnt[1]) atomicAdd(&tile_counts[2 * tile + 1], cnt[1]);
  }
}

__global__ void scrub_finalize(const int* tile_counts, long long n_tiles,
                               int* counts) {
  __shared__ int acc[3];
  if (threadIdx.x < 3) acc[threadIdx.x] = 0;
  __syncthreads();
  int n_nan = 0, n_inf = 0, events = 0;
  for (long long t = threadIdx.x; t < n_tiles; t += blockDim.x) {
    const int a = tile_counts[2 * t], b = tile_counts[2 * t + 1];
    n_nan += a;
    n_inf += b;
    events += (a + b) > 0;
  }
  repro::block_add(&acc[0], n_nan);
  repro::block_add(&acc[1], n_inf);
  repro::block_add(&acc[2], events);
  __syncthreads();
  if (threadIdx.x < 3) counts[threadIdx.x] = acc[threadIdx.x];
}

template <typename bits_t>
cudaError_t launch(void* x, const int* ids, long long rows_per_page,
                   long long page_stride, long long cols,
                   long long rows_process, long long count_rows, long long br,
                   long long bc, const int* det_host, unsigned int fill,
                   int* tile_counts, int* counts, cudaStream_t stream) {
  const long long n_tiles_r = (rows_process + br - 1) / br;
  const long long n_tiles_c = cols / bc;
  const long long n_tiles = n_tiles_r * n_tiles_c;
  long long rb = kChunk / bc;
  if (rb < 1) rb = 1;
  if (rb > br) rb = br;
  const long long chunks = (br + rb - 1) / rb;
  if (n_tiles > 0) {
    dim3 grid((unsigned)n_tiles, (unsigned)chunks);
    scrub_tiles<bits_t><<<grid, kThreads, 0, stream>>>(
        static_cast<bits_t*>(x), ids, rows_per_page, page_stride, cols,
        rows_process, count_rows, br, bc, rb, n_tiles_c,
        repro::detector_from(det_host), (bits_t)fill, tile_counts);
  }
  scrub_finalize<<<1, kThreads, 0, stream>>>(tile_counts, n_tiles, counts);
  return cudaGetLastError();
}

}  // namespace

// x: the buffer (element width 2 or 4 bytes); ids: device int32 page ids or
// null (whole buffer as one page); det: host int32[8]; fill: the repaired
// lane's bit pattern; tile_counts: zeroed int32[2 * n_tiles] scratch;
// counts: int32[3] out.  Returns cudaGetLastError() after the launches.
extern "C" int repro_scrub(void* x, int elem_bytes, const int* ids,
                           long long rows_per_page, long long page_stride,
                           long long cols, long long rows_process,
                           long long count_rows, long long br, long long bc,
                           const int* det, unsigned int fill, int* tile_counts,
                           int* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return (int)launch<uint32_t>(x, ids, rows_per_page, page_stride, cols,
                                 rows_process, count_rows, br, bc, det, fill,
                                 tile_counts, counts, s);
  if (elem_bytes == 2)
    return (int)launch<uint16_t>(x, ids, rows_per_page, page_stride, cols,
                                 rows_process, count_rows, br, bc, det, fill,
                                 tile_counts, counts, s);
  return (int)cudaErrorInvalidValue;
}
