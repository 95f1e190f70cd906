// In-place scrub of a buffer, or of a list of its pages: the memory-
// repairing mechanism (paper §3.4) as one streaming pass over HBM.
//
// Replaces src/repro/kernels/scrub.py:38 (_scrub_kernel, the Pallas kernel
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
//     that they are duplicates, which keeps two blocks off one page.
//
// What bounds it on an H100: bytes (each lane read once, only fatal lanes
// written: the buffer's size over 3.35 TB/s) and, at the engine's size (a
// few pages, well under a microsecond of bytes), launch latency.  The design
// does this about them:
//   * Bytes.  A page is one contiguous run, so the logical grid plays no
//     part in the loads: a block takes a chunk of one page's 16-byte words,
//     reads the page id once and computes one 64-bit base; each thread keeps
//     kUnroll 16-byte streaming loads (`ld.global.cs`) in flight, neighbouring
//     threads on neighbouring words, with 32-bit offsets and no division or
//     modulo per lane.  A per-lane test on the exponent field (and the
//     detector's bit pattern) is all a clean word costs, and the streaming
//     loop holds nothing else; a warp where some lane passes that test
//     (`__any_sync`) reads its words of the chunk again, and only the words
//     that hold a candidate go through the full classification
//     (`repro::classify`).  A
//     page's lanes before its first 16-byte boundary and after its last
//     whole word (an unaligned view, a row width off the vector width) go
//     through a scalar edge loop in the same kernel.
//   * The logical grid.  Only where a fatal lane is found does the kernel
//     compute its gathered row and column, and from them its logical tile:
//     one atomicOr into a bitmap of tiles, whose old bit decides the one
//     atomicAdd on the event count, so events are exact whatever block
//     finds the lanes of a tile.
//   * Launch latency.  One launch per call and nothing else on the device:
//     NaN and Inf are summed per block into a workspace that the wrapper
//     keeps per (device, stream), and the last block to finish (a ticket
//     taken after __threadfence) writes [nan, inf, events] to `counts` and
//     leaves the workspace zeroed for the next call, clearing only the
//     bitmap words that this call set and the list that names them.  Page ids of up to kMaxIds pages
//     ride in the launch's parameters (`__grid_constant__`); more come from
//     a device copy that the wrapper stages through pinned memory.  The grid
//     is sized to the work: enough chunks to reach most SMs at a few pages,
//     a few blocks per SM striding over the chunks of a large buffer.
#include "repair.cuh"

namespace {

using repro::Detector;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;      // 16-byte loads in flight per thread
constexpr int kBlocksPerSM = 4; // resident blocks a SM (<= 64 registers)
constexpr int kMaxIds = 512;    // page ids in the launch's parameters
// workspace (int32): a header, then the tile bitmap (n_words) and the list
// of its words that this call set first (n_words)
constexpr int WS_NAN = 0, WS_INF = 1, WS_EVENTS = 2, WS_TICKET = 3,
              WS_DIRTY = 4, WS_HEADER = 8;

template <int kIds>
struct Args {
  void* x;
  const int* ids_dev;          // staged page ids (kIds == 0)
  int* ws;
  int* counts;
  long long page_elems;        // lanes per page (the whole buffer: all)
  long long cols, count_lanes; // count_lanes 0: every lane counts
  long long br, bc, n_tiles_c, n_words;
  int n_chunks, chunks_per_page, chunk_words;
  Detector det;
  uint32_t fill;
  int ids[kIds > 0 ? kIds : 1];
};

// A lane that may be fatal: its exponent field at or above the lowest
// threshold the detector checks, or its bit pattern; a superset of
// repro::classify's lanes, two operations a check.
struct Candidate {
  uint32_t exp_mask, thr, bp_mask, bp_value;
  __device__ explicit Candidate(const Detector& d) {
    exp_mask = d.exp_mask;
    thr = 0xffffffffu;
    if (d.flags & (repro::FLAG_NAN | repro::FLAG_INF)) thr = d.exp_mask;
    if ((d.flags & repro::FLAG_RANGE) && d.range < thr) thr = d.range;
    const bool bp = d.flags & repro::FLAG_BITPATTERN;
    bp_mask = bp ? d.bp_mask : 0u;
    bp_value = bp ? d.bp_value : 1u;
  }
  __device__ __forceinline__ bool operator()(uint32_t b) const {
    return ((b & exp_mask) >= thr) | ((b & bp_mask) == bp_value);
  }
};

// Lane j of a 16-byte word (j a compile-time constant once unrolled).
template <typename bits_t>
__device__ __forceinline__ uint32_t lane(const uint4& w, int j) {
  const int k = sizeof(bits_t) == 4 ? j : j >> 1;
  const uint32_t u = k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
  if (sizeof(bits_t) == 4) return u;
  return (u >> ((j & 1) * 16)) & 0xffffu;
}

// The rare path: repair a fatal lane at gathered lane `g`; if it counts,
// add it to the block's sums and mark its logical tile.
template <typename bits_t, int kIds>
__device__ __noinline__ void repair_lane(const Args<kIds>& a, bits_t* p,
                                         long long g, int cls, int* cnt) {
  *p = (bits_t)a.fill;
  if (a.count_lanes && g >= a.count_lanes) return;
  if (cls & 1) atomicAdd(&cnt[0], 1);
  if (cls & 2) atomicAdd(&cnt[1], 1);
  const long long row = g / a.cols, col = g - row * a.cols;
  const long long tile = (row / a.br) * a.n_tiles_c + col / a.bc;
  unsigned* bitmap = reinterpret_cast<unsigned*>(a.ws + WS_HEADER);
  const unsigned bit = 1u << (tile & 31);
  const unsigned old = atomicOr(bitmap + (tile >> 5), bit);
  if (old & bit) return;
  atomicAdd(a.ws + WS_EVENTS, 1);
  if (old == 0) {  // the word's first bit: the last block clears it
    const int slot = atomicAdd(a.ws + WS_DIRTY, 1);
    a.ws[WS_HEADER + a.n_words + slot] = (int)(tile >> 5);
  }
}

// The lanes of one 16-byte word that holds a candidate; p and g: its
// first lane's address and gathered lane.
template <typename bits_t, int kIds>
__device__ __noinline__ void repair_word(const Args<kIds>& a, uint4 w,
                                         bits_t* p, long long g, int* cnt) {
  constexpr int V = 16 / sizeof(bits_t);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int cls = repro::classify(lane<bits_t>(w, j), a.det);
    if (cls) repair_lane(a, p + j, g + j, cls, cnt);
  }
}

template <typename bits_t, int kIds>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    scrub_stream(const __grid_constant__ Args<kIds> a) {
  constexpr int V = 16 / sizeof(bits_t);
  __shared__ int cnt[2];
  __shared__ int last, n_dirty;
  if (threadIdx.x < 2) cnt[threadIdx.x] = 0;
  __syncthreads();
  const Candidate maybe(a.det);
  bits_t* const x = static_cast<bits_t*>(a.x);
  for (int chunk = blockIdx.x; chunk < a.n_chunks; chunk += gridDim.x) {
    const int p = chunk / a.chunks_per_page;  // once a chunk, not a lane
    const int ci = chunk - p * a.chunks_per_page;
    const long long page = kIds ? a.ids[p] : __ldg(a.ids_dev + p);
    bits_t* const base = x + page * a.page_elems;
    const long long gbase = (long long)p * a.page_elems;
    long long head = ((16 - ((uintptr_t)base & 15)) & 15) / sizeof(bits_t);
    if (head > a.page_elems) head = a.page_elems;
    const long long n_vec = (a.page_elems - head) / V;
    const long long v0 = (long long)ci * a.chunk_words;
    const int nv = (int)max(0LL, min((long long)a.chunk_words, n_vec - v0));
    bits_t* const run = base + head + v0 * V;  // 16-byte aligned
    const long long grun = gbase + head + v0 * V;
    const uint4* const words = reinterpret_cast<const uint4*>(run);
    bool found = false;
    for (int i0 = 0; i0 < nv; i0 += kThreads * kUnroll) {
      uint4 w[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int i = i0 + k * kThreads + threadIdx.x;
        w[k] = i < nv ? __ldcs(words + i) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j) found |= maybe(lane<bits_t>(w[k], j));
    }
    // the rare path, out of the streaming loop: a warp that saw a candidate
    // lane reads its words of the chunk again and classifies those that
    // hold one (thread t's words are t, t + kThreads, ... in both loops)
    if (__any_sync(0xffffffffu, found)) {
      for (int i = threadIdx.x; i < nv; i += kThreads) {
        const uint4 w = words[i];
        bool any = false;
#pragma unroll
        for (int j = 0; j < V; ++j) any |= maybe(lane<bits_t>(w, j));
        if (any) repair_word(a, w, run + i * V, grun + i * V, cnt);
      }
    }
    if (ci == 0) {  // the page's lanes before its first and after its last word
      const long long tail = head + n_vec * V;
      const int n_edge = (int)(head + a.page_elems - tail);
      for (int j = threadIdx.x; j < n_edge; j += kThreads) {
        const long long off = j < head ? j : tail + (j - head);
        const int cls = repro::classify(base[off], a.det);
        if (cls) repair_lane(a, base + off, gbase + off, cls, cnt);
      }
    }
  }
  __threadfence();  // this thread's tile marks before the block's ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    if (cnt[0]) atomicAdd(a.ws + WS_NAN, cnt[0]);
    if (cnt[1]) atomicAdd(a.ws + WS_INF, cnt[1]);
    __threadfence();
    last = atomicAdd(a.ws + WS_TICKET, 1) == (int)gridDim.x - 1;
    if (last) {
      __threadfence();
      n_dirty = atomicAdd(a.ws + WS_DIRTY, 0);
    }
  }
  __syncthreads();
  if (!last) return;
  // the last block: every other block has added its counts and marks;
  // it leaves every int of the workspace zero, the dirty list included
  unsigned* bitmap = reinterpret_cast<unsigned*>(a.ws + WS_HEADER);
  int* dirty = a.ws + WS_HEADER + a.n_words;
  for (int i = threadIdx.x; i < n_dirty; i += kThreads) {
    bitmap[__ldcg(dirty + i)] = 0u;
    dirty[i] = 0;
  }
  if (threadIdx.x == 0) {
    a.counts[0] = atomicExch(a.ws + WS_NAN, 0);
    a.counts[1] = atomicExch(a.ws + WS_INF, 0);
    a.counts[2] = atomicExch(a.ws + WS_EVENTS, 0);
    a.ws[WS_DIRTY] = 0;
    a.ws[WS_TICKET] = 0;
  }
}

template <int kIds>
cudaError_t launch(void* x, int elem_bytes, const int* ids, int n_pages,
                   long long page_elems, long long cols, long long count_lanes,
                   long long br, long long bc, const int* det,
                   unsigned int fill, int chunk_words, int chunks_per_page,
                   int grid, int* ws, long long n_words, int* counts,
                   cudaStream_t s) {
  Args<kIds> a;
  a.x = x;
  a.ids_dev = kIds ? nullptr : ids;
  for (int i = 0; kIds && i < n_pages; ++i) a.ids[i] = ids[i];
  a.ws = ws;
  a.counts = counts;
  a.page_elems = page_elems;
  a.cols = cols;
  a.count_lanes = count_lanes;
  a.br = br;
  a.bc = bc;
  a.n_tiles_c = cols / bc;
  a.n_words = n_words;
  a.n_chunks = n_pages * chunks_per_page;
  a.chunks_per_page = chunks_per_page;
  a.chunk_words = chunk_words;
  a.det = repro::detector_from(det);
  a.fill = fill;
  if (elem_bytes == 4)
    scrub_stream<uint32_t, kIds><<<grid, kThreads, 0, s>>>(a);
  else if (elem_bytes == 2)
    scrub_stream<uint16_t, kIds><<<grid, kThreads, 0, s>>>(a);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// x: the buffer (element width 2 or 4 bytes), n_pages pages of page_elems
// lanes each, page i at ids[i] * page_elems (the whole buffer: one page,
// ids {0}); ids: host int32[n_pages] (copied into the launch's parameters,
// n_pages <= 512) or, with ids_staged, device int32[n_pages]; cols, br, bc:
// the gathered view's row width and logical tile; count_lanes: lanes of
// the gathered view that count (0: all); det: host int32[8]; fill: the
// repaired lane's bit pattern; chunk_words: 16-byte words per chunk,
// chunks_per_page chunks a page, walked by `grid` blocks; ws: the zeroed
// workspace, int32[8 + 2 * n_words] with n_words >= ceil(n_tiles / 32),
// left zeroed; counts: int32[3] out.  Returns cudaGetLastError() after the
// one launch.
extern "C" int repro_scrub(void* x, int elem_bytes, const int* ids,
                           int n_pages, int ids_staged, long long page_elems,
                           long long cols, long long count_lanes, long long br,
                           long long bc, const int* det, unsigned int fill,
                           int chunk_words, int chunks_per_page, int grid,
                           int* ws, long long n_words, int* counts,
                           void* stream) {
  if (n_pages < 1 || grid < 1 || (!ids_staged && n_pages > kMaxIds))
    return (int)cudaErrorInvalidValue;
  auto run = ids_staged ? &launch<0> : &launch<kMaxIds>;
  return (int)run(x, elem_bytes, ids, n_pages, page_elems, cols, count_lanes,
                  br, bc, det, fill, chunk_words, chunks_per_page, grid, ws,
                  n_words, counts, static_cast<cudaStream_t>(stream));
}
