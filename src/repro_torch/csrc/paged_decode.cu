// One-token paged decode attention with fused on-read repair, serial or
// split-K: three routes, chosen by the wrapper from dtypes, shapes and
// alignment alone (kernels/paged_attention.py::decode_route).
//
// Replaces two Pallas kernels of src/repro/kernels/paged_attention.py:
//   _paged_kernel (:147, `paged_attention_raw`), the serial page walk, and
//   _paged_splitk_kernel (:633, `paged_attention_splitk_raw`) with its
//   merge `_lse_merge` (:131).
// What every route computes: one query token per request; each (b, j) slot
// of the block table is one page visit (null-padded slots and slots past
// pos[b] included) that repairs the page's whole (pg, Kh, Dh) K and V
// tiles of this layer (a fatal lane takes the fill's bit pattern, which
// the host precomputes in the storage dtype, or for neighbor_mean the
// page's entry of the table that tile_fill.cu wrote over the layer: the
// reference's tile is the whole page, both KV heads, so no route that
// works one head or one group of slots at a time could form it) and counts
// them:
// slot_counts[b, j] is the visit's fatal-lane total over both KV heads,
// `counts` the AT int32[8] [nan_k, inf_k, ev_k, nan_v, inf_v, ev_v,
// ev_total, 0].  Keys are masked to position <= pos[b] with -1e30 (the
// reference's value), p is rounded to the cache dtype before P . V, f32
// accumulation, out = acc / max(l, 1e-30); a partial with no live key
// gets zero weight in the merge.
//
// walk route (`decode_partials` + `lse_merge`): the shapes the fused and
// heads routes do not take (head dims other than 64 and 128, offset views,
// mixed dtypes), where one KV head's page fits a block's shared memory as
// f32.  One block walks one (request b, split s) slice of the block table:
// for each slot it stages the page in groups of KV heads (the largest group
// that fits, chosen by the wrapper, kernels/paged_attention.py::
// walk_group), repairs each group's K and V rows into shared memory as f32
// and runs the online softmax of the group's query heads, then writes its
// unnormalised (acc, m, l) partial; a second launch merges the partials.
// With splits == 1 the merge is exactly the serial flush.  Loads are
// serialised (one scalar load per lane per step, a round trip per step), a
// score is one thread's serial dot product, and B x splits blocks fill few
// SMs: it loses several times to SDPA's device time (PERF.md section 6).
//
// fused route (`decode_fused`): q and both pools all f32, bf16 or f16, Dh
// 64 or 128, each contiguous and 16-byte aligned, one slot's K and V tiles
// within a block's shared memory.  What bounds it on an H100: at the
// serving shapes (B = 4, H = 12, Kh = 2, Dh = 128, pg = 16, M = 8, bf16)
// the bytes over 3.35 TB/s give ~0.0001 ms and the work is ~1 MFLOP, so it
// is latency: the design takes each dependent step once, in parallel.
//   * The partition is the kernel's own (`splits` keeps its meaning for the
//     plain version and the reference only): request b's M slots go to
//     nb = ceil(M / spb) blocks of spb = ceil(M / 8) consecutive slots,
//     the last block possibly shorter, and request b's blocks form one
//     thread-block cluster (at most 8, the portable size).  A block owns
//     its slots with both KV heads, so each visit's tile is classified in
//     one block and slot_counts and the events are decided there.
//   * At entry warp 0 reads the block's block-table entries (before the
//     barrier set-up, so they are in flight meanwhile), then issues every
//     load at once: q's row and each slot's K and V tile (contiguous: pg *
//     Kh * Dh lanes at (page, layer)) as one bulk copy each, straight into
//     shared memory in the storage dtype, behind one mbarrier: the block
//     waits one round trip.  Slots beyond what shared memory holds (more
//     than 10 at Qwen2 width, bf16) go in further rounds of the same kind.
//   * One pass over the staged tiles in 16-byte chunks runs the
//     exponent-floor prefilter and `classify` only on suspect chunks, writes
//     the fill into fatal lanes in place and counts them per slot.
//   * Then one warp per query head (up to 16; a block has one more warp,
//     which writes the counts) walks the round's pages as the reference
//     does: the page's scores by pairs of lanes per key with 16-byte q and
//     K reads, the online-softmax step in the warp (p rounded to the cache
//     dtype against the running max at that page), and acc = acc * alpha +
//     P . V with the lanes over Dh, vector V reads, f32 accumulation.  No
//     block barrier between the steps.  Every loaded key enters P . V,
//     masked ones with p = 0: a V lane that stays non-finite after the
//     repair reaches its KV head's output through 0 * NaN as in the
//     reference.
//   * Each block keeps its unnormalised partial (m, l per head, acc H x Dh)
//     in shared memory, and the merge is shared: block r owns a contiguous
//     1/nb of the (head, float4) items.  Every block stores the slices of
//     its partial into their owners' inboxes through distributed shared
//     memory (a cluster barrier arrived at entry and waited for here shows
//     every block has started; a second one, arrived after the stores,
//     releases them), then merges its own share from its inbox in rank
//     order (the plain twin's) and writes that share of the normalised
//     output in vector stores.  So a block holds its partial and one
//     partial's worth of slices, not the cluster's eight partials:
//     StarCoder2-15B's pool (H = 48, Kh = 4, Dh = 128) needs 101 KB a
//     block in bf16 and 146 KB in f32.  (Reading the slices from the other
//     blocks after one barrier, with a second one before leaving, was 2-4 %
//     slower on an H100: scripts/decode_fused_variants.py.)
//   The counts are zeroed by a memset on the stream before the launch.
//   Against the plain version with `splits`, p is rounded against another
//   running max where the partitions differ, so outputs agree within the
//   dtype's tolerance, not bitwise; the plain twin of the kernel's own
//   partition is kernels/paged_attention.py::paged_decode_fused_plain.
//
// heads route (`page_scan` + `decode_heads`): the fused route's operands
// where one slot's K and V tiles exceed a block (StableLM-1.6B's f32 pool:
// 32 KV heads of 64, 2 x 128 KiB a slot).  What bounds it on an H100: at
// that pool (B = 4, H = Kh = 32, Dh = 64, pg = 16, M = 8) the pages' bytes
// over 3.35 TB/s, ~0.0014 ms; it is latency again.  The slot's tile is
// split by KV head instead: blocks per (request b, KV head kh) walk the
// request's slots with that KV head's pg rows of each and its G query
// heads, every 16 bytes of a round's rows issued at once by the block's
// threads as cp.async (at least 4 warps a block for that).  A visit's tile spans
// every KV head, so no block can count it:
// `page_scan` (paged.cuh, one block a slot) writes slot_counts, the AT
// counts and one K and one V flag a slot first, and decode_heads repairs
// only the flagged slots' rows, in shared memory.  The walk itself, the
// warps and the merge are decode_fused's (`decode_body`): one warp a query
// head, the page's online-softmax step in the warp, P . V with the lanes
// over Dh.  A warp walks its block's pages one after another, so a
// request's slots are split over a cluster of up to 8 blocks as on the
// fused route, until it has as many blocks as the card has SMs (4 blocks
// of 2 slots a KV head at StableLM's pool, 512 blocks at B = 4; all 8 slots
// in one block took 1.6x the main kernel's time), and merged in shares
// through distributed shared memory (kernels/paged_attention.py::
// heads_partition; its plain twin paged_decode_heads_plain).  Launches: the scan's memset of the counts,
// page_scan, decode_heads.
#include <cooperative_groups.h>

#include <cmath>

#include "paged.cuh"

namespace {

using repro::Detector;
using repro::NEG_INF;
using repro::Storage;

constexpr int kThreads = 256;

// One block walks one (request b, split s) slice of the block table.  Each
// slot's page is staged in groups of kg KV heads, one group after another
// (shared memory: q and acc (H, Dh), the group's K rows padded to Dh + 1
// and its V rows (pg * kg each), the group's scores (kg * G, pg), m, l and
// the rescale factor (H each), 4 counts: kernels/paged_attention.py::
// walk_smem):
// the group's K and V rows are repaired into shared memory as f32 and
// counted into the slot's four counters, then the query heads of those KV
// heads take the page's scores, online-softmax step and P . V.  Each query
// head still sees each page once, in page order, so its arithmetic is the
// ungrouped walk's; the slot's counts and events are written once, after
// its last group (a visit is one tile over every KV head).
template <int DT>
__global__ void decode_partials(
    const typename Storage<DT>::bits_t* q, const typename Storage<DT>::bits_t* kp,
    const typename Storage<DT>::bits_t* vp, const int* bt, const int* pos,
    int H, int Dh, int L, int pg, int Kh, int kg, int M, int ns, int layer,
    float sm_scale, Detector det_k, Detector det_v, repro::Fill fill_k,
    repro::Fill fill_v, float* o_part, float* m_part, float* l_part,
    int* slot_counts, int* counts) {
  extern __shared__ float smem[];
  const int ks = Dh + 1;                  // padded K row stride
  const int G = H / Kh;
  const int rows = pg * kg;               // (token, kv head) rows of a group
  float* q_s = smem;                      // H x Dh
  float* k_s = q_s + H * Dh;              // rows x ks
  float* v_s = k_s + rows * ks;           // rows x Dh
  float* acc = v_s + rows * Dh;           // H x Dh
  float* p_s = acc + H * Dh;              // kg * G x pg
  float* m_s = p_s + kg * G * pg;         // H
  float* l_s = m_s + H;                   // H
  float* a_s = l_s + H;                   // H (rescale factors)
  int* cnt = reinterpret_cast<int*>(a_s + H);  // nan_k, inf_k, nan_v, inf_v

  const int b = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int tid = threadIdx.x;
  for (int i = tid; i < H * Dh; i += blockDim.x) {
    q_s[i] = Storage<DT>::to_float(q[(long long)b * H * Dh + i]);
    acc[i] = 0.f;
  }
  for (int h = tid; h < H; h += blockDim.x) {
    m_s[h] = NEG_INF;
    l_s[h] = 0.f;
  }
  const int bound = pos[b];
  const long long tile = (long long)pg * Kh * Dh;
  for (int jj = 0; jj < ns; ++jj) {
    const int j = s * ns + jj;
    const long long page = bt[b * M + j];
    const long long base = (page * L + layer) * tile;
    if (tid < 4) cnt[tid] = 0;
    __syncthreads();
    for (int k0 = 0; k0 < Kh; k0 += kg) {
      const int nk = min(kg, Kh - k0);    // KV heads k0 .. k0 + nk - 1
      const int h0 = k0 * G, nh = nk * G;  // their query heads
      repro::repair_rows<DT>(kp + base + k0 * Dh, pg * nk, nk, (long long)Kh * Dh,
                             Dh, ks, det_k, fill_k, page, k_s, &cnt[0]);
      repro::repair_rows<DT>(vp + base + k0 * Dh, pg * nk, nk, (long long)Kh * Dh,
                             Dh, Dh, det_v, fill_v, page, v_s, &cnt[2]);
      __syncthreads();
      if (tid == 0 && k0 + nk == Kh) {
        const int fk = cnt[0] + cnt[1], fv = cnt[2] + cnt[3];
        slot_counts[b * M + j] = fk + fv;
        if (cnt[0]) atomicAdd(&counts[0], cnt[0]);
        if (cnt[1]) atomicAdd(&counts[1], cnt[1]);
        if (fk) atomicAdd(&counts[2], 1);
        if (cnt[2]) atomicAdd(&counts[3], cnt[2]);
        if (cnt[3]) atomicAdd(&counts[4], cnt[3]);
        if (fv) atomicAdd(&counts[5], 1);
        if (fk || fv) atomicAdd(&counts[6], 1);
      }
      // scores of this page for the group's heads, masked by position
      for (int i = tid; i < nh * pg; i += blockDim.x) {
        const int hl = i / pg, t = i % pg;
        const float* qr = q_s + (h0 + hl) * Dh;
        const float* kr = k_s + (t * nk + hl / G) * ks;
        float dot = 0.f;
        for (int d = 0; d < Dh; ++d) dot += qr[d] * kr[d];
        p_s[i] = (j * pg + t <= bound) ? dot * sm_scale : NEG_INF;
      }
      __syncthreads();
      // online-softmax state, one thread per head
      for (int hl = tid; hl < nh; hl += blockDim.x) {
        const int h = h0 + hl;
        float* pr = p_s + hl * pg;
        float mx = m_s[h];
        for (int t = 0; t < pg; ++t) mx = fmaxf(mx, pr[t]);
        float sum = 0.f;
        for (int t = 0; t < pg; ++t) {
          const float sv = pr[t];
          const float p = sv > NEG_INF * 0.5f ? expf(sv - mx) : 0.f;
          sum += p;
          pr[t] = Storage<DT>::quantize(p);
        }
        const float alpha = expf(m_s[h] - mx);
        a_s[h] = alpha;
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = mx;
      }
      __syncthreads();
      for (int i = tid; i < nh * Dh; i += blockDim.x) {
        const int hl = i / Dh, d = i % Dh, h = h0 + hl;
        const float* pr = p_s + hl * pg;
        const float* vc = v_s + (hl / G) * Dh + d;
        float pv = 0.f;
        for (int t = 0; t < pg; ++t) pv += pr[t] * vc[t * nk * Dh];
        acc[h * Dh + d] = acc[h * Dh + d] * a_s[h] + pv;
      }
      __syncthreads();
    }
  }
  const long long o = ((long long)b * S + s) * H;
  for (int i = tid; i < H * Dh; i += blockDim.x) o_part[o * Dh + i] = acc[i];
  for (int h = tid; h < H; h += blockDim.x) {
    m_part[o + h] = m_s[h];
    l_part[o + h] = l_s[h];
  }
}

// out[b, h, :] = sum_s w_s * o_part / max(sum_s w_s * l_part, 1e-30), with
// w_s = exp(m_s - max_s m_s) for live partials and 0 for dead ones.
template <int DT>
__global__ void lse_merge(const float* o_part, const float* m_part,
                          const float* l_part, int S, int H, int Dh,
                          typename Storage<DT>::bits_t* out) {
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < H * Dh; i += blockDim.x) {
    const int h = i / Dh;
    float m_star = NEG_INF;
    for (int s = 0; s < S; ++s)
      m_star = fmaxf(m_star, m_part[((long long)b * S + s) * H + h]);
    float l_tot = 0.f, a = 0.f;
    for (int s = 0; s < S; ++s) {
      const long long o = ((long long)b * S + s) * H + h;
      const float m = m_part[o];
      const float w = m > NEG_INF * 0.5f ? expf(m - m_star) : 0.f;
      l_tot += w * l_part[o];
      a += w * o_part[o * Dh + (i % Dh)];
    }
    out[(long long)b * H * Dh + i] = Storage<DT>::from_float(a / fmaxf(l_tot, 1e-30f));
  }
}

template <int DT>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* bt, const int* pos, int B, int H, int Dh, int L,
                   int pg, int Kh, int kg, size_t smem, int M, int splits,
                   int layer, const int* det_k, const int* det_v,
                   repro::Fill fill_k, repro::Fill fill_v, float* o_part,
                   float* m_part, float* l_part, int* slot_counts, int* counts,
                   void* out, cudaStream_t stream) {
  using bits_t = typename Storage<DT>::bits_t;
  cudaError_t err = repro::allow_smem((const void*)decode_partials<DT>, smem);
  if (err != cudaSuccess) return err;
  const float sm_scale = 1.0f / sqrtf((float)Dh);
  decode_partials<DT><<<dim3(B, splits), kThreads, smem, stream>>>(
      static_cast<const bits_t*>(q), static_cast<const bits_t*>(kp),
      static_cast<const bits_t*>(vp), bt, pos, H, Dh, L, pg, Kh, kg, M, M / splits,
      layer, sm_scale, repro::detector_from(det_k), repro::detector_from(det_v),
      fill_k, fill_v, o_part, m_part, l_part, slot_counts, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lse_merge<DT><<<B, kThreads, 0, stream>>>(o_part, m_part, l_part, splits, H,
                                            Dh, static_cast<bits_t*>(out));
  return cudaGetLastError();
}

// ------------------------------------------------- fused and heads routes
namespace fd {

namespace cg = cooperative_groups;
using hopper::bulk_load;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using paged::cp_async16;
using paged::cp_async_wait_all;
using paged::load_lanes;
using paged::nan_max;
using paged::repair_vec;
using paged::store4;
using paged::suspect;
using paged::unpack;
using paged::warp_fsum;
using paged::warp_max;

constexpr int MAX_HEAD_WARPS = 16;  // one warp a query head, up to 16
constexpr int MAX_THREADS = 32 * (MAX_HEAD_WARPS + 1);  // + the counting warp
constexpr int MAX_CLUSTER = 8;      // the portable cluster size
constexpr int MAX_ROUND = 32;       // slots a round: one lane of warp 0 each
constexpr int HEADS_MIN_WARPS = 4;  // a heads block's warps, at the least
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block

// What every block of one call shares.
struct Decode {
  const uint8_t* q;     // (B, H, D)
  const uint8_t* kp;    // (P, L, pg, Kh, D)
  const uint8_t* vp;
  const int* bt;        // (B, M)
  const int* pos;       // (B,)
  uint8_t* out;         // (B, H, D)
  int* slot_counts;     // fused: (B, M)
  int* counts;          // fused: int32[8], zeroed before the launch
  const int* flags;     // heads: page_scan's (B, M, 2) flags
  int H, Kh, M, L, pg, layer;
  int spb, round;       // slots a block, slots a round
  float scale;
  Detector det_k, det_v;
  uint32_t floor_k, floor_v;  // fatal_floor of each detector
  repro::Fill fill_k, fill_v;  // a table is indexed by page id
};

// Byte offsets into a block's dynamic shared memory: the mbarrier, q's rows
// of the block's H heads (H, D) and the round's tiles (per slot K then V,
// (pg, Kh, D) each, Kh the KV heads a block stages) in the storage dtype,
// then f32: the block's own acc (H, D); its inbox, the slices of every
// block's partial that its share of the merge takes (acc: nb shares of
// ceil(H * D / 4 / nb) float4s, at most H * D / 4 + 8; (m, l) of each
// head: MAX_CLUSTER x H float2s); a page's scores and softmax weights for
// each head warp (H, pg); the block's own m and l (H each); and int32
// counts (round, 4: NaN K, Inf K, NaN V, Inf V; heads: the round's flag
// masks and page ids) (kernels/paged_attention.py::fused_smem).
struct Layout {
  long long q, tiles, acc, inbox, inml, s, m, l, cnt, total;
  __host__ __device__ Layout(int H, int D, int pg, int Kh, int es, int round) {
    const long long tb = (long long)pg * Kh * D * es;
    q = 16;
    tiles = q + (long long)H * D * es;
    acc = tiles + 2 * round * tb;
    inbox = acc + 4ll * H * D;
    inml = inbox + 4ll * H * D + 16ll * MAX_CLUSTER;
    s = inml + 8ll * MAX_CLUSTER * H;
    m = s + 4ll * H * pg;
    l = m + 4ll * H;
    cnt = l + 4ll * H;
    total = cnt + 16ll * round;
  }
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// One head's online-softmax walk over the round's n pages (one warp):
// scores of a page by pairs of lanes per key (each half a row, chunks in a
// rotated order so that a quarter-warp's 16-byte reads hit distinct banks),
// then the softmax step in the warp (p rounded to the storage dtype), then
// acc = acc * alpha + P . V with the lanes over D.  The staged tiles hold
// `ks` KV heads a row; the head reads KV head `kh` of them.
template <int DT, int D>
__device__ __forceinline__ void head_walk(const Decode& p, int h, int kh,
                                          int ks, int n, int jr, int bound,
                                          const uint8_t* q_s,
                                          const uint8_t* tiles, float* acc,
                                          float* sw, float* m_s, float* l_s) {
  constexpr int ES = DT == repro::DT_F32 ? 4 : 2;
  constexpr int VEC = 16 / ES;      // lanes of a 16-byte chunk
  constexpr int CPL = D / VEC / 2;  // chunks of half a row
  constexpr int DPL = D / 32;       // dims of a lane in P . V
  const int lane = threadIdx.x & 31, x = lane & 1;
  const int pg = p.pg;
  const uint32_t tb = (uint32_t)(pg * ks * D * ES);
  const int rot = CPL >= 8 ? lane : lane >> 1;
  float o[DPL];
  float* ap = acc + h * D + lane * DPL;
#pragma unroll
  for (int e = 0; e < DPL; ++e) o[e] = ap[e];
  float m = m_s[h], l = l_s[h];
  const uint4* qc = reinterpret_cast<const uint4*>(q_s + h * D * ES) + x * CPL;
  for (int i = 0; i < n; ++i) {
    const uint8_t* kt = tiles + 2ll * i * tb;
    const int pos0 = (jr + i) * pg;   // the page's first key position
    for (int t0 = 0; t0 < pg; t0 += 16) {
      const int t = t0 + (lane >> 1);
      float dot = 0.f;
      if (t < pg) {
        const uint4* kc =
            reinterpret_cast<const uint4*>(kt + (t * ks + kh) * D * ES) + x * CPL;
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int j = (k + rot) & (CPL - 1);
          float qf[VEC], kf[VEC];
          unpack<DT>(qc[j], qf);
          unpack<DT>(kc[j], kf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot = fmaf(qf[e], kf[e], dot);
        }
      }
      dot += __shfl_xor_sync(~0u, dot, 1);
      if (x == 0 && t < pg) sw[t] = pos0 + t <= bound ? dot * p.scale : NEG_INF;
    }
    __syncwarp();
    float mx = NEG_INF;
    for (int t = lane; t < pg; t += 32) mx = nan_max(mx, sw[t]);
    const float m_new = nan_max(m, warp_max(mx));
    float sum = 0.f;
    for (int t = lane; t < pg; t += 32) {
      const float sv = sw[t];
      const float e = sv > NEG_INF * 0.5f ? expf(sv - m_new) : 0.f;
      sum += e;
      sw[t] = Storage<DT>::quantize(e);
    }
    const float alpha = expf(m - m_new);
    l = l * alpha + warp_fsum(sum);
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] *= alpha;
    const uint8_t* vr = kt + tb + (kh * D + lane * DPL) * ES;
#pragma unroll 4
    for (int t = 0; t < pg; ++t) {
      const float w = sw[t];
      float vf[DPL];
      load_lanes<DT, DPL>(vr + (long long)t * ks * D * ES, vf);
#pragma unroll
      for (int e = 0; e < DPL; ++e) o[e] = fmaf(w, vf[e], o[e]);
    }
    __syncwarp();   // the next page's scores overwrite sw
  }
#pragma unroll
  for (int e = 0; e < DPL; ++e) ap[e] = o[e];
  if (lane == 0) {
    m_s[h] = m;
    l_s[h] = l;
  }
}

// The body of both kernels.  Fused (HEADS false): grid (nb, B), clusters of
// (nb, 1, 1), blocks of 32 * (min(H, 16) + 1) threads: block `rank` of
// request b owns slots rank * spb .. min(M, rank * spb + spb) - 1 with
// every KV head; warp w < min(H, 16) walks heads w, w + 16, ...; the last
// warp counts.  Heads (HEADS true): grid (nb, Kh, B), clusters of (nb, 1,
// 1), blocks of 32 * min(G, 16) threads: block `rank` of (request b, KV
// head kh) owns the same slots with that KV head alone and its G query
// heads; page_scan counted the visits, so the block repairs only the pages
// it flagged, and every warp walks heads.
template <int DT, int D, bool HEADS>
__device__ __forceinline__ void decode_body(const Decode& p) {
  constexpr int ES = DT == repro::DT_F32 ? 4 : 2;
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int head_warps = nthreads / 32 - (HEADS ? 0 : 1);   // heads: every warp
  const int rank = blockIdx.x, nb = gridDim.x;
  const int b = HEADS ? blockIdx.z : blockIdx.y;
  const int kh = HEADS ? blockIdx.y : 0;   // the block's KV head (heads)
  const int ks = HEADS ? 1 : p.Kh;         // KV heads a staged tile holds
  const int H = HEADS ? p.H / p.Kh : p.H;  // the block's query heads
  const int h0 = kh * H;                   // ... from this one
  const int pg = p.pg;
  const int j0 = rank * p.spb, j1 = min(p.M, j0 + p.spb);
  const uint32_t tb = (uint32_t)(pg * ks * D * ES);   // one tile's bytes
  const long long page_bytes = (long long)pg * p.Kh * D * ES;
  const Layout lay(H, D, pg, ks, ES, p.round);
  const uint32_t bar = smem_u32(smem);
  uint8_t* q_s = smem + lay.q;
  uint8_t* tiles = smem + lay.tiles;
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  int* cnt = reinterpret_cast<int*>(smem + lay.cnt);

  // lane i of warp 0: the byte offset of slot jr + i's page at `layer`
  // (fused)
  long long src = 0;
  auto fetch = [&](int jr) {
    if (!HEADS && warp == 0 && lane < min(p.round, j1 - jr))
      src = ((long long)p.bt[(long long)b * p.M + jr + lane] * p.L + p.layer) *
            page_bytes;
  };
  fetch(j0);
  const int bound = p.pos[b];
  if (!HEADS && tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < H * D; i += nthreads) acc[i] = 0.f;
  for (int i = tid; i < H; i += nthreads) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }
  if (!HEADS)
    for (int i = tid; i < 4 * p.round; i += nthreads) cnt[i] = 0;
  __syncthreads();
  // the first cluster phase: its wait, before the partials move, shows that
  // every block of the cluster has started
  cluster_arrive_relaxed();

  for (int jr = j0, it = 0; jr < j1; jr += p.round, ++it) {
    const int n = min(p.round, j1 - jr);
    if (HEADS) {
      // ---- the round's page ids and flagged slots, then (every thread)
      // every 16 bytes of its KV head's pg rows a slot by cp.async, and
      // q's rows in the first round, all in flight at once
      if (warp == 0) {
        int id = 0, flagged = 0;
        if (lane < n) {
          const long long slot = (long long)b * p.M + jr + lane;
          id = p.bt[slot];
          flagged = (p.flags[2 * slot] & 1) | ((p.flags[2 * slot + 1] & 1) << 1);
          cnt[2 + lane] = id;
        }
        const uint32_t fk = __ballot_sync(~0u, flagged & 1);
        const uint32_t fv = __ballot_sync(~0u, flagged & 2);
        if (lane == 0) {
          cnt[0] = (int)fk;
          cnt[1] = (int)fv;
        }
      }
      __syncthreads();
      constexpr int CPR = D * ES / 16;   // 16-byte chunks a row
      if (it == 0)
        for (int e = tid; e < H * CPR; e += nthreads)
          cp_async16(smem_u32(q_s + 16 * e),
                     p.q + ((long long)b * p.H + h0) * D * ES + 16 * e);
      for (int e = tid; e < n * pg * CPR; e += nthreads) {
        const int c = e / CPR, i = c / pg, t = c - i * pg;
        const long long off = ((long long)cnt[2 + i] * p.L + p.layer) * page_bytes +
                              ((long long)t * p.Kh + kh) * D * ES + 16 * (e - c * CPR);
        uint8_t* dst = tiles + 2ll * i * tb + 16 * (e - i * pg * CPR);
        cp_async16(smem_u32(dst), p.kp + off);
        cp_async16(smem_u32(dst + tb), p.vp + off);
      }
      cp_async_wait_all();
      __syncthreads();
    } else {
      // ---- every load of the round at once, behind one barrier
      if (warp == 0) {
        if (it > 0) fetch(jr);
        if (lane == 0) {
          const uint32_t qb = it == 0 ? (uint32_t)(H * D * ES) : 0u;
          mbar_expect_tx(bar, 2u * n * tb + qb);
          if (qb) bulk_load(smem_u32(q_s), p.q + ((long long)b * p.H + h0) * D * ES, qb, bar);
        }
        __syncwarp();
        if (lane < n) {
          uint8_t* dst = tiles + 2ll * lane * tb;
          bulk_load(smem_u32(dst), p.kp + src, tb, bar);
          bulk_load(smem_u32(dst + tb), p.vp + src, tb, bar);
        }
      }
      mbar_wait(bar, it & 1);
    }

    if (HEADS) {
      // ---- repair the flagged slots' rows in place
      const int cpt = (int)(tb / 16);   // chunks of a tile
      for (int op = 0; op < 2; ++op) {
        const Detector& det = op ? p.det_v : p.det_k;
        const uint32_t floor = op ? p.floor_v : p.floor_k;
        const repro::Fill& f = op ? p.fill_v : p.fill_k;
        for (uint32_t bits = (uint32_t)cnt[op]; bits; bits &= bits - 1) {
          const int slot = __ffs(bits) - 1;
          const uint32_t fill = f.table ? f.at(cnt[2 + slot]) : f.value;
          uint4* chunks = reinterpret_cast<uint4*>(tiles + (2ll * slot + op) * tb);
          for (int c = tid; c < cpt; c += nthreads)
            if (suspect<ES>(chunks[c], det.exp_mask, floor))
              repair_vec<ES>(chunks + c, det, fill);
        }
      }
    } else {
      // ---- repair in place, counts per slot
      const int cpt = (int)(tb / 16);   // chunks of a tile
      uint4* chunks = reinterpret_cast<uint4*>(tiles);
      for (int c = tid; c < 2 * n * cpt; c += nthreads) {
        const int op = (c / cpt) & 1;   // 0: K, 1: V
        const uint32_t floor = op ? p.floor_v : p.floor_k;
        const uint32_t exp_mask = op ? p.det_v.exp_mask : p.det_k.exp_mask;
        if (suspect<ES>(chunks[c], exp_mask, floor)) {
          // the fill of the slot's page, whichever block holds the slot
          const int slot = c / (2 * cpt);
          const repro::Fill& f = op ? p.fill_v : p.fill_k;
          const uint32_t fill =
              f.table ? f.at(p.bt[(long long)b * p.M + jr + slot]) : f.value;
          const int r = op ? repair_vec<ES>(chunks + c, p.det_v, fill)
                           : repair_vec<ES>(chunks + c, p.det_k, fill);
          int* sc = cnt + 4 * slot + 2 * op;
          if (r & 0xFFFF) atomicAdd(sc, r & 0xFFFF);
          if (r >> 16) atomicAdd(sc + 1, r >> 16);
        }
      }
    }
    __syncthreads();

    if (!HEADS && warp == head_warps) {
      // ---- slot_counts and the AT counts of the round's visits
      int c4[4] = {0, 0, 0, 0};
      if (lane < n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          c4[i] = cnt[4 * lane + i];
          cnt[4 * lane + i] = 0;
        }
        p.slot_counts[(long long)b * p.M + jr + lane] =
            c4[0] + c4[1] + c4[2] + c4[3];
      }
      const int fk = c4[0] + c4[1], fv = c4[2] + c4[3];
      const int v[7] = {c4[0], c4[1], fk > 0, c4[2], c4[3], fv > 0, fk + fv > 0};
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        const int t = repro::warp_sum(v[i]);
        if (lane == 0 && t) atomicAdd(&p.counts[i], t);
      }
    } else {
      for (int h = warp; h < H; h += head_warps)
        head_walk<DT, D>(p, h, HEADS ? 0 : h / (H / p.Kh), ks, n, jr, bound,
                         q_s, tiles, acc, s_s + warp * pg, m_s, l_s);
    }
    // the next round's copies overwrite what the threads read and wrote
    if (!HEADS) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
  }

  // ---- merge, shared across the cluster: block `owner` takes a contiguous
  // share of the (head, float4) items.  Every block stores the slices of
  // its unnormalised partial into their owners' inboxes through
  // distributed shared memory (acc, and (m, l) of each head that an
  // owner's share touches); a cluster barrier releases the stores; then
  // each block merges its share from its own inbox, the blocks' partials
  // in rank order 0 .. nb - 1 (the plain twin's order): w_r = exp(m_r -
  // max m) for live partials, 0 for dead ones (0 * NaN still reaches the
  // output, as in the reference's merge), and writes its share of out in
  // vector stores
  const int items = H * (D / 4), share = (items + nb - 1) / nb;
  float4* inbox = reinterpret_cast<float4*>(smem + lay.inbox);
  float2* inml = reinterpret_cast<float2*>(smem + lay.inml);
  cluster_wait();
  const float4* acc4 = reinterpret_cast<const float4*>(acc);
  for (int item = tid; item < items; item += nthreads) {
    const int owner = item / share;
    *cluster.map_shared_rank(inbox + rank * share + item - owner * share,
                             owner) = acc4[item];
  }
  for (int i = tid; i < H * nb; i += nthreads) {
    const int h = i / nb, owner = i - h * nb;
    if (h * (D / 4) < (owner + 1) * share && (h + 1) * (D / 4) > owner * share)
      *cluster.map_shared_rank(inml + rank * H + h, owner) =
          make_float2(m_s[h], l_s[h]);
  }
  cluster_arrive();
  cluster_wait();
  const int i1 = min(items, (rank + 1) * share);
  for (int item = rank * share + tid; item < i1; item += nthreads) {
    const int h = item / (D / 4), c4 = item - h * (D / 4);
    const int slot = item - rank * share;
    float mr[MAX_CLUSTER], lr[MAX_CLUSTER];
    float4 ar[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      if (r < nb) {
        const float2 ml = inml[r * H + h];
        mr[r] = ml.x;
        lr[r] = ml.y;
        ar[r] = inbox[r * share + slot];
      }
    }
    float m_star = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < nb) m_star = nan_max(m_star, mr[r]);
    float lt = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      if (r < nb) {
        const float w = mr[r] > NEG_INF * 0.5f ? expf(mr[r] - m_star) : 0.f;
        lt += w * lr[r];
        o.x += w * ar[r].x;
        o.y += w * ar[r].y;
        o.z += w * ar[r].z;
        o.w += w * ar[r].w;
      }
    }
    const float den = fmaxf(lt, 1e-30f);
    store4<DT>(p.out + (((long long)b * p.H + h0 + h) * D + 4 * c4) * ES,
               make_float4(o.x / den, o.y / den, o.z / den, o.w / den));
  }
}

// Slots a block and blocks a request: spb = ceil(M / 8), nb = ceil(M / spb)
// (kernels/paged_attention.py::fused_partition).
inline void partition(int M, int* nb, int* spb) {
  const int n = M < MAX_CLUSTER ? M : MAX_CLUSTER;
  *spb = (M + n - 1) / n;
  *nb = (M + *spb - 1) / *spb;
}

// Slots a round: as many of the block's slots as shared memory holds, at
// most MAX_ROUND; 0 when not even one slot fits.
inline int round_slots(int H, int D, int pg, int Kh, int es, int spb) {
  int r = spb < MAX_ROUND ? spb : MAX_ROUND;
  while (r > 0 && Layout(H, D, pg, Kh, es, r).total > SMEM_LIMIT) --r;
  return r;
}

template <int DT, int D>
__global__ void __launch_bounds__(MAX_THREADS)
    decode_fused(const __grid_constant__ Decode p) {
  decode_body<DT, D, false>(p);
}

template <int DT, int D>
__global__ void __launch_bounds__(MAX_THREADS)
    decode_heads(const __grid_constant__ Decode p) {
  decode_body<DT, D, true>(p);
}

// Launches one route's kernel: grid (nb, B) (fused) or (nb, Kh, B)
// (heads), clusters of nb blocks.
template <int DT, int D, bool HEADS>
cudaError_t launch(const Decode& p, int B, int nb, cudaStream_t stream) {
  constexpr int ES = DT == repro::DT_F32 ? 4 : 2;
  const int H = HEADS ? p.H / p.Kh : p.H;
  const size_t smem =
      (size_t)Layout(H, D, p.pg, HEADS ? 1 : p.Kh, ES, p.round).total;
  const void* kernel = HEADS ? (const void*)decode_heads<DT, D>
                             : (const void*)decode_fused<DT, D>;
  static size_t smem_set = 48 * 1024;  // the attribute, raised as needed
  if (smem > smem_set) {
    const cudaError_t err = repro::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = HEADS ? dim3(nb, p.Kh, B) : dim3(nb, B, 1);
  // fused: a warp a head (up to 16) and the counting warp; heads: at
  // least HEADS_MIN_WARPS, so that more threads issue the loads
  const int head_warps = H < MAX_HEAD_WARPS ? H : MAX_HEAD_WARPS;
  const int warps = HEADS ? (head_warps > HEADS_MIN_WARPS ? head_warps : HEADS_MIN_WARPS)
                          : head_warps + 1;
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (HEADS)
    err = cudaLaunchKernelEx(&cfg, decode_heads<DT, D>, p);
  else
    err = cudaLaunchKernelEx(&cfg, decode_fused<DT, D>, p);
  if (err != cudaSuccess) cudaGetLastError();   // as repro::allow_smem
  return err;
}

// Both routes' parameters, checked: the memset (fused) or page_scan
// (heads) goes first on the stream.
inline bool decode_shape_ok(int dtype, int B, int H, int Dh, int P, int L,
                            int pg, int Kh, int M, int layer) {
  return dtype >= repro::DT_F32 && dtype <= repro::DT_F16 &&
         (Dh == 64 || Dh == 128) && B >= 1 && H >= 1 && Kh >= 1 &&
         H % Kh == 0 && P >= 1 && L >= 1 && pg >= 1 && M >= 1 && layer >= 0 &&
         layer < L && B <= 65535;
}

template <bool HEADS>
cudaError_t launch_route(const Decode& p, int dtype, int Dh, int B, int nb,
                         cudaStream_t s) {
  switch (dtype * 2 + (Dh == 128)) {
    case 2 * repro::DT_F32: return launch<repro::DT_F32, 64, HEADS>(p, B, nb, s);
    case 2 * repro::DT_F32 + 1: return launch<repro::DT_F32, 128, HEADS>(p, B, nb, s);
    case 2 * repro::DT_BF16: return launch<repro::DT_BF16, 64, HEADS>(p, B, nb, s);
    case 2 * repro::DT_BF16 + 1: return launch<repro::DT_BF16, 128, HEADS>(p, B, nb, s);
    case 2 * repro::DT_F16: return launch<repro::DT_F16, 64, HEADS>(p, B, nb, s);
    default: return launch<repro::DT_F16, 128, HEADS>(p, B, nb, s);
  }
}

}  // namespace fd

}  // namespace

// q (B, H, Dh), pages (P, L, pg, Kh, Dh) in `dtype` (0 f32, 1 bf16, 2 f16);
// bt (B, M) and pos (B,) int32 on the device; det_k/det_v host int32[8];
// fill_k/fill_v the repaired lanes' bit patterns, or with fills_k/fills_v
// (device uint32 per page of the layer, from repro_tile_fill; null: none)
// the page's entry; kg the KV heads a block stages at a time (1 .. Kh) and
// smem its dynamic shared-memory bytes (kernels/paged_attention.py::
// walk_group, walk_smem).  Outputs: o_part (B, splits, H, Dh), m_part/l_part
// (B, splits, H) f32 scratch, slot_counts (B, M) int32, counts int32[8]
// (zeroed by the caller), out (B, H, Dh) in `dtype`.  Returns
// cudaGetLastError() after the launches.
extern "C" int repro_paged_decode(
    const void* q, const void* kp, const void* vp, const int* bt,
    const int* pos, int dtype, int B, int H, int Dh, int L, int pg, int Kh,
    int kg, int smem, int M, int splits, int layer, const int* det_k,
    const int* det_v, unsigned int fill_k_bits, unsigned int fill_v_bits,
    const unsigned int* fills_k, const unsigned int* fills_v, float* o_part,
    float* m_part, float* l_part, int* slot_counts, int* counts, void* out,
    void* stream) {
  if (splits < 1 || M % splits != 0 || H % Kh != 0 || kg < 1 || kg > Kh ||
      smem < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const repro::Fill fill_k{fills_k, fill_k_bits}, fill_v{fills_v, fill_v_bits};
  switch (dtype) {
    case repro::DT_F32:
      return (int)launch<repro::DT_F32>(q, kp, vp, bt, pos, B, H, Dh, L, pg, Kh,
                                        kg, smem, M, splits, layer, det_k, det_v,
                                        fill_k, fill_v, o_part, m_part, l_part,
                                        slot_counts, counts, out, s);
    case repro::DT_BF16:
      return (int)launch<repro::DT_BF16>(q, kp, vp, bt, pos, B, H, Dh, L, pg,
                                         Kh, kg, smem, M, splits, layer, det_k,
                                         det_v, fill_k, fill_v, o_part, m_part,
                                         l_part, slot_counts, counts, out, s);
    case repro::DT_F16:
      return (int)launch<repro::DT_F16>(q, kp, vp, bt, pos, B, H, Dh, L, pg, Kh,
                                        kg, smem, M, splits, layer, det_k, det_v,
                                        fill_k, fill_v, o_part, m_part, l_part,
                                        slot_counts, counts, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The fused route: q (B, H, Dh) and pages (P, L, pg, Kh, Dh) all in `dtype`
// (0 f32, 1 bf16, 2 f16), contiguous and 16-byte aligned, Dh 64 or 128;
// bt (B, M) and pos (B,) int32 on the device; det_k/det_v host int32[8];
// fill_k/fill_v and fills_k/fills_v as for repro_paged_decode.  Writes out
// (B, H, Dh) in `dtype`, slot_counts (B, M) and counts int32[8] (zeroed
// first, on the stream).  Returns the memset's or the launch's error.
extern "C" int repro_paged_decode_fused(
    const void* q, const void* kp, const void* vp, const int* bt,
    const int* pos, int dtype, int B, int H, int Dh, int P, int L, int pg,
    int Kh, int M, int layer, const int* det_k, const int* det_v,
    unsigned int fill_k, unsigned int fill_v, const unsigned int* fills_k,
    const unsigned int* fills_v, void* out, int* slot_counts, int* counts,
    void* stream) {
  const int es = dtype == repro::DT_F32 ? 4 : 2;
  if (!fd::decode_shape_ok(dtype, B, H, Dh, P, L, pg, Kh, M, layer))
    return (int)cudaErrorInvalidValue;
  int nb, spb;
  fd::partition(M, &nb, &spb);
  const int round = fd::round_slots(H, Dh, pg, Kh, es, spb);
  if (round < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, 8 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const repro::Detector dk = repro::detector_from(det_k),
                        dv = repro::detector_from(det_v);
  const fd::Decode p{static_cast<const uint8_t*>(q),
                     static_cast<const uint8_t*>(kp),
                     static_cast<const uint8_t*>(vp),
                     bt,
                     pos,
                     static_cast<uint8_t*>(out),
                     slot_counts,
                     counts,
                     nullptr,
                     H,
                     Kh,
                     M,
                     L,
                     pg,
                     layer,
                     spb,
                     round,
                     (float)(1.0 / std::sqrt((double)Dh)),
                     dk,
                     dv,
                     hopper::fatal_floor(dk),
                     hopper::fatal_floor(dv),
                     {fills_k, fill_k},
                     {fills_v, fill_v}};
  return (int)fd::launch_route<false>(p, dtype, Dh, B, nb, s);
}

// The heads route: operands as for the fused route; nb and spb the slot
// blocks a (request, KV head) and slots a block
// (kernels/paged_attention.py::heads_partition).  Zeroes counts (int32[8
// + B]: the AT counts, then poison_end) on the stream, launches page_scan
// (slot_counts (B, M), flags (B, M, 2)), then decode_heads.  Returns the
// first error.
extern "C" int repro_paged_decode_heads(
    const void* q, const void* kp, const void* vp, const int* bt,
    const int* pos, int dtype, int B, int H, int Dh, int P, int L, int pg,
    int Kh, int M, int layer, int nb, int spb, const int* det_k,
    const int* det_v, unsigned int fill_k, unsigned int fill_v,
    const unsigned int* fills_k, const unsigned int* fills_v, void* out,
    int* slot_counts, int* flags, int* counts, void* stream) {
  const int es = dtype == repro::DT_F32 ? 4 : 2;
  if (!fd::decode_shape_ok(dtype, B, H, Dh, P, L, pg, Kh, M, layer) ||
      nb < 1 || nb > fd::MAX_CLUSTER || spb < 1 || (nb - 1) * spb >= M ||
      nb * spb < M)
    return (int)cudaErrorInvalidValue;
  const int round = fd::round_slots(H / Kh, Dh, pg, 1, es, spb);
  if (round < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = paged::launch_scan(kp, vp, bt, dtype, B, M, L, pg, Kh, Dh,
                                       layer, det_k, det_v, fill_v, fills_v,
                                       slot_counts, flags, counts, s);
  if (err != cudaSuccess) return (int)err;
  const repro::Detector dk = repro::detector_from(det_k),
                        dv = repro::detector_from(det_v);
  const fd::Decode p{static_cast<const uint8_t*>(q),
                     static_cast<const uint8_t*>(kp),
                     static_cast<const uint8_t*>(vp),
                     bt,
                     pos,
                     static_cast<uint8_t*>(out),
                     nullptr,
                     nullptr,
                     flags,
                     H,
                     Kh,
                     M,
                     L,
                     pg,
                     layer,
                     spb,
                     round,
                     (float)(1.0 / std::sqrt((double)Dh)),
                     dk,
                     dv,
                     hopper::fatal_floor(dk),
                     hopper::fatal_floor(dv),
                     {fills_k, fill_k},
                     {fills_v, fill_v}};
  return (int)fd::launch_route<true>(p, dtype, Dh, B, nb, s);
}
