// One-token paged decode attention with fused on-read repair, serial or
// split-K: two routes, chosen by the wrapper from dtypes, shapes and
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
// walk route (`decode_partials` + `lse_merge`): any shape.  One block walks
// one (request b, split s) slice of the block table: for each slot it
// loads the K and V tiles, repairs them into shared memory as f32 and runs
// the online softmax, then writes its unnormalised (acc, m, l) partial; a
// second launch merges the partials.  With splits == 1 the merge is exactly
// the serial flush.  Loads are serialised (one scalar load per lane per
// step, a round trip per step), a score is one thread's serial dot
// product, and B x splits blocks fill few SMs: at the engine's shapes it
// loses several times to SDPA's device time (PERF.md section 6).
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
//     in shared memory; at the end every block but the cluster's leader
//     writes it into the leader's shared memory through distributed shared
//     memory and leaves (a cluster barrier arrived at entry and waited for
//     here shows the leader has started; a second one, arrived after the
//     writes, releases them to the leader), and the leader merges the
//     partials and writes the normalised output in vector stores.
//   The counts are zeroed by a memset on the stream before the launch.
//   Against the plain version with `splits`, p is rounded against another
//   running max where the partitions differ, so outputs agree within the
//   dtype's tolerance, not bitwise; the plain twin of the kernel's own
//   partition is kernels/paged_attention.py::paged_decode_fused_plain.
#include <cooperative_groups.h>

#include <cmath>

#include "hopper.cuh"

namespace {

using repro::Detector;
using repro::NEG_INF;
using repro::Storage;

constexpr int kThreads = 256;

template <int DT>
__global__ void decode_partials(
    const typename Storage<DT>::bits_t* q, const typename Storage<DT>::bits_t* kp,
    const typename Storage<DT>::bits_t* vp, const int* bt, const int* pos,
    int H, int Dh, int L, int pg, int Kh, int M, int ns, int layer,
    float sm_scale, Detector det_k, Detector det_v, repro::Fill fill_k,
    repro::Fill fill_v, float* o_part, float* m_part, float* l_part,
    int* slot_counts, int* counts) {
  extern __shared__ float smem[];
  const int ks = Dh + 1;                  // padded K row stride
  const int rows = pg * Kh;               // (token, kv head) rows per page
  float* q_s = smem;                      // H x Dh
  float* k_s = q_s + H * Dh;              // rows x ks
  float* v_s = k_s + rows * ks;           // rows x Dh
  float* acc = v_s + rows * Dh;           // H x Dh
  float* p_s = acc + H * Dh;              // H x pg
  float* m_s = p_s + H * pg;              // H
  float* l_s = m_s + H;                   // H
  float* a_s = l_s + H;                   // H (rescale factors)
  int* cnt = reinterpret_cast<int*>(a_s + H);  // nan_k, inf_k, nan_v, inf_v

  const int b = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int G = H / Kh;
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
  const long long tile = (long long)rows * Dh;
  for (int jj = 0; jj < ns; ++jj) {
    const int j = s * ns + jj;
    const long long page = bt[b * M + j];
    const long long base = (page * L + layer) * tile;
    if (tid < 4) cnt[tid] = 0;
    __syncthreads();
    repro::repair_tile<DT>(kp + base, rows, Dh, ks, det_k, fill_k, page, k_s,
                           &cnt[0]);
    repro::repair_tile<DT>(vp + base, rows, Dh, Dh, det_v, fill_v, page, v_s,
                           &cnt[2]);
    __syncthreads();
    if (tid == 0) {
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
    // scores of this page, masked by position
    for (int i = tid; i < H * pg; i += blockDim.x) {
      const int h = i / pg, t = i % pg;
      const float* qr = q_s + h * Dh;
      const float* kr = k_s + (t * Kh + h / G) * ks;
      float dot = 0.f;
      for (int d = 0; d < Dh; ++d) dot += qr[d] * kr[d];
      p_s[i] = (j * pg + t <= bound) ? dot * sm_scale : NEG_INF;
    }
    __syncthreads();
    // online-softmax state, one thread per head
    for (int h = tid; h < H; h += blockDim.x) {
      float mx = m_s[h];
      for (int t = 0; t < pg; ++t) mx = fmaxf(mx, p_s[h * pg + t]);
      float sum = 0.f;
      for (int t = 0; t < pg; ++t) {
        const float sv = p_s[h * pg + t];
        const float p = sv > NEG_INF * 0.5f ? expf(sv - mx) : 0.f;
        sum += p;
        p_s[h * pg + t] = Storage<DT>::quantize(p);
      }
      const float alpha = expf(m_s[h] - mx);
      a_s[h] = alpha;
      l_s[h] = l_s[h] * alpha + sum;
      m_s[h] = mx;
    }
    __syncthreads();
    for (int i = tid; i < H * Dh; i += blockDim.x) {
      const int h = i / Dh, d = i % Dh;
      const float* pr = p_s + h * pg;
      const float* vc = v_s + (h / G) * Dh + d;
      float pv = 0.f;
      for (int t = 0; t < pg; ++t) pv += pr[t] * vc[t * Kh * Dh];
      acc[i] = acc[i] * a_s[h] + pv;
    }
    __syncthreads();
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
                   int pg, int Kh, int M, int splits, int layer,
                   const int* det_k, const int* det_v, repro::Fill fill_k,
                   repro::Fill fill_v, float* o_part, float* m_part,
                   float* l_part, int* slot_counts, int* counts, void* out,
                   cudaStream_t stream) {
  using bits_t = typename Storage<DT>::bits_t;
  const int rows = pg * Kh;
  const size_t smem = sizeof(float) * ((size_t)H * Dh * 2 + (size_t)rows * (Dh + 1) +
                                       (size_t)rows * Dh + (size_t)H * pg + 3 * H) +
                      4 * sizeof(int);
  cudaError_t err = repro::allow_smem((const void*)decode_partials<DT>, smem);
  if (err != cudaSuccess) return err;
  const float sm_scale = 1.0f / sqrtf((float)Dh);
  decode_partials<DT><<<dim3(B, splits), kThreads, smem, stream>>>(
      static_cast<const bits_t*>(q), static_cast<const bits_t*>(kp),
      static_cast<const bits_t*>(vp), bt, pos, H, Dh, L, pg, Kh, M, M / splits,
      layer, sm_scale, repro::detector_from(det_k), repro::detector_from(det_v),
      fill_k, fill_v, o_part, m_part, l_part, slot_counts, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lse_merge<DT><<<B, kThreads, 0, stream>>>(o_part, m_part, l_part, splits, H,
                                            Dh, static_cast<bits_t*>(out));
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fused route
namespace fd {

namespace cg = cooperative_groups;
using hopper::bulk_load;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

constexpr int MAX_HEAD_WARPS = 16;  // one warp a query head, up to 16
constexpr int MAX_THREADS = 32 * (MAX_HEAD_WARPS + 1);  // + the counting warp
constexpr int MAX_CLUSTER = 8;      // the portable cluster size
constexpr int MAX_ROUND = 32;       // slots a round: one lane of warp 0 each
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block

// What every block of one call shares.
struct Decode {
  const uint8_t* q;     // (B, H, D)
  const uint8_t* kp;    // (P, L, pg, Kh, D)
  const uint8_t* vp;
  const int* bt;        // (B, M)
  const int* pos;       // (B,)
  uint8_t* out;         // (B, H, D)
  int* slot_counts;     // (B, M)
  int* counts;          // int32[8], zeroed before the launch
  int H, Kh, M, L, pg, layer;
  int spb, round;       // slots a block, slots a round
  float scale;
  Detector det_k, det_v;
  uint32_t floor_k, floor_v;  // fatal_floor of each detector
  repro::Fill fill_k, fill_v;  // a table is indexed by page id
};

// Byte offsets into a block's dynamic shared memory: the mbarrier, q's row
// (H, D) and the round's tiles (per slot K then V, (pg, Kh, D) each) in the
// storage dtype, then f32 acc (H, D), the other blocks' acc (parts, H, D:
// filled in the cluster's leader only), a page's scores and softmax weights
// for each head warp (H, pg), m and l (H each), the other blocks' m and l
// (parts, H each), and int32 counts (round, 4: NaN K, Inf K, NaN V, Inf V).
struct Layout {
  long long q, tiles, acc, pacc, s, m, l, pm, pl, cnt, total;
  __host__ __device__ Layout(int H, int D, int pg, int Kh, int es, int round,
                             int parts) {
    const long long tb = (long long)pg * Kh * D * es;
    q = 16;
    tiles = q + (long long)H * D * es;
    acc = tiles + 2 * round * tb;
    pacc = acc + 4ll * H * D;
    s = pacc + 4ll * parts * H * D;
    m = s + 4ll * H * pg;
    l = m + 4ll * H;
    pm = l + 4ll * H;
    pl = pm + 4ll * parts * H;
    cnt = pl + 4ll * parts * H;
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

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;  // NaN wins, as torch.maximum's
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_fsum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// The 16 / size lanes of a 16-byte chunk as f32.
template <int DT>
__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (DT == repro::DT_F32) {
      f[i] = __uint_as_float(w[i]);
    } else if constexpr (DT == repro::DT_BF16) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    } else {
      const float2 h = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = h.x;
      f[2 * i + 1] = h.y;
    }
  }
}

// N consecutive lanes (N * size = 4, 8 or 16 bytes, aligned) as f32.
template <int DT, int N>
__device__ __forceinline__ void load_lanes(const uint8_t* ptr, float* f) {
  constexpr int WORDS = N * (DT == repro::DT_F32 ? 4 : 2) / 4;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if constexpr (WORDS == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(ptr);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (WORDS == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(ptr);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(ptr);
  }
#pragma unroll
  for (int i = 0; i < WORDS; ++i) {
    if constexpr (DT == repro::DT_F32) {
      f[i] = __uint_as_float(w[i]);
    } else if constexpr (DT == repro::DT_BF16) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    } else {
      const float2 h = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = h.x;
      f[2 * i + 1] = h.y;
    }
  }
}

// Four f32 values in the storage dtype (round to nearest even, as the
// plain version's cast), stored at `ptr` (aligned to their size).
template <int DT>
__device__ __forceinline__ void store4(uint8_t* ptr, const float4& v) {
  if constexpr (DT == repro::DT_F32) {
    *reinterpret_cast<float4*>(ptr) = v;
  } else {
    using S = Storage<DT>;
    *reinterpret_cast<uint2*>(ptr) = make_uint2(
        (uint32_t)S::from_float(v.x) | ((uint32_t)S::from_float(v.y) << 16),
        (uint32_t)S::from_float(v.z) | ((uint32_t)S::from_float(v.w) << 16));
  }
}

// Whether a 16-byte chunk may hold a fatal lane: its largest exponent field
// against the detector's floor (hopper.cuh's prefilter, for 32-bit lanes
// too).
template <int DT>
__device__ __forceinline__ bool suspect(const uint4& v, uint32_t exp_mask,
                                        uint32_t floor) {
  if constexpr (DT == repro::DT_F32) {
    const uint32_t m = max(max(v.x & exp_mask, v.y & exp_mask),
                           max(v.z & exp_mask, v.w & exp_mask));
    return m >= floor;
  } else {
    return hopper::may_be_fatal(v, exp_mask, floor);
  }
}

// Repairs the fatal lanes of a suspect chunk in place; returns its NaN
// lanes | Inf lanes << 16 (out of line: clean data never calls it).
template <int DT>
__device__ __noinline__ int repair_vec(uint4* chunk, const Detector det,
                                       uint32_t fill) {
  const uint4 v = *chunk;
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
  int n_nan = 0, n_inf = 0;
  constexpr int LANES = DT == repro::DT_F32 ? 4 : 8;
#pragma unroll
  for (int e = 0; e < LANES; ++e) {
    const int i = DT == repro::DT_F32 ? e : e >> 1;
    const int sh = DT == repro::DT_F32 ? 0 : (e & 1) * 16;
    const uint32_t lane_mask = DT == repro::DT_F32 ? 0xFFFFFFFFu : 0xFFFFu;
    const int c = repro::classify((w[i] >> sh) & lane_mask, det);
    n_nan += c & 1;
    n_inf += c >> 1;
    if (c) w[i] = (w[i] & ~(lane_mask << sh)) | (fill << sh);
  }
  if (n_nan | n_inf) *chunk = make_uint4(w[0], w[1], w[2], w[3]);
  return n_nan | (n_inf << 16);
}

// One head's online-softmax walk over the round's n pages (one warp):
// scores of a page by pairs of lanes per key (each half a row, chunks in a
// rotated order so that a quarter-warp's 16-byte reads hit distinct banks),
// then the softmax step in the warp (p rounded to the storage dtype), then
// acc = acc * alpha + P . V with the lanes over D.
template <int DT, int D>
__device__ __forceinline__ void head_walk(const Decode& p, int h, int n, int jr,
                                          int bound, const uint8_t* q_s,
                                          const uint8_t* tiles, float* acc,
                                          float* sw, float* m_s, float* l_s) {
  constexpr int ES = DT == repro::DT_F32 ? 4 : 2;
  constexpr int VEC = 16 / ES;      // lanes of a 16-byte chunk
  constexpr int CPL = D / VEC / 2;  // chunks of half a row
  constexpr int DPL = D / 32;       // dims of a lane in P . V
  const int lane = threadIdx.x & 31, x = lane & 1;
  const int Kh = p.Kh, pg = p.pg, kh = h / (p.H / Kh);
  const uint32_t tb = (uint32_t)(pg * Kh * D * ES);
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
            reinterpret_cast<const uint4*>(kt + (t * Kh + kh) * D * ES) + x * CPL;
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
      load_lanes<DT, DPL>(vr + (long long)t * Kh * D * ES, vf);
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

// Grid (nb, B), clusters of (nb, 1, 1), blocks of 32 * (min(H, 16) + 1)
// threads: block `rank` of request b owns slots rank * spb .. min(M, rank
// * spb + spb) - 1, both KV heads.  Warp w < min(H, 16) walks heads w, w +
// 16, ...; the last warp counts.
template <int DT, int D>
__global__ void __launch_bounds__(MAX_THREADS)
    decode_fused(const __grid_constant__ Decode p) {
  constexpr int ES = DT == repro::DT_F32 ? 4 : 2;
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, head_warps = nthreads / 32 - 1;
  const int rank = blockIdx.x, nb = gridDim.x, b = blockIdx.y;
  const int H = p.H, pg = p.pg;
  const int j0 = rank * p.spb, j1 = min(p.M, j0 + p.spb);
  const uint32_t tb = (uint32_t)(pg * p.Kh * D * ES);   // one tile's bytes
  const Layout lay(H, D, pg, p.Kh, ES, p.round, nb - 1);
  const uint32_t bar = smem_u32(smem);
  uint8_t* q_s = smem + lay.q;
  uint8_t* tiles = smem + lay.tiles;
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  int* cnt = reinterpret_cast<int*>(smem + lay.cnt);

  // lane i of warp 0: the byte offset of slot jr + i's tiles at `layer`
  long long src = 0;
  auto fetch = [&](int jr) {
    if (warp == 0 && lane < min(p.round, j1 - jr))
      src = ((long long)p.bt[(long long)b * p.M + jr + lane] * p.L + p.layer) *
            tb;
  };
  fetch(j0);
  const int bound = p.pos[b];
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < H * D; i += nthreads) acc[i] = 0.f;
  for (int i = tid; i < H; i += nthreads) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }
  for (int i = tid; i < 4 * p.round; i += nthreads) cnt[i] = 0;
  __syncthreads();
  // the first cluster phase: its wait, before the partials move, shows that
  // every block of the cluster has started
  cluster_arrive_relaxed();

  for (int jr = j0, it = 0; jr < j1; jr += p.round, ++it) {
    const int n = min(p.round, j1 - jr);
    // ---- every load of the round at once, behind one barrier
    if (warp == 0) {
      if (it > 0) fetch(jr);
      if (lane == 0) {
        const uint32_t qb = it == 0 ? (uint32_t)(H * D * ES) : 0u;
        mbar_expect_tx(bar, 2u * n * tb + qb);
        if (qb) bulk_load(smem_u32(q_s), p.q + (long long)b * qb, qb, bar);
      }
      __syncwarp();
      if (lane < n) {
        uint8_t* dst = tiles + 2ll * lane * tb;
        bulk_load(smem_u32(dst), p.kp + src, tb, bar);
        bulk_load(smem_u32(dst + tb), p.vp + src, tb, bar);
      }
    }
    mbar_wait(bar, it & 1);

    // ---- repair in place, counts per slot
    {
      const int cpt = (int)(tb / 16);   // chunks of a tile
      uint4* chunks = reinterpret_cast<uint4*>(tiles);
      for (int c = tid; c < 2 * n * cpt; c += nthreads) {
        const int op = (c / cpt) & 1;   // 0: K, 1: V
        const uint32_t floor = op ? p.floor_v : p.floor_k;
        const uint32_t exp_mask = op ? p.det_v.exp_mask : p.det_k.exp_mask;
        if (suspect<DT>(chunks[c], exp_mask, floor)) {
          // the fill of the slot's page, whichever block holds the slot
          const int slot = c / (2 * cpt);
          const repro::Fill& f = op ? p.fill_v : p.fill_k;
          const uint32_t fill =
              f.table ? f.at(p.bt[(long long)b * p.M + jr + slot]) : f.value;
          const int r = op ? repair_vec<DT>(chunks + c, p.det_v, fill)
                           : repair_vec<DT>(chunks + c, p.det_k, fill);
          int* sc = cnt + 4 * slot + 2 * op;
          if (r & 0xFFFF) atomicAdd(sc, r & 0xFFFF);
          if (r >> 16) atomicAdd(sc + 1, r >> 16);
        }
      }
    }
    __syncthreads();

    if (warp == head_warps) {
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
        head_walk<DT, D>(p, h, n, jr, bound, q_s, tiles, acc, s_s + warp * pg,
                         m_s, l_s);
    }
    // the next round's bulk copies overwrite what the threads read and
    // wrote
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
  }

  // ---- merge: every block but the cluster's leader (rank 0) writes its
  // unnormalised partial into the leader's shared memory and leaves; the
  // leader merges, a float4 of one head's acc per thread: w_r = exp(m_r -
  // max m) for live partials, 0 for dead ones (0 * NaN still reaches the
  // output, as in the reference's merge)
  cluster_wait();
  float* pacc = reinterpret_cast<float*>(smem + lay.pacc);
  float* pm = reinterpret_cast<float*>(smem + lay.pm);
  float* pl = reinterpret_cast<float*>(smem + lay.pl);
  if (rank > 0) {
    const int part = rank - 1;
    float4* dst = reinterpret_cast<float4*>(
        cluster.map_shared_rank(pacc + (long long)part * H * D, 0));
    const float4* src4 = reinterpret_cast<const float4*>(acc);
    for (int i = tid; i < H * D / 4; i += nthreads) dst[i] = src4[i];
    float* dm = cluster.map_shared_rank(pm + part * H, 0);
    float* dl = cluster.map_shared_rank(pl + part * H, 0);
    for (int h = tid; h < H; h += nthreads) {
      dm[h] = m_s[h];
      dl[h] = l_s[h];
    }
    cluster_arrive();
    return;
  }
  cluster_arrive();
  cluster_wait();
  for (int item = tid; item < H * (D / 4); item += nthreads) {
    const int h = item / (D / 4), c4 = item - h * (D / 4);
    float mr[MAX_CLUSTER], lr[MAX_CLUSTER];
    float4 ar[MAX_CLUSTER];
    mr[0] = m_s[h];
    lr[0] = l_s[h];
    ar[0] = reinterpret_cast<const float4*>(acc + h * D)[c4];
#pragma unroll
    for (int r = 1; r < MAX_CLUSTER; ++r) {
      if (r < nb) {
        mr[r] = pm[(r - 1) * H + h];
        lr[r] = pl[(r - 1) * H + h];
        ar[r] = reinterpret_cast<const float4*>(
            pacc + ((long long)(r - 1) * H + h) * D)[c4];
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
    store4<DT>(p.out + (((long long)b * H + h) * D + 4 * c4) * ES,
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
  while (r > 0 && Layout(H, D, pg, Kh, es, r, MAX_CLUSTER - 1).total > SMEM_LIMIT)
    --r;
  return r;
}

template <int DT, int D>
cudaError_t launch(const Decode& p, int B, int nb, cudaStream_t stream) {
  constexpr int ES = DT == repro::DT_F32 ? 4 : 2;
  const size_t smem =
      (size_t)Layout(p.H, D, p.pg, p.Kh, ES, p.round, nb - 1).total;
  static size_t smem_set = 48 * 1024;  // the attribute, raised as needed
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)decode_fused<DT, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb, B, 1);
  cfg.blockDim = dim3(32 * ((p.H < MAX_HEAD_WARPS ? p.H : MAX_HEAD_WARPS) + 1), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_fused<DT, D>, p);
}

}  // namespace fd

}  // namespace

// q (B, H, Dh), pages (P, L, pg, Kh, Dh) in `dtype` (0 f32, 1 bf16, 2 f16);
// bt (B, M) and pos (B,) int32 on the device; det_k/det_v host int32[8];
// fill_k/fill_v the repaired lanes' bit patterns, or with fills_k/fills_v
// (device uint32 per page of the layer, from repro_tile_fill; null: none)
// the page's entry.  Outputs: o_part (B, splits, H, Dh), m_part/l_part
// (B, splits, H) f32 scratch, slot_counts (B, M) int32, counts int32[8]
// (zeroed by the caller), out (B, H, Dh) in `dtype`.  Returns
// cudaGetLastError() after the launches.
extern "C" int repro_paged_decode(
    const void* q, const void* kp, const void* vp, const int* bt,
    const int* pos, int dtype, int B, int H, int Dh, int L, int pg, int Kh,
    int M, int splits, int layer, const int* det_k, const int* det_v,
    unsigned int fill_k_bits, unsigned int fill_v_bits,
    const unsigned int* fills_k, const unsigned int* fills_v, float* o_part,
    float* m_part, float* l_part, int* slot_counts, int* counts, void* out,
    void* stream) {
  if (splits < 1 || M % splits != 0 || H % Kh != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const repro::Fill fill_k{fills_k, fill_k_bits}, fill_v{fills_v, fill_v_bits};
  switch (dtype) {
    case repro::DT_F32:
      return (int)launch<repro::DT_F32>(q, kp, vp, bt, pos, B, H, Dh, L, pg, Kh,
                                        M, splits, layer, det_k, det_v, fill_k,
                                        fill_v, o_part, m_part, l_part,
                                        slot_counts, counts, out, s);
    case repro::DT_BF16:
      return (int)launch<repro::DT_BF16>(q, kp, vp, bt, pos, B, H, Dh, L, pg,
                                         Kh, M, splits, layer, det_k, det_v,
                                         fill_k, fill_v, o_part, m_part, l_part,
                                         slot_counts, counts, out, s);
    case repro::DT_F16:
      return (int)launch<repro::DT_F16>(q, kp, vp, bt, pos, B, H, Dh, L, pg,
                                        Kh, M, splits, layer, det_k, det_v,
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
  if (dtype < repro::DT_F32 || dtype > repro::DT_F16 || (Dh != 64 && Dh != 128) ||
      B < 1 || H < 1 || Kh < 1 || H % Kh || P < 1 || L < 1 || pg < 1 ||
      M < 1 || layer < 0 || layer >= L || B > 65535)
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
  switch (dtype * 2 + (Dh == 128)) {
    case 2 * repro::DT_F32: return (int)fd::launch<repro::DT_F32, 64>(p, B, nb, s);
    case 2 * repro::DT_F32 + 1: return (int)fd::launch<repro::DT_F32, 128>(p, B, nb, s);
    case 2 * repro::DT_BF16: return (int)fd::launch<repro::DT_BF16, 64>(p, B, nb, s);
    case 2 * repro::DT_BF16 + 1: return (int)fd::launch<repro::DT_BF16, 128>(p, B, nb, s);
    case 2 * repro::DT_F16: return (int)fd::launch<repro::DT_F16, 64>(p, B, nb, s);
    default: return (int)fd::launch<repro::DT_F16, 128>(p, B, nb, s);
  }
}
