// Flash attention (online softmax) with the K/V tiles repaired on load, and
// the AT event counts.
//
// Replaces src/repro/kernels/repair_attention.py::_flash_kernel (:44, behind
// `flash_attention_raw`).  What every route computes: per (b, h) query
// head, over KV head h / G (G = H / Kh), with every fatal K/V lane taking
// the fill's bit pattern (precomputed by the host in the storage dtype, or
// for neighbor_mean its logical (bk, D) tile's entry of the table that
// tile_fill.cu wrote):
//   s = q . k^T * (1 / sqrt(D)) in f32; masked positions get -1e30 (the
//   reference's mask value, not -inf); m_new = max(m, rowmax s);
//   p = exp(s - m_new); alpha = exp(m - m_new); l = l * alpha + rowsum p;
//   acc = acc * alpha + p . v;  out = acc / max(l, 1e-30), in q's dtype.
// Causal masking is the reference kernel's top-left alignment (query s sees
// keys t <= s, also for S != T).  q is not repaired, as in the reference.
// Three routes, chosen by the wrapper from dtypes, shapes and alignment
// alone (kernels/repair_attention.py::route):
//
// FFMA route (`flash_count_tiles`, `flash_counts`, `flash_repair_fwd`): the
// calls the other two do not take (mixed dtypes, views off 16-byte
// alignment), D 64 or 128.  One block per (b, h, 64-row q tile)
// walks the K/V tiles from position 0, repairs each 64-key tile into shared
// memory as f32 and multiplies on the FP32 pipe (padded shared memory, row
// stride D + 1; 4 x 4 scores and 4 x D/16 outputs per thread; p stays
// f32).  Tiles past the q tile's last row are skipped; heavy (late) causal
// q tiles are launched first.  It is the exact-f32 path (no TF32).
//
// wgmma route (`flash_scan`, `flash_repair_wgmma`, `flash_counts`): q, k, v
// all bf16 or all f16, D 64 or 128, 16-byte aligned.  What bounds it on an
// H100: operations, 2*B*H*S*T*D flops of causal work at S = T against the
// 16-bit tensor-core peak (989 TFLOP/s).  A 128 x 128 score tile is ~2,000
// clocks of tensor work on one SM; classifying its 32K K/V lanes inside the
// loop (~10 integer operations each on 64 INT32 lanes: ~5,000 clocks), on
// each of the G * L visits of a K/V tile, would cost twice that.
// So detection leaves the main loop, as in repair_matmul.cu:
//   * `flash_scan` reads K and V once (16-byte loads, the exponent-floor
//     prefilter; `classify` only on suspect vectors), adds each fatal lane
//     of the logical live prefix into its logical tile's counters (each
//     lane exactly once) and raises one K and one V flag per physical
//     128-row tile that holds a fatal lane, over every row the main kernel
//     loads: a causal q tile loads keys up to min(T, q0 + 128), keys that
//     can be masked for every row or lie past the live prefix, and a fatal
//     lane there would still poison P . V (0 * NaN).  Floor: bytes, the
//     K/V read over 3.35 TB/s.
//   * `flash_repair_wgmma`: one block per (b, h, 128-row q tile), heavy
//     causal tiles first.  A producer warp loads the Q tile once and keeps
//     a ring of K/V stages (2 for D = 128, 3 for D = 64) in flight by TMA
//     (3D tensor maps over (B * heads, rows, D): a box never reads the next
//     head's rows, and rows past S or T are zeros), 128-byte swizzle,
//     full/empty mbarriers.  Two consumer warpgroups own 64 q rows each
//     (the step below lives in attention_wgmma.cuh, shared with
//     paged_prefill.cu):
//     S = Q K^T by wgmma m64n128k16 (both K-major), the mask and the online
//     softmax on the accumulator fragment (exp2 with a log2(e) prescale;
//     row max and sum over the four lanes of a quad), P rounded to the
//     operand dtype and fed from registers to O += P V by wgmma m64n{D}k16
//     (V MN-major through the transposed-B bit).  A stage whose K or V
//     tile is flagged is repaired in shared memory first by both consumer
//     warpgroups: every fatal lane of a row before T takes the fill (rows
//     at or past T are TMA's zero padding and are never touched), then
//     fence.proxy.async and a named barrier hand the tile to wgmma.
//     Unflagged stages go straight to wgmma, with no integer work at all.
//     Out is written from the accumulators with the S edge guarded.
//   Unlike the reference and the FFMA route, P is rounded to bf16/f16
//   before the value product, as every tensor-core flash kernel does.
//   On the H100 the main loop is held by the K/V tiles that every block
//   reads from L2 (64 KB per 128-key step and block), not by the tensor
//   cores: running P . V in flight under the next tile's softmax measured
//   no faster (PERF.md §6), so the loop stays serial.
//
// f32 route (`flash_scan`, `flash_repair_f32`, `flash_counts`): q, k, v all
// f32, contiguous, D 64 or 128, 16-byte aligned.  Exact f32: FFMA on the
// FP32 pipe and P kept in f32, as the reference keeps it.  Bound by
// operations, 2*B*H*S*T*D causal flops against the FP32 pipe's 67 TFLOP/s,
// so detection leaves the loop as on the wgmma route:
//   * `flash_scan` on four f32 lanes a vector flags 64-row K/V tiles over
//     every row a 64-row q tile loads.
//   * `flash_repair_f32`: one block per (b, h, 64-row q tile), heavy causal
//     tiles first, one block an SM (the heaviest q tile's 32 steps at S =
//     2,048 stay under an SM's share of the causal work, so the blocks
//     balance).  Q is loaded once.  Two groups of four warps split the
//     q tile's 64-key K/V tiles (group g takes tiles g, g + 2, ...), each
//     with its own K and V slots filled by cp.async: V_j loads under
//     S = Q K_j^T and K_{j+2} under O += P V_j, one group barrier each.  A
//     warp owns 16 q rows; a lane computes a 4 x 8 score tile and a 4 x
//     D/8 output tile in registers from conflict-free float4 reads (rows
//     padded to D + 4 floats).  The row max goes through warp shuffles, the
//     running (m, l, O) stays in registers, P goes to the warp's own shared
//     memory once a tile.  Only the diagonal tile (and a tile that reaches
//     past T) is masked, with the reference's -1e30.  A flagged K or V tile
//     is repaired in shared memory by its group first, then a group
//     barrier.  At the end group 1 hands its (m, l, O) to group 0, which
//     merges the two partitions and writes acc / max(l, 1e-30).  The plain
//     twin of this key partition is
//     kernels/repair_attention.py::flash_attention_f32_plain.
//
// Counts (every route): defined on the reference's logical (bq, bk) grid,
// whose tiles no route shares.  Per logical (b, kh, kj) tile of the live
// prefix, [NaN K, Inf K, NaN V, Inf V] lanes are added into per-tile
// counters (by `flash_count_tiles`, a pass that reads the live K/V tiles
// once more, or by `flash_scan`), and a one-block epilogue
// (`flash_counts`) weights every tile by its visit count G * L(kj)
// (L(kj) = q tiles with kj*bk <= qi*bq + bq - 1 when causal, S / bq
// otherwise) into the seven AT counts.
#include <algorithm>

#include "attention_wgmma.cuh"

namespace {

using repro::Detector;
using repro::NEG_INF;
using repro::Storage;

constexpr int BQ = 64, BKV = 64, kThreads = 256;
constexpr int PS = BKV + 1;       // row stride of the score tile
constexpr long long kChunk = 8192;  // lanes per counting block

// The live logical K/V tiles form a prefix: kj*bk <= S - 1 when causal.
inline int live_tiles(int S, int T, int bk, int causal) {
  const int nk = T / bk, s_tiles = (S + bk - 1) / bk;
  return causal && s_tiles < nk ? s_tiles : nk;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BKV * (D + 1) +
                          (size_t)BKV * D + (size_t)BQ * PS + 3 * BQ);
}

template <int DT, int D>
__global__ void __launch_bounds__(kThreads)
    flash_repair_fwd(const typename Storage<DT>::bits_t* __restrict__ q,
                     const typename Storage<DT>::bits_t* __restrict__ k,
                     const typename Storage<DT>::bits_t* __restrict__ v,
                     typename Storage<DT>::bits_t* __restrict__ out, int H,
                     int Kh, int S, int T, int causal, float sm_scale,
                     Detector det_k, Detector det_v, repro::Fill fill_k,
                     repro::Fill fill_v, int bk) {
  constexpr int QS = D + 1;  // row stride of q_s and k_s
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;               // BQ x QS
  float* k_s = q_s + BQ * QS;      // BKV x QS
  float* v_s = k_s + BKV * QS;     // BKV x D
  float* p_s = v_s + BKV * D;      // BQ x PS
  float* m_s = p_s + BQ * PS;      // BQ
  float* l_s = m_s + BQ;           // BQ
  float* a_s = l_s + BQ;           // BQ

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // late (heavy) tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Kh);
  const int q0 = qt * BQ;
  const long long q_base = ((long long)b * H + h) * S * D;
  const long long kv_base = ((long long)b * Kh + kh) * T * D;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_s[r * QS + d] = q0 + r < S ? Storage<DT>::to_float(
                                       q[q_base + (long long)(q0 + r) * D + d])
                                 : 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  const int kv_end = causal ? min(T, q0 + BQ) : T;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BKV * D; i += kThreads) {
      const int t = i / D, d = i % D;
      float kf = 0.f, vf = 0.f;
      if (k0 + t < T) {
        const long long off = kv_base + (long long)(k0 + t) * D + d;
        uint32_t kb = k[off], vb = v[off];
        // the logical tile of row (b, kh, k0 + t) of the (B*Kh*T, D) view
        if (repro::classify(kb, det_k)) kb = fill_k.at((kv_base / D + k0 + t) / bk);
        if (repro::classify(vb, det_v)) vb = fill_v.at((kv_base / D + k0 + t) / bk);
        kf = Storage<DT>::to_float(kb);
        vf = Storage<DT>::to_float(vb);
      }
      k_s[t * QS + d] = kf;
      v_s[t * D + d] = vf;
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = k_s[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool masked = kpos >= T || (causal && kpos > q0 + r);
        p_s[r * PS + c] = masked ? NEG_INF : s[i][j] * sm_scale;
      }
    }
    __syncthreads();

    // online softmax: four threads per row, 16 keys each
    {
      const int r = tid >> 2, part = tid & 3;
      float* pr = p_s + r * PS + part * 16;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int t = 0; t < BKV; ++t) {
      float pa[4], vb[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = p_s[(ty + 16 * i) * PS + t];
#pragma unroll
      for (int j = 0; j < DC; ++j) vb[j] = v_s[t * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
    const long long row = q_base + (long long)(q0 + r) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      out[row + tx + 16 * j] = Storage<DT>::from_float(acc[i][j] / denom);
  }
}

// Per logical (b, kh, kj) tile of the live prefix: [NaN K, Inf K, NaN V,
// Inf V] lanes into tiles[4 * ((b * Kh + kh) * nk + kj) + ...].
template <typename bits_t>
__global__ void flash_count_tiles(const bits_t* k, const bits_t* v, int T,
                                  int D, int bk, int nk, int n_live,
                                  Detector det_k, Detector det_v, int* tiles) {
  __shared__ int cnt[4];
  if (threadIdx.x < 4) cnt[threadIdx.x] = 0;
  __syncthreads();
  const long long bh = blockIdx.x / n_live, kj = blockIdx.x % n_live;
  const long long base = (bh * T + kj * bk) * D;
  const long long n = (long long)bk * D;
  const long long lo = (long long)blockIdx.y * kChunk;
  const long long hi = lo + kChunk < n ? lo + kChunk : n;
  int c[4] = {0, 0, 0, 0};
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int ck = repro::classify(k[base + i], det_k);
    const int cv = repro::classify(v[base + i], det_v);
    c[0] += ck & 1;
    c[1] += ck >> 1;
    c[2] += cv & 1;
    c[3] += cv >> 1;
  }
  for (int s = 0; s < 4; ++s) repro::block_add(&cnt[s], c[s]);
  __syncthreads();
  if (threadIdx.x < 4 && cnt[threadIdx.x])
    atomicAdd(&tiles[4 * (bh * nk + kj) + threadIdx.x], cnt[threadIdx.x]);
}

__global__ void flash_counts(const int* tiles, int n_bh, int nk, int n_live,
                             int G, int nq, int bq, int bk, int causal,
                             int* counts) {
  __shared__ unsigned long long acc[7];
  if (threadIdx.x < 7) acc[threadIdx.x] = 0ull;
  __syncthreads();
  long long v[7] = {0, 0, 0, 0, 0, 0, 0};
  for (long long t = threadIdx.x; t < (long long)n_bh * nk; t += blockDim.x) {
    const int kj = (int)(t % nk);
    if (kj >= n_live) continue;
    long long visits = nq;
    if (causal) {
      visits = 0;
      for (int qi = 0; qi < nq; ++qi)
        visits += (long long)kj * bk <= (long long)qi * bq + bq - 1;
    }
    const long long w = visits * G;
    const int* c = tiles + 4 * t;
    const bool fk = (c[0] + c[1]) > 0, fv = (c[2] + c[3]) > 0;
    v[0] += w * c[0];
    v[1] += w * c[1];
    v[2] += w * fk;
    v[3] += w * c[2];
    v[4] += w * c[3];
    v[5] += w * fv;
    v[6] += w * (fk || fv);
  }
  for (int s = 0; s < 7; ++s)
    if (v[s]) atomicAdd(&acc[s], (unsigned long long)v[s]);
  __syncthreads();
  if (threadIdx.x < 7) counts[threadIdx.x] = (int)acc[threadIdx.x];
  if (threadIdx.x == 7) counts[7] = 0;
}

template <int DT, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Kh, int S, int T, int bq, int bk,
                   int causal, float sm_scale, const int* det_k,
                   const int* det_v, repro::Fill fill_k, repro::Fill fill_v,
                   int* tiles, int* counts, cudaStream_t stream) {
  using bits_t = typename Storage<DT>::bits_t;
  const Detector dk = repro::detector_from(det_k);
  const Detector dv = repro::detector_from(det_v);
  const int nk = T / bk, nq = S / bq;
  const int n_live = live_tiles(S, T, bk, causal);
  cudaError_t err = cudaMemsetAsync(
      tiles, 0, sizeof(int) * 4 * (size_t)B * Kh * nk, stream);
  if (err != cudaSuccess) return err;
  if (n_live > 0 && B * Kh > 0) {
    const dim3 cgrid(B * Kh * n_live,
                     (unsigned)(((long long)bk * D + kChunk - 1) / kChunk));
    flash_count_tiles<bits_t><<<cgrid, kThreads, 0, stream>>>(
        static_cast<const bits_t*>(k), static_cast<const bits_t*>(v), T, D,
        bk, nk, n_live, dk, dv, tiles);
  }
  flash_counts<<<1, kThreads, 0, stream>>>(tiles, B * Kh, nk, n_live, H / Kh,
                                           nq, bq, bk, causal, counts);
  const size_t smem = smem_bytes<D>();
  err = repro::allow_smem((const void*)flash_repair_fwd<DT, D>, smem);
  if (err != cudaSuccess) return err;
  if (S > 0 && B * H > 0)
    flash_repair_fwd<DT, D><<<dim3((S + BQ - 1) / BQ, H, B), kThreads, smem,
                              stream>>>(
        static_cast<const bits_t*>(q), static_cast<const bits_t*>(k),
        static_cast<const bits_t*>(v), static_cast<bits_t*>(out), H, Kh, S, T,
        causal, sm_scale, dk, dv, fill_k, fill_v, bk);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* out, int B, int H, int Kh, int S, int T, int bq,
                     int bk, int causal, float sm_scale, const int* det_k,
                     const int* det_v, repro::Fill fill_k, repro::Fill fill_v,
                     int* tiles, int* counts, cudaStream_t s) {
  if (D == 64)
    return launch<DT, 64>(q, k, v, out, B, H, Kh, S, T, bq, bk, causal,
                          sm_scale, det_k, det_v, fill_k, fill_v, tiles,
                          counts, s);
  if (D == 128)
    return launch<DT, 128>(q, k, v, out, B, H, Kh, S, T, bq, bk, causal,
                           sm_scale, det_k, det_v, fill_k, fill_v, tiles,
                           counts, s);
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------- wgmma route
namespace fw {

using namespace attn;
using attn::BKV;  // not the FFMA route's 64 in the enclosing namespace
using attn::BOX_BYTES;

constexpr int BQ = 128, THREADS = 384, CONSUMERS = 256;
constexpr double LOG2E = 1.4426950408889634;

template <int D>
struct Tile {
  static constexpr int BOXES = D / 64;  // 64-lane boxes per row
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr int OPERAND_BYTES = BOXES * BOX_BYTES;  // a Q, K or V tile
  static constexpr int STAGE_BYTES = 2 * OPERAND_BYTES;    // K, then V
  // Q, the ring, its 1024-byte alignment slack, the barriers (Q; K full,
  // V full and empty per stage) and the stage flags
  static constexpr int SMEM_BYTES = 1024 + OPERAND_BYTES +
                                    STAGES * STAGE_BYTES +
                                    (1 + 3 * STAGES) * 8 + STAGES;
};

// Both consumer warpgroups repair a flagged K or V stage: every consumer
// thread takes its share of the tile's 16-byte chunks (all D lanes of a row
// are in bounds); rows at or past T are TMA's zero padding and are never
// touched.  A chunk's lanes share a row, so one logical (bk, D) tile of
// the (B*Kh*T, D) view: row0 is the head's first row.  Then the tile is
// handed to the async proxy.
template <int D>
__device__ __forceinline__ void repair_stage(uint8_t* tile, int k0, int T,
                                             const Detector& det,
                                             const repro::Fill& fill,
                                             long long row0, int bk) {
  const int rows = min(BKV, T - k0);
  for (int c = threadIdx.x; c < Tile<D>::BOXES * BKV * 8; c += CONSUMERS) {
    const int r = (c >> 3) & (BKV - 1);
    if (r < rows)
      repair_chunk_with(reinterpret_cast<uint4*>(tile) + c, 8, det, [&](int) {
        return fill.at((row0 + k0 + r) / bk);
      });
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// One block per (b, h, 128-row q tile): blocks [i * BH, (i + 1) * BH) take
// q tile nqt - 1 - i of every head, so heavy causal tiles go first.
template <int DT, int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_repair_wgmma(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       uint16_t* __restrict__ out, int BH, int H, int Kh,
                       int S, int T, int causal, float scale_log2,
                       Detector det_k, Detector det_v, repro::Fill fill_k,
                       repro::Fill fill_v, int bk,
                       const int* __restrict__ flags) {
  using C = Tile<D>;
  constexpr int ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the tiles to it
  uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = q_s + C::OPERAND_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + ST * C::STAGE_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* empty = v_full + ST;
  // per stage: bit 0 its K tile is flagged, bit 1 its V tile (written by
  // the producer before the stage's K barrier, which publishes it)
  uint8_t* stage_flags = reinterpret_cast<uint8_t*>(empty + ST);

  const int nqt = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH, q0 = (nqt - 1 - blockIdx.x / BH) * BQ;
  const int kvh = bh / H * Kh + bh % H / (H / Kh);
  const int n_kv = ((causal ? min(T, q0 + BQ) : T) + BKV - 1) / BKV;
  const int* tile_flags = flags + 2ll * kvh * ((T + BKV - 1) / BKV);

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(q_full), 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(smem_u32(&k_full[s]), 1);
      mbar_init(smem_u32(&v_full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS) {
      const uint32_t qb = smem_u32(q_full);
      mbar_expect_tx(qb, C::OPERAND_BYTES);
#pragma unroll
      for (int x = 0; x < C::BOXES; ++x)
        tma_load_3d(smem_u32(q_s + x * BOX_BYTES), &map_q, x * 64, q0, bh, qb);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % ST;
        const int fl = (tile_flags[2 * it] ? 1 : 0) |
                       (tile_flags[2 * it + 1] ? 2 : 0);
        mbar_wait(smem_u32(&empty[s]), ((it / ST) & 1) ^ 1);
        stage_flags[s] = (uint8_t)fl;
        uint8_t* kt = ring + s * C::STAGE_BYTES;
        const uint32_t kb = smem_u32(&k_full[s]), vb = smem_u32(&v_full[s]);
        mbar_expect_tx(kb, C::OPERAND_BYTES);
#pragma unroll
        for (int x = 0; x < C::BOXES; ++x)
          tma_load_3d(smem_u32(kt + x * BOX_BYTES), &map_k, x * 64, it * BKV,
                      kvh, kb);
        mbar_expect_tx(vb, C::OPERAND_BYTES);
#pragma unroll
        for (int x = 0; x < C::BOXES; ++x)
          tma_load_3d(smem_u32(kt + C::OPERAND_BYTES + x * BOX_BYTES), &map_v,
                      x * 64, it * BKV, kvh, vb);
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wgi = threadIdx.x >> 7;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    // accumulator layout of m64nNk16: warp w of the warpgroup holds rows
    // 16w + lane/4 (+8); d[4j..4j+3] columns 8j + 2*(lane%4) (+1), the
    // second pair on row + 8
    const int row_lo = q0 + wgi * 64;
    const int row = row_lo + warp * 16 + (lane >> 2);
    const int col = 2 * (lane & 3);
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const uint32_t q_base = smem_u32(q_s) + wgi * 64 * 128;
    mbar_wait(smem_u32(q_full), 0);
    for (int it = 0; it < n_kv; ++it) {
      const int s = it % ST, k0 = it * BKV;
      const uint32_t parity = (it / ST) & 1;
      uint8_t* kt = ring + s * C::STAGE_BYTES;
      uint8_t* vt = kt + C::OPERAND_BYTES;
      mbar_wait(smem_u32(&k_full[s]), parity);
      const int fl = stage_flags[s];
      if (fl & 1) repair_stage<D>(kt, k0, T, det_k, fill_k, (long long)kvh * T, bk);

      float sc[64];
      qk_tile<DT, D>(sc, q_base, smem_u32(kt));
      // masked positions: a key is masked for a row at or past its limit
      // (T, or the row + 1 when causal); tiles wholly before the limits
      // skip the mask
      if (k0 + BKV > T || (causal && k0 + BKV - 1 > row_lo))
        mask_tile(sc, (causal ? min(T, row + 1) : T) - k0 - col,
                  (causal ? min(T, row + 9) : T) - k0 - col);
      uint32_t pa[32];
      softmax_tile<DT, D>(sc, m, l, o, scale_log2, pa);

      mbar_wait(smem_u32(&v_full[s]), parity);
      if (fl & 2) repair_stage<D>(vt, k0, T, det_v, fill_v, (long long)kvh * T, bk);
      pv_tile<DT, D>(o, pa, smem_u32(vt), BKV / 16);
      mbar_arrive(smem_u32(&empty[s]));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float inv = 1.f / fmaxf(quad_sum(l[i]), 1e-30f);
      const int r = row + 8 * i;
      if (r >= S) continue;
      uint16_t* dst = out + ((long long)bh * S + r) * D + col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack2<DT>(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
    }
  }
}

constexpr int SCAN_THREADS = 256, SCAN_VECS = 2;

// The scan's view of K and V: (B * Kh, T, D) lanes (16-bit, or f32 for the
// f32 route), of which the first `vecs` 16-byte vectors (`rows` rows) of
// each (b, kh) are read.
struct KVScan {
  const uint4* k;
  const uint4* v;
  unsigned vecs;    // rows * D / (a vector's lanes)
  unsigned stride;  // T * D / (a vector's lanes)
  int row_vecs;     // D / (a vector's lanes)
  int live_rows;    // the logical live prefix: the rows that are counted
  int bk, nk, nkv;  // logical tile rows and tiles; physical tiles
  Detector det_k, det_v;
  uint32_t floor_k, floor_v;  // fatal_floor of each detector
  int* tiles;  // [(b * Kh + kh) * nk + kj][NaN K, Inf K, NaN V, Inf V]
  int* flags;  // [(b * Kh + kh) * nkv + p][K, V]
};

// The full test of a suspect vector vi of K (which = 0) or V (1) of head
// bh, of ES-byte lanes, against the main kernel's TILE-row K/V tiles:
// classify, count, flag (out of line: clean data never calls it).  The
// lanes share one row, so one logical and one physical tile.
template <int ES, int TILE>
__device__ __noinline__ void scan_vec(const KVScan s, int which, long long bh,
                                      unsigned vi, const uint4 q) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  int n_nan = 0, n_inf = 0;
#pragma unroll
  for (int e = 0; e < 16 / ES; ++e) {
    uint32_t bits;
    if constexpr (ES == 4)
      bits = w[e];
    else
      bits = (w[e >> 1] >> ((e & 1) * 16)) & 0xFFFFu;
    const int cls = repro::classify(bits, which ? s.det_v : s.det_k);
    n_nan += cls & 1;
    n_inf += cls >> 1;
  }
  if (!(n_nan | n_inf)) return;
  const int r = (int)(vi / (unsigned)s.row_vecs);
  if (r < s.live_rows) {
    int* t = s.tiles + 4 * (bh * s.nk + r / s.bk) + 2 * which;
    if (n_nan) atomicAdd(t, n_nan);
    if (n_inf) atomicAdd(t + 1, n_inf);
  }
  s.flags[2 * (bh * s.nkv + r / TILE) + which] = 1;
}

template <int ES>
__device__ __forceinline__ bool suspect(const uint4& q, uint32_t exp_mask,
                                        uint32_t floor) {
  if constexpr (ES == 4) return may_be_fatal32(q, exp_mask, floor);
  return may_be_fatal(q, exp_mask, floor);
}

// One block per (b, kh, SCAN_THREADS * SCAN_VECS vectors): each thread has
// SCAN_VECS vectors of K and of V in flight, coalesced.
template <int ES, int TILE>
__global__ void __launch_bounds__(SCAN_THREADS) flash_scan(const KVScan s) {
  constexpr unsigned per_block = SCAN_THREADS * SCAN_VECS;
  const unsigned chunks = (s.vecs + per_block - 1) / per_block;
  const long long bh = blockIdx.x / chunks;
  const unsigned base = blockIdx.x % chunks * per_block + threadIdx.x;
  const uint4* k = s.k + bh * s.stride;
  const uint4* v = s.v + bh * s.stride;
  uint4 qk[SCAN_VECS], qv[SCAN_VECS];
#pragma unroll
  for (int i = 0; i < SCAN_VECS; ++i) {
    const unsigned vi = base + i * SCAN_THREADS;
    if (vi < s.vecs) {
      qk[i] = __ldg(k + vi);
      qv[i] = __ldg(v + vi);
    }
  }
#pragma unroll
  for (int i = 0; i < SCAN_VECS; ++i) {
    const unsigned vi = base + i * SCAN_THREADS;
    if (vi >= s.vecs) continue;
    if (suspect<ES>(qk[i], s.det_k.exp_mask, s.floor_k))
      scan_vec<ES, TILE>(s, 0, bh, vi, qk[i]);
    if (suspect<ES>(qv[i], s.det_v.exp_mask, s.floor_v))
      scan_vec<ES, TILE>(s, 1, bh, vi, qv[i]);
  }
}

// Rows of each (b, kh) that the scan reads: the live prefix, which it
// counts, and every row that some bq-row q tile of the main kernel loads,
// which it flags.
inline int scan_rows(int S, int T, int bk, int causal, int bq) {
  const long long loaded =
      causal ? std::min<long long>(T, (S + bq - 1LL) / bq * bq) : T;
  return (int)std::max<long long>(loaded,
                                  (long long)live_tiles(S, T, bk, causal) * bk);
}

bool scan_shape_ok(int dt, int B, int Kh, int S, int T, int D, int bk) {
  return dt >= repro::DT_F32 && dt <= repro::DT_F16 &&
         (D == 64 || D == 128) && B > 0 && Kh > 0 && S > 0 && T > 0 &&
         bk >= 1 && T % bk == 0 && (long long)B * Kh * T * D < (1ll << 31);
}

// flash_repair_f32's q and K/V tile rows (flash_repair_wgmma's are BKV)
constexpr int F32_TILE = 64;

cudaError_t launch_scan(const void* k, const void* v, int dt, int B, int Kh,
                        int S, int T, int D, int bk, int causal,
                        const int* det_k, const int* det_v, int* tiles,
                        int* flags, cudaStream_t stream) {
  if (!scan_shape_ok(dt, B, Kh, S, T, D, bk)) return cudaErrorInvalidValue;
  const bool f32 = dt == repro::DT_F32;
  const int tile = f32 ? F32_TILE : BKV, lanes = f32 ? 4 : 8;
  const int nkv = (T + tile - 1) / tile;
  cudaError_t err = cudaMemsetAsync(
      tiles, 0, sizeof(int) * 4 * (size_t)B * Kh * (T / bk), stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(flags, 0, sizeof(int) * 2 * (size_t)B * Kh * nkv,
                          stream);
  if (err != cudaSuccess) return err;
  const Detector dk = repro::detector_from(det_k),
                 dv = repro::detector_from(det_v);
  const KVScan s{static_cast<const uint4*>(k),
                 static_cast<const uint4*>(v),
                 (unsigned)(scan_rows(S, T, bk, causal, tile) * D / lanes),
                 (unsigned)(T * D / lanes),
                 D / lanes,
                 live_tiles(S, T, bk, causal) * bk,
                 bk,
                 T / bk,
                 nkv,
                 dk,
                 dv,
                 fatal_floor(dk),
                 fatal_floor(dv),
                 tiles,
                 flags};
  const unsigned per_block = SCAN_THREADS * SCAN_VECS;
  const unsigned blocks =
      (unsigned)B * Kh * ((s.vecs + per_block - 1) / per_block);
  if (f32)
    flash_scan<4, F32_TILE><<<blocks, SCAN_THREADS, 0, stream>>>(s);
  else
    flash_scan<2, BKV><<<blocks, SCAN_THREADS, 0, stream>>>(s);
  return cudaGetLastError();
}

template <int DT, int D>
cudaError_t launch_main(const void* q, const void* k, const void* v,
                        void* out, int B, int H, int Kh, int S, int T,
                        int causal, float sm_scale, const int* det_k,
                        const int* det_v, repro::Fill fill_k,
                        repro::Fill fill_v, int bk, const int* flags,
                        cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  if (!tensor_map_3d(&map_q, q, DT, B * H, S, D, BQ, 64) ||
      !tensor_map_3d(&map_k, k, DT, B * Kh, T, D, BKV, 64) ||
      !tensor_map_3d(&map_v, v, DT, B * Kh, T, D, BKV, 64))
    return cudaErrorInvalidValue;
  static bool smem_set = false;  // the attribute is set once per kernel
  if (!smem_set) {
    const cudaError_t err = repro::allow_smem(
        (const void*)flash_repair_wgmma<DT, D>, Tile<D>::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const unsigned blocks = (unsigned)B * H * ((S + BQ - 1) / BQ);
  flash_repair_wgmma<DT, D><<<blocks, THREADS, Tile<D>::SMEM_BYTES, stream>>>(
      map_q, map_k, map_v, static_cast<uint16_t*>(out), B * H, H, Kh, S, T,
      causal, (float)(sm_scale * LOG2E), repro::detector_from(det_k),
      repro::detector_from(det_v), fill_k, fill_v, bk, flags);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_main_d(int D, const void* q, const void* k, const void* v,
                          void* out, int B, int H, int Kh, int S, int T,
                          int causal, float sm_scale, const int* det_k,
                          const int* det_v, repro::Fill fill_k,
                          repro::Fill fill_v, int bk, const int* flags,
                          cudaStream_t s) {
  if (D == 64)
    return launch_main<DT, 64>(q, k, v, out, B, H, Kh, S, T, causal, sm_scale,
                               det_k, det_v, fill_k, fill_v, bk, flags, s);
  return launch_main<DT, 128>(q, k, v, out, B, H, Kh, S, T, causal, sm_scale,
                              det_k, det_v, fill_k, fill_v, bk, flags, s);
}

}  // namespace fw

// ------------------------------------------------------------ f32 route
namespace ff {

using namespace hopper;

// One block per (b, h, 64-row q tile), heavy causal tiles first; two
// groups of four warps split the q tile's 64-key K/V tiles between them
// (group g takes tiles g, g + 2, ...) and merge at the end.  Warp w of a
// group owns q rows 16 (w % 4) .. + 15 for the scores and the output.
constexpr int BQ = 64, BKV = 64, THREADS = 256, GROUP = 128;
static_assert(BQ == fw::F32_TILE && BKV == fw::F32_TILE,
              "the scan flags the tiles this kernel loads");
constexpr int PS = BKV + 4;  // a warp's P row stride (floats)
constexpr double LOG2E = 1.4426950408889634;

template <int D>
struct Lay {
  static constexpr int QS = D + 4;  // Q and K row stride (floats)
  static constexpr int Q_FLOATS = BQ * QS;
  static constexpr int K_FLOATS = BKV * QS;
  static constexpr int V_FLOATS = BKV * D;
  static constexpr int GROUP_FLOATS = K_FLOATS + V_FLOATS;  // a group's K, V
  static constexpr int P_FLOATS = 16 * PS;                  // a warp's P
  static constexpr int DC = D / 32;  // a lane's float4 output columns a row
  // what group 1 hands group 0 per lane: m and l of 4 rows, 4 x D / 8 O
  static constexpr int XCH = 8 + D / 2;
  static constexpr int SMEM_BYTES =
      4 * (Q_FLOATS + 2 * GROUP_FLOATS + 8 * P_FLOATS);
  static_assert(4 * XCH * 32 <= GROUP_FLOATS, "the hand-off fits a group");
};

__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "n"(GROUP) : "memory");
}

// Rows [r0, r0 + 64) of one head's (rows, D) f32 matrix into shared memory
// at row stride ST by cp.async, from `n` threads (this one is `t`); rows
// at or past `limit` land as zeros and read nothing.
template <int D, int ST>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0,
                                          int limit, int t, int n) {
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  for (int q = t; q < 64 * CPR; q += n) {
    const int r = q / CPR, c = q % CPR;
    const bool in = r0 + r < limit;
    cp_async16_zfill(smem_u32(dst + r * ST + 4 * c),
                     in ? src + (long long)(r0 + r) * D + 4 * c : src,
                     in ? 16 : 0);
  }
}

// A flagged K or V tile, by its group: every fatal lane of a row before T
// takes its logical (bk, D) tile's fill; row0 is the head's first row of
// the (B*Kh*T, D) view.  Rows at or past T are zeros and never touched.
template <int D, int ST>
__device__ __noinline__ void repair_tile(float* tile, int k0, int T,
                                         const Detector det,
                                         const repro::Fill fill,
                                         long long row0, int bk, int t) {
  constexpr int CPR = D / 4;
  const int rows = min(BKV, T - k0);
  for (int c = t; c < rows * CPR; c += GROUP) {
    const int r = c / CPR;
    repair_chunk32_with(tile + r * ST + 4 * (c % CPR), det, [&](int) {
      return fill.at((row0 + k0 + r) / bk);
    });
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_repair_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int BH, int H, int Kh, int S, int T, int causal,
                     float scale_log2, Detector det_k, Detector det_v,
                     repro::Fill fill_k, repro::Fill fill_v, int bk,
                     const int* __restrict__ flags) {
  using L = Lay<D>;
  constexpr int QS = L::QS;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp >> 2, wq = warp & 3, t = threadIdx.x & (GROUP - 1);
  float* q_s = smem;
  float* k_s = smem + L::Q_FLOATS + g * L::GROUP_FLOATS;
  float* v_s = k_s + L::K_FLOATS;
  float* p_s = smem + L::Q_FLOATS + 2 * L::GROUP_FLOATS + warp * L::P_FLOATS;

  const int nqt = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH, q0 = (nqt - 1 - blockIdx.x / BH) * BQ;
  const int kvh = bh / H * Kh + bh % H / (H / Kh);
  const float* kh = k + (long long)kvh * T * D;
  const float* vh = v + (long long)kvh * T * D;
  const int n_kv = ((causal ? min(T, q0 + BQ) : T) + BKV - 1) / BKV;
  const int* tile_flags = flags + 2ll * kvh * ((T + BKV - 1) / BKV);

  // Q once, by every thread; each group's first K tile
  load_rows<D, QS>(q_s, q + (long long)bh * S * D, q0, S, threadIdx.x, THREADS);
  if (g < n_kv) load_rows<D, QS>(k_s, kh, g * BKV, T, t, GROUP);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // scores: rows rl + 4 i of the q tile (rl = 16 wq + rg), keys kc + 8 j of
  // the K/V tile; output: the same rows, columns 4 kc + 32 c (+0..3).  Four
  // consecutive rows and eight consecutive keys a warp read distinct banks.
  const int rg = lane >> 3, kc = lane & 7, rl = 16 * wq + rg;
  float o[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) o[i][c] = 0.f;
  float m[4], l[4];  // running max (log2 domain) and this lane's share of l
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = repro::NEG_INF, l[i] = 0.f;
  const float* q_lane = q_s + rl * QS;
  float* p_row = p_s + rg * PS;  // the lane's P rows rg + 4 i

  for (int j = g; j < n_kv; j += 2) {
    const int k0 = j * BKV;
    const int fl_k = tile_flags[2 * j], fl_v = tile_flags[2 * j + 1];
    cp_async_wait<0>();  // K_j
    group_sync(g);       // K_j is whole; the group is done with V_{j-2}
    load_rows<D, D>(v_s, vh, k0, T, t, GROUP);
    cp_async_commit();
    if (fl_k) {
      repair_tile<D, QS>(k_s, k0, T, det_k, fill_k, (long long)kvh * T, bk, t);
      group_sync(g);
    }

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[i][jj] = 0.f;
    const float* k_lane = k_s + kc * QS;
#pragma unroll 2
    for (int d4 = 0; d4 < D / 4; ++d4) {
      float4 qa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(q_lane + 4 * i * QS + 4 * d4);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float4 kb =
            *reinterpret_cast<const float4*>(k_lane + 8 * jj * QS + 4 * d4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][jj] = fmaf(qa[i].x, kb.x, s[i][jj]);
          s[i][jj] = fmaf(qa[i].y, kb.y, s[i][jj]);
          s[i][jj] = fmaf(qa[i].z, kb.z, s[i][jj]);
          s[i][jj] = fmaf(qa[i].w, kb.w, s[i][jj]);
        }
      }
    }
    // the mask, on the diagonal tile and a tile that reaches past T only
    if (k0 + BKV > T || (causal && k0 + BKV - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int lim = causal ? min(T, q0 + rl + 4 * i + 1) : T;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          if (k0 + kc + 8 * jj >= lim) s[i][jj] = repro::NEG_INF;
      }
    }
    // online softmax in the log2 domain; the row max over the row's eight
    // lanes by shuffles, l kept per lane and summed at the end
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int jj = 1; jj < 8; ++jj) mx = fmaxf(mx, s[i][jj]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx * scale_log2);
      const float alpha = attn::ex2(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float p = attn::ex2(fmaf(s[i][jj], scale_log2, -m_new));
        p_row[4 * i * PS + kc + 8 * jj] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) o[i][c] *= alpha;
    }
    __syncwarp();

    cp_async_wait<0>();  // V_j
    group_sync(g);       // V_j is whole; the group is done with K_j
    if (j + 2 < n_kv) load_rows<D, QS>(k_s, kh, k0 + 2 * BKV, T, t, GROUP);
    cp_async_commit();
    if (fl_v) {
      repair_tile<D, D>(v_s, k0, T, det_v, fill_v, (long long)kvh * T, bk, t);
      group_sync(g);
    }
    // O += P V: per four keys, four float4 of P and D / 8 float4 of V
    const float* v_lane = v_s + 4 * kc;
#pragma unroll 2
    for (int t4 = 0; t4 < BKV / 4; ++t4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(p_row + 4 * i * PS + 4 * t4);
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        const float* vr = v_lane + (4 * t4 + tt) * D;
#pragma unroll
        for (int c = 0; c < L::DC; ++c) {
          const float4 vb = *reinterpret_cast<const float4*>(vr + 32 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = tt == 0 ? pa[i].x : tt == 1 ? pa[i].y
                          : tt == 2 ? pa[i].z : pa[i].w;
            o[i][4 * c] = fmaf(p, vb.x, o[i][4 * c]);
            o[i][4 * c + 1] = fmaf(p, vb.y, o[i][4 * c + 1]);
            o[i][4 * c + 2] = fmaf(p, vb.z, o[i][4 * c + 2]);
            o[i][4 * c + 3] = fmaf(p, vb.w, o[i][4 * c + 3]);
          }
        }
      }
    }
    __syncwarp();  // the warp is done with P before the next tile writes it
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
  }

  // group 1 hands (m, l, O) to group 0 through its own K/V region, lane
  // by lane; group 0 merges the two partitions and writes the rows
  float* xch = smem + L::Q_FLOATS + L::GROUP_FLOATS + wq * L::XCH * 32 + lane;
  if (g == 1) {
    group_sync(1);  // the group is done with its V tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xch[32 * i] = m[i];
      xch[32 * (4 + i)] = l[i];
#pragma unroll
      for (int c = 0; c < D / 8; ++c) xch[32 * (8 + i * (D / 8) + c)] = o[i][c];
    }
  }
  __syncthreads();
  if (g == 1) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float m1 = xch[32 * i], l1 = xch[32 * (4 + i)];
    const float mm = fmaxf(m[i], m1);
    const float a0 = attn::ex2(m[i] - mm), a1 = attn::ex2(m1 - mm);
    const float inv = 1.f / fmaxf(l[i] * a0 + l1 * a1, 1e-30f);
    const int r = q0 + rl + 4 * i;
    if (r >= S) continue;
    float* dst = out + ((long long)bh * S + r) * D + 4 * kc;
#pragma unroll
    for (int c = 0; c < L::DC; ++c) {
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = (o[i][4 * c + e] * a0 + xch[32 * (8 + i * (D / 8) + 4 * c + e)] * a1) * inv;
      *reinterpret_cast<float4*>(dst + 32 * c) = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Kh, int S, int T, int causal,
                   float sm_scale, const int* det_k, const int* det_v,
                   repro::Fill fill_k, repro::Fill fill_v, int bk,
                   const int* flags, cudaStream_t stream) {
  static bool smem_set = false;  // the attribute is set once per kernel
  if (!smem_set) {
    const cudaError_t err = repro::allow_smem(
        (const void*)flash_repair_f32<D>, Lay<D>::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const unsigned blocks = (unsigned)B * H * ((S + BQ - 1) / BQ);
  flash_repair_f32<D><<<blocks, THREADS, Lay<D>::SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), B * H, H, Kh, S,
      T, causal, (float)(sm_scale * LOG2E), repro::detector_from(det_k),
      repro::detector_from(det_v), fill_k, fill_v, bk, flags);
  return cudaGetLastError();
}

}  // namespace ff

}  // namespace

// q (B, H, S, D), k/v (B, Kh, T, D), out (B, H, S, D), all in `dtype`
// (0 f32, 1 bf16, 2 f16) and contiguous on the device; D is 64 or 128;
// (bq, bk) the logical blocks, which must divide (S, T); sm_scale
// 1/sqrt(D) rounded once from double; det_k/det_v host int32[8];
// fill_k/fill_v the repaired lanes' bit patterns, or with fills_k/fills_v
// (device uint32 per logical (bk, D) tile of the (B*Kh*T, D) view, from
// repro_tile_fill; null: none) the lane's tile's entry; tiles int32[4 * B *
// Kh * (T / bk)] scratch (zeroed here, on the stream); counts int32[8] out.
// Returns cudaGetLastError() after the launches.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int H, int Kh, int S, int T, int D, int bq, int bk, int causal,
    float sm_scale, const int* det_k, const int* det_v,
    unsigned int fill_k_bits, unsigned int fill_v_bits,
    const unsigned int* fills_k, const unsigned int* fills_v, int* tiles,
    int* counts, void* stream) {
  if (Kh < 1 || H % Kh || bq < 1 || bk < 1 || S % bq || T % bk || T < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const repro::Fill fill_k{fills_k, fill_k_bits}, fill_v{fills_v, fill_v_bits};
  switch (dtype) {
    case repro::DT_F32:
      return (int)launch_d<repro::DT_F32>(D, q, k, v, out, B, H, Kh, S, T, bq,
                                          bk, causal, sm_scale, det_k, det_v,
                                          fill_k, fill_v, tiles, counts, s);
    case repro::DT_BF16:
      return (int)launch_d<repro::DT_BF16>(D, q, k, v, out, B, H, Kh, S, T,
                                           bq, bk, causal, sm_scale, det_k,
                                           det_v, fill_k, fill_v, tiles,
                                           counts, s);
    case repro::DT_F16:
      return (int)launch_d<repro::DT_F16>(D, q, k, v, out, B, H, Kh, S, T, bq,
                                          bk, causal, sm_scale, det_k, det_v,
                                          fill_k, fill_v, tiles, counts, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The scan of either route alone: k/v (B, Kh, T, D) bf16 (dtype 1) or f16
// (2) for the wgmma route, f32 (0) for the f32 route, 16-byte aligned, D 64
// or 128, bk the logical K/V block (it must divide T).  Adds [NaN K, Inf K,
// NaN V, Inf V] lane counts of the logical live prefix into tiles
// (int32[4 * B * Kh * (T / bk)]) and sets flags (int32[2 * B * Kh *
// ceil(T / tile)], [K, V] per physical tile: 128 rows of flash_repair_wgmma,
// 64 of flash_repair_f32) for every tile that a q tile of the route's main
// kernel loads and that holds a fatal lane; both are zeroed first, on the
// stream.
extern "C" int repro_flash_scan(const void* k, const void* v, int dtype,
                                int B, int Kh, int S, int T, int D, int bk,
                                int causal, const int* det_k, const int* det_v,
                                int* tiles, int* flags, void* stream) {
  return (int)fw::launch_scan(k, v, dtype, B, Kh, S, T, D, bk, causal, det_k,
                              det_v, tiles, flags,
                              static_cast<cudaStream_t>(stream));
}

// The wgmma route: repro_flash_scan, flash_repair_wgmma and the counts.
// Arguments as in repro_flash_attention, with q, k, v and out all bf16 or
// all f16 and 16-byte aligned, and flags as for the scan.
extern "C" int repro_flash_attention_wgmma(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int H, int Kh, int S, int T, int D, int bq, int bk, int causal,
    float sm_scale, const int* det_k, const int* det_v,
    unsigned int fill_k_bits, unsigned int fill_v_bits,
    const unsigned int* fills_k, const unsigned int* fills_v, int* tiles,
    int* flags, int* counts, void* stream) {
  if (H < 1 || Kh < 1 || H % Kh || bq < 1 || S % bq ||
      (dtype != repro::DT_BF16 && dtype != repro::DT_F16) ||
      (long long)B * H * S * D >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const repro::Fill fill_k{fills_k, fill_k_bits}, fill_v{fills_v, fill_v_bits};
  cudaError_t err = fw::launch_scan(k, v, dtype, B, Kh, S, T, D, bk, causal,
                                    det_k, det_v, tiles, flags, s);
  if (err != cudaSuccess) return (int)err;
  err = dtype == repro::DT_BF16
            ? fw::launch_main_d<repro::DT_BF16>(D, q, k, v, out, B, H, Kh, S,
                                                T, causal, sm_scale, det_k,
                                                det_v, fill_k, fill_v, bk,
                                                flags, s)
            : fw::launch_main_d<repro::DT_F16>(D, q, k, v, out, B, H, Kh, S, T,
                                               causal, sm_scale, det_k, det_v,
                                               fill_k, fill_v, bk, flags, s);
  if (err != cudaSuccess) return (int)err;
  flash_counts<<<1, kThreads, 0, s>>>(tiles, B * Kh, T / bk,
                                      live_tiles(S, T, bk, causal), H / Kh,
                                      S / bq, bq, bk, causal, counts);
  return (int)cudaGetLastError();
}

// The f32 route: repro_flash_scan (dtype 0), flash_repair_f32 and the
// counts.  Arguments as in repro_flash_attention_wgmma, with q, k, v and
// out all f32 and 16-byte aligned.
extern "C" int repro_flash_attention_f32(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int H, int Kh, int S, int T, int D, int bq, int bk, int causal,
    float sm_scale, const int* det_k, const int* det_v,
    unsigned int fill_k_bits, unsigned int fill_v_bits,
    const unsigned int* fills_k, const unsigned int* fills_v, int* tiles,
    int* flags, int* counts, void* stream) {
  if (H < 1 || Kh < 1 || H % Kh || bq < 1 || S % bq ||
      dtype != repro::DT_F32 || (long long)B * H * S * D >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const repro::Fill fill_k{fills_k, fill_k_bits}, fill_v{fills_v, fill_v_bits};
  cudaError_t err = fw::launch_scan(k, v, dtype, B, Kh, S, T, D, bk, causal,
                                    det_k, det_v, tiles, flags, s);
  if (err != cudaSuccess) return (int)err;
  err = D == 64 ? ff::launch<64>(q, k, v, out, B, H, Kh, S, T, causal,
                                 sm_scale, det_k, det_v, fill_k, fill_v, bk,
                                 flags, s)
                : ff::launch<128>(q, k, v, out, B, H, Kh, S, T, causal,
                                  sm_scale, det_k, det_v, fill_k, fill_v, bk,
                                  flags, s);
  if (err != cudaSuccess) return (int)err;
  flash_counts<<<1, kThreads, 0, s>>>(tiles, B * Kh, T / bk,
                                      live_tiles(S, T, bk, causal), H / Kh,
                                      S / bq, bq, bk, causal, counts);
  return (int)cudaGetLastError();
}
