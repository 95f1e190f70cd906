// Chunked-q causal prefill against the paged pool, with fused on-read
// repair.
//
// Replaces src/repro/kernels/paged_attention.py::_paged_prefill_kernel
// (:362, behind `paged_prefill_raw`).  What every route computes: the
// chunk's q rows (B, C, H, Dh); chunk row c of request b sits at context
// position q_start[b] + c and reads the keys at positions <= that, key t
// living in slot t / pg of the block table; query head h reads KV head
// h / G (G = H / Kh); every fatal K/V lane takes the fill's bit pattern
// (precomputed by the host in the storage dtype, or for neighbor_mean the
// page's entry of the table that tile_fill.cu wrote over the layer: the
// reference's tile is the whole page, all KV heads); the online softmax masks
// with -1e30 (the reference's value, not -inf), and p is rounded to the
// storage dtype before the value product.  Counts: each (b, j) slot of the
// block table is one page visit, NULL-padded slots and slots past every
// row's causal limit included; slot_counts[b, j] is the visit's fatal-lane
// total, `counts` the AT int32[8] [nan_k, inf_k, ev_k, nan_v, inf_v, ev_v,
// ev_total, 0].  Two routes, chosen by the wrapper from dtypes, shapes and
// alignment alone (kernels/paged_attention.py::route):
//
// FFMA route (`prefill_partials`): f32/bf16/f16, any Dh and pg.  The chunk's
// rows are flattened to R = C * H rows in (C, Kh, G) order; a block takes
// kRows rows of one request and walks all M page slots of its block table,
// repairing each page it reads into its own shared memory (the same fill
// on every copy); only the request's first row block reports the page
// visit.  It emits unnormalised partials (acc (B, C, H, Dh), m and l
// (B, C*H), f32) that the wrapper normalises, as the reference does
// outside its kernel; FP32 dot products, no tensor cores.  Latency and every
// row block's re-read and re-repair of all the request's pages hold it.
//
// wgmma route (`prefill_scan`, `prefill_repair_wgmma`): q and both pools
// all bf16 or all f16, Dh 64 or 128, pg a multiple of 16 up to 128,
// 16-byte aligned.  What bounds it on an H100: bytes, q, the visited pages
// and out over 3.35 TB/s: 0.000157 ms at the engine's C = 64 (B = 1, H =
// 12, Kh = 2, Dh = 128, M = 8, pg = 16), where the products are ~0.1 GFLOP.
// In practice it is latency: two launches, a round trip to memory for the
// block table, one for the pages, a few dependent steps on one SM.  So
// the design does each step once, in parallel, and keeps every block short:
//   * `prefill_scan` reads K and V of every (b, j) slot once (16-byte
//     loads, the exponent-floor prefilter, `classify` only on suspect
//     vectors), writes slot_counts and one K and one V flag per slot, and
//     adds the seven AT counts (zeroed by the host's memset); one block per
//     slot.
//   * `prefill_repair_wgmma`: one block per (b, KV head, 64 of that head's
//     C * G rows in (C, G) order), so a block reads only its own head's
//     K/V, once, and one warpgroup's softmax has an SM's exp2 units to
//     itself (12 blocks at C = 64).  A slot is live for the block iff
//     j * pg <= q_start[b] + the block's last chunk row; dead slots are
//     not loaded (skipping is exact: a key masked for every row, with a
//     finite value, leaves m, l and acc as they were; below, the one
//     exception).  A producer warp reads the first tile's
//     block-table entries and flags before the block's barriers exist, and
//     loads each live page as one TMA box (pg rows of one KV head, over the
//     pool viewed as (P * L * pg, Kh, Dh): `layer` is a coordinate, so one
//     tensor map per pool serves every layer, cached on the host) into
//     tiles of whole pages, up to 128 keys, in a ring (2 stages at Dh =
//     128, 3 at 64): the engine's whole 128-key context is one tile, all
//     its loads issued at once.  The consumer warpgroup loads its q rows
//     itself into the same 128-byte swizzle meanwhile.  A flagged page is
//     repaired in shared memory after its load (loaded pages partly masked
//     included: 0 * NaN would poison P . V); unflagged pages go to wgmma
//     untouched.  The online softmax is flash_attention.cu's wgmma route's
//     (attention_wgmma.cuh), with each row's causal limit as selects and
//     P . V over the loaded keys only; the epilogue stages out = acc /
//     max(l, 1e-30) in q's dtype through shared memory and writes whole
//     rows in 16-byte stores.
//   The softmax runs per tile, not per page as the reference's does, so p
//   is rounded against another running max: outputs agree within the
//   16-bit tolerances, not bitwise.  In the reference a V lane that stays
//   non-finite after the repair (one the V detector lets through, or a
//   non-finite fill; with a table, the page's own fill, which an f32 sum
//   of large lanes can make Inf) reaches every row of its KV head through
//   0 * NaN, the rows that mask it too.  So the scan also marks such slots
//   (bit 1 of the V flag) and keeps, per request, the end of the last one
//   (`poison_end`); a block loads its slots up to the larger of its causal
//   limit and that end, and the routes agree on those rows as well.
#include <cmath>

#include "attention_wgmma.cuh"

namespace {

using repro::Detector;
using repro::NEG_INF;
using repro::Storage;

constexpr int kThreads = 256;
constexpr int kRows = 16;  // q rows per block

template <int DT>
__global__ void prefill_partials(
    const typename Storage<DT>::bits_t* q, const typename Storage<DT>::bits_t* kp,
    const typename Storage<DT>::bits_t* vp, const int* bt, const int* q_start,
    int C, int H, int Dh, int L, int pg, int Kh, int M, int layer,
    float sm_scale, Detector det_k, Detector det_v, repro::Fill fill_k,
    repro::Fill fill_v, float* acc_out, float* m_out, float* l_out,
    int* slot_counts, int* counts) {
  extern __shared__ float smem[];
  const int ks = Dh + 1;
  const int rows = pg * Kh;
  float* q_s = smem;                      // kRows x ks
  float* k_s = q_s + kRows * ks;          // rows x ks
  float* v_s = k_s + rows * ks;           // rows x Dh
  float* acc = v_s + rows * Dh;           // kRows x Dh
  float* p_s = acc + kRows * Dh;          // kRows x pg
  float* m_s = p_s + kRows * pg;          // kRows
  float* l_s = m_s + kRows;               // kRows
  float* a_s = l_s + kRows;               // kRows
  int* cnt = reinterpret_cast<int*>(a_s + kRows);

  const int b = blockIdx.x;
  const int R = C * H, G = H / Kh;
  const int r0 = blockIdx.y * kRows;
  const int nr = min(kRows, R - r0);
  const int tid = threadIdx.x;
  const bool reporter = blockIdx.y == 0;
  const int qs = q_start[b];
  for (int i = tid; i < kRows * Dh; i += blockDim.x) {
    const int r = i / Dh, d = i % Dh;
    q_s[r * ks + d] = r < nr ? Storage<DT>::to_float(
                                   q[((long long)b * R + r0 + r) * Dh + d])
                             : 0.f;
    acc[i] = 0.f;
  }
  for (int r = tid; r < kRows; r += blockDim.x) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  const long long tile = (long long)rows * Dh;
  for (int j = 0; j < M; ++j) {
    const long long page = bt[b * M + j];
    const long long base = (page * L + layer) * tile;
    if (tid < 4) cnt[tid] = 0;
    __syncthreads();
    repro::repair_tile<DT>(kp + base, rows, Dh, ks, det_k, fill_k, page, k_s,
                           &cnt[0]);
    repro::repair_tile<DT>(vp + base, rows, Dh, Dh, det_v, fill_v, page, v_s,
                           &cnt[2]);
    __syncthreads();
    if (reporter && tid == 0) {
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
    for (int i = tid; i < kRows * pg; i += blockDim.x) {
      const int r = i / pg, t = i % pg;
      const int h = (r0 + r) % H;
      const float* qr = q_s + r * ks;
      const float* kr = k_s + (t * Kh + h / G) * ks;
      float dot = 0.f;
      for (int d = 0; d < Dh; ++d) dot += qr[d] * kr[d];
      const int tq = qs + (r0 + r) / H;
      p_s[i] = (j * pg + t <= tq) ? dot * sm_scale : NEG_INF;
    }
    __syncthreads();
    for (int r = tid; r < kRows; r += blockDim.x) {
      float mx = m_s[r];
      for (int t = 0; t < pg; ++t) mx = fmaxf(mx, p_s[r * pg + t]);
      float sum = 0.f;
      for (int t = 0; t < pg; ++t) {
        const float sv = p_s[r * pg + t];
        const float p = sv > NEG_INF * 0.5f ? expf(sv - mx) : 0.f;
        sum += p;
        p_s[r * pg + t] = Storage<DT>::quantize(p);
      }
      const float alpha = expf(m_s[r] - mx);
      a_s[r] = alpha;
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = mx;
    }
    __syncthreads();
    for (int i = tid; i < kRows * Dh; i += blockDim.x) {
      const int r = i / Dh, d = i % Dh;
      const int h = (r0 + r) % H;
      const float* pr = p_s + r * pg;
      const float* vc = v_s + (h / G) * Dh + d;
      float pv = 0.f;
      for (int t = 0; t < pg; ++t) pv += pr[t] * vc[t * Kh * Dh];
      acc[i] = acc[i] * a_s[r] + pv;
    }
    __syncthreads();
  }
  for (int i = tid; i < nr * Dh; i += blockDim.x)
    acc_out[((long long)b * R + r0) * Dh + i] = acc[i];
  for (int r = tid; r < nr; r += blockDim.x) {
    m_out[(long long)b * R + r0 + r] = m_s[r];
    l_out[(long long)b * R + r0 + r] = l_s[r];
  }
}

template <int DT>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* bt, const int* q_start, int B, int C, int H,
                   int Dh, int L, int pg, int Kh, int M, int layer,
                   const int* det_k, const int* det_v, repro::Fill fill_k,
                   repro::Fill fill_v, float* acc, float* m, float* l,
                   int* slot_counts, int* counts, cudaStream_t stream) {
  using bits_t = typename Storage<DT>::bits_t;
  const int rows = pg * Kh;
  const size_t smem =
      sizeof(float) * ((size_t)kRows * (Dh + 1) + (size_t)rows * (Dh + 1) +
                       (size_t)rows * Dh + (size_t)kRows * Dh +
                       (size_t)kRows * pg + 3 * kRows) +
      4 * sizeof(int);
  cudaError_t err = repro::allow_smem((const void*)prefill_partials<DT>, smem);
  if (err != cudaSuccess) return err;
  const int R = C * H;
  const float sm_scale = 1.0f / sqrtf((float)Dh);
  prefill_partials<DT><<<dim3(B, (R + kRows - 1) / kRows), kThreads, smem,
                         stream>>>(
      static_cast<const bits_t*>(q), static_cast<const bits_t*>(kp),
      static_cast<const bits_t*>(vp), bt, q_start, C, H, Dh, L, pg, Kh, M,
      layer, sm_scale, repro::detector_from(det_k), repro::detector_from(det_v),
      fill_k, fill_v, acc, m, l, slot_counts, counts);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- wgmma route
namespace pw {

using namespace attn;
using attn::BKV;
using attn::BOX_BYTES;

// one consumer warpgroup of BQ rows, one producer warpgroup (a warp of it
// loads, the rest idle)
constexpr int BQ = 64, CONSUMERS = 128, THREADS = 256;
constexpr int MAX_PAGES = BKV / 16;  // pages of one K/V tile (pg >= 16)
constexpr double LOG2E = 1.4426950408889634;

template <int D>
struct Tile {
  static constexpr int BOXES = D / 64;  // 64-lane boxes per row
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr int OPERAND_BYTES = BOXES * BOX_BYTES;  // a Q, K or V tile
  static constexpr int STAGE_BYTES = 2 * OPERAND_BYTES;    // K, then V
  // Q, the ring, its 1024-byte alignment slack, the barriers (K full, V
  // full and empty per stage) and the stage flags
  static constexpr int SMEM_BYTES = 1024 + OPERAND_BYTES +
                                    STAGES * STAGE_BYTES + 3 * STAGES * 8 +
                                    STAGES * 4;
};

// What every block of one call shares.
struct Prefill {
  const uint16_t* q;    // (B, C, H, D)
  uint16_t* out;        // (B, C, H, D)
  const int* bt;        // (B, M)
  const int* q_start;   // (B,)
  const int* flags;     // (B, M, 2): [K, V] of each slot, from prefill_scan
  const int* poison_end;  // (B,): from prefill_scan
  int C, H, Kh, M, L, pg, layer;
  float scale_log2;
  Detector det_k, det_v;
  uint32_t floor_k, floor_v;  // fatal_floor of each detector
  repro::Fill fill_k, fill_v;  // a table is indexed by page id
};

// The consumers repair the flagged pages of a K or V tile (bit q of
// `pages`: the tile's page q, rows q * pg .. q * pg + pg - 1, page id
// ids[q]), every lane of them, 16-byte chunks that pass the exponent-floor
// prefilter in full; then the tile is handed to the async proxy.  The
// fill is the page's: a page is one logical tile.
template <int D>
__device__ __forceinline__ void repair_pages(uint8_t* tile, uint32_t pages,
                                             int pg, const Detector& det,
                                             uint32_t floor,
                                             const repro::Fill& f,
                                             const int* ids) {
  const int per_box = pg * 8;   // chunks of one page in one 64-lane box
  for (; pages; pages &= pages - 1) {
    const int q = __ffs(pages) - 1;
    const uint32_t fill = f.table ? f.at(ids[q]) : f.value;
    for (int c = threadIdx.x; c < Tile<D>::BOXES * per_box; c += CONSUMERS) {
      const int x = c / per_box, i = c - x * per_box;
      uint4* chunk = reinterpret_cast<uint4*>(tile + x * BOX_BYTES +
                                              q * pg * 128) + i;
      if (may_be_fatal(*chunk, det.exp_mask, floor))
        repair_chunk(chunk, 8, det, fill);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// One block per (b, KV head kh, BQ of that head's C * G rows in (C, G)
// order); the last row blocks, which see the most keys, first.
template <int DT, int D>
__global__ void __launch_bounds__(THREADS, 1)
    prefill_repair_wgmma(const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ Prefill p) {
  using T = Tile<D>;
  constexpr int ST = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the tiles to it
  uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = q_s + T::OPERAND_BYTES;
  uint64_t* k_full = reinterpret_cast<uint64_t*>(ring + ST * T::STAGE_BYTES);
  uint64_t* v_full = k_full + ST;
  uint64_t* empty = v_full + ST;
  // per stage: bits 0-7 its K pages that are flagged, bits 8-15 its V
  // pages (written by the producer before the stage's K barrier, which
  // publishes them)
  uint32_t* stage_flags = reinterpret_cast<uint32_t*>(empty + ST);

  const int G = p.H / p.Kh, CG = p.C * G;
  const int b = blockIdx.x, kh = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int qs = p.q_start[b];
  const int ppt = BKV / p.pg;   // whole pages per tile
  const int tile_keys = ppt * p.pg;
  // the producer warp's lanes each read one page's block-table entry and
  // flags, tile by tile; the first tile's reads go out before anything
  // waits on q_start
  const bool producer = threadIdx.x >= CONSUMERS && threadIdx.x < CONSUMERS + 32;
  const int lane = threadIdx.x & 31;
  int row = 0, fk = 0, fv = 0;
  auto fetch = [&](int j) {
    if (producer && lane < ppt && j + lane < p.M) {
      const long long slot = (long long)b * p.M + j + lane;
      row = (p.bt[slot] * p.L + p.layer) * p.pg;
      fk = p.flags[2 * slot];
      fv = p.flags[2 * slot + 1] & 1;
    }
  };
  fetch(0);
  // the loaded slots: those with j * pg <= q_start + the block's last chunk
  // row, and every slot up to the request's last one whose V stays
  // non-finite after the repair
  const int c_last = (min(r0 + BQ, CG) - 1) / G;
  const int key_end =
      min(p.M, max((qs + c_last) / p.pg + 1, p.poison_end[b])) * p.pg;
  const int n_kv = key_end > 0 ? (key_end + tile_keys - 1) / tile_keys : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(smem_u32(&k_full[s]), 1);
      mbar_init(smem_u32(&v_full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warp: lane 0 issues every TMA load
    if (producer) {
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % ST, j0 = it * ppt;
        const int np = min(ppt, key_end / p.pg - j0);
        const uint32_t kbits = __ballot_sync(0xffffffffu, lane < np && fk);
        const uint32_t vbits = __ballot_sync(0xffffffffu, lane < np && fv);
        int rows[MAX_PAGES];
#pragma unroll
        for (int q = 0; q < MAX_PAGES; ++q)
          rows[q] = __shfl_sync(0xffffffffu, row, q);
        fetch(j0 + ppt);   // the next tile's, in flight meanwhile
        if (lane == 0) {
          mbar_wait(smem_u32(&empty[s]), ((it / ST) & 1) ^ 1);
          stage_flags[s] = kbits | (vbits << 8);
          uint8_t* kt = ring + s * T::STAGE_BYTES;
          const uint32_t kb = smem_u32(&k_full[s]), vb = smem_u32(&v_full[s]);
          const uint32_t bytes = (uint32_t)np * p.pg * D * 2;
          mbar_expect_tx(kb, bytes);
#pragma unroll
          for (int q = 0; q < MAX_PAGES; ++q)
            if (q < np)
#pragma unroll
              for (int x = 0; x < T::BOXES; ++x)
                tma_load_3d(smem_u32(kt + x * BOX_BYTES + q * p.pg * 128),
                            &map_k, x * 64, kh, rows[q], kb);
          mbar_expect_tx(vb, bytes);
#pragma unroll
          for (int q = 0; q < MAX_PAGES; ++q)
            if (q < np)
#pragma unroll
              for (int x = 0; x < T::BOXES; ++x)
                tma_load_3d(smem_u32(kt + T::OPERAND_BYTES + x * BOX_BYTES +
                                     q * p.pg * 128),
                            &map_v, x * 64, kh, rows[q], vb);
        }
        __syncwarp();
      }
    }
  } else {
    // ---- the consumer warpgroup
    // q rows into the Q tile, in TMA's 128-byte swizzle: 16-byte chunk ch
    // of row r at box ch / 8, row r, column (ch % 8) ^ (r % 8); rows past
    // C * G are zeros
    constexpr int CH = D / 8;
    {
      constexpr int PER = BQ * CH / CONSUMERS;
      uint4 val[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = threadIdx.x + k * CONSUMERS, gr = r0 + i / CH;
        val[k] = make_uint4(0u, 0u, 0u, 0u);
        if (gr < CG) {
          const int c = gr / G, g = gr - c * G;
          val[k] = __ldg(reinterpret_cast<const uint4*>(
                             p.q + (((long long)b * p.C + c) * p.H + kh * G + g) *
                                       D) +
                         i % CH);
        }
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = threadIdx.x + k * CONSUMERS, r = i / CH, ch = i % CH;
        *reinterpret_cast<uint4*>(q_s + (ch >> 3) * BOX_BYTES + r * 128 +
                                  (((ch & 7) ^ (r & 7)) << 4)) = val[k];
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
    }
    const int warp = threadIdx.x >> 5;
    // the accumulator layout (attention_wgmma.cuh): rows row and row + 8,
    // columns from col
    const int row_lo = r0;
    const int row = row_lo + warp * 16 + (lane >> 2);
    const int col = 2 * (lane & 3);
    // keys at positions <= these are visible to the thread's two rows
    const int vis0 = qs + row / G, vis1 = qs + (row + 8) / G;
    const int vis_lo = qs + row_lo / G;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const uint32_t q_base = smem_u32(q_s);
    for (int it = 0; it < n_kv; ++it) {
      const int s = it % ST, k0 = it * tile_keys;
      const uint32_t parity = (it / ST) & 1;
      uint8_t* kt = ring + s * T::STAGE_BYTES;
      uint8_t* vt = kt + T::OPERAND_BYTES;
      // keys of this tile that were loaded: whole live pages
      const int kend = min(key_end - k0, tile_keys);
      mbar_wait(smem_u32(&k_full[s]), parity);
      const uint32_t fl = stage_flags[s];
      const int* ids = p.bt + (long long)b * p.M + it * ppt;
      if (fl & 0xFFu)
        repair_pages<D>(kt, fl & 0xFFu, p.pg, p.det_k, p.floor_k, p.fill_k,
                        ids);

      float sc[64];
      qk_tile<DT, D>(sc, q_base, smem_u32(kt));
      // masked: columns past the loaded keys (never-loaded rows hold stale
      // data) and keys past the row's position
      if (kend < BKV || k0 + BKV - 1 > vis_lo)
        mask_tile(sc, min(kend, vis0 + 1 - k0) - col,
                  min(kend, vis1 + 1 - k0) - col);
      uint32_t pa[32];
      softmax_tile<DT, D>(sc, m, l, o, p.scale_log2, pa);

      mbar_wait(smem_u32(&v_full[s]), parity);
      if (fl >> 8)
        repair_pages<D>(vt, fl >> 8, p.pg, p.det_v, p.floor_v, p.fill_v, ids);
      pv_tile<DT, D>(o, pa, smem_u32(vt), kend / 16);
      mbar_arrive(smem_u32(&empty[s]));
    }

    // out = acc / max(l, 1e-30) in q's dtype, through the Q tile (the same
    // swizzle: conflict-free) so that every row goes out in 16-byte stores
    uint8_t* o_s = q_s;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float inv = 1.f / fmaxf(quad_sum(l[i]), 1e-30f);
      const int rl = warp * 16 + (lane >> 2) + 8 * i;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(o_s + (j >> 3) * BOX_BYTES + rl * 128 +
                                     (((j & 7) ^ (rl & 7)) << 4) +
                                     4 * (lane & 3)) =
            pack2<DT>(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
    }
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
#pragma unroll
    for (int k = 0; k < BQ * CH / CONSUMERS; ++k) {
      const int i = threadIdx.x + k * CONSUMERS, rl = i / CH, ch = i % CH;
      const int gr = row_lo + rl;
      if (gr < CG) {
        const int c = gr / G, g = gr - c * G;
        *(reinterpret_cast<uint4*>(
              p.out + (((long long)b * p.C + c) * p.H + kh * G + g) * D) +
          ch) = *reinterpret_cast<const uint4*>(
            o_s + (ch >> 3) * BOX_BYTES + rl * 128 + (((ch & 7) ^ (rl & 7)) << 4));
      }
    }
  }
}

constexpr int SCAN_THREADS = 256, SCAN_VECS = 2;

// The scan's view of one call: every (b, j) slot's (pg, Kh, Dh) K and V
// tiles at `layer`, as `vecs` 16-byte vectors each.
struct PageScan {
  const uint4* k;
  const uint4* v;
  const int* bt;        // (B * M) page ids
  int M, L, layer;
  unsigned vecs;        // pg * Kh * Dh / 8
  Detector det_k, det_v;
  uint32_t floor_k, floor_v;  // fatal_floor of each detector
  uint32_t ieee_exp;    // the storage dtype's exponent field
  bool fill_v_finite;   // whether the V fill is a finite value
  const uint32_t* fills_v;  // neighbor_mean: the V fill per page, else null
  int* slot_counts;     // (B * M)
  int* flags;           // (B * M, 2)
  int* counts;          // int32[8], zeroed before the launch
  int* poison_end;      // (B,), zeroed before the launch
};

// NaN lanes | Inf lanes << 16 of a suspect vector (out of line: clean data
// never calls it).
__device__ __noinline__ int count_vec(const uint4 q, const Detector det) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  int n_nan = 0, n_inf = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int cls = repro::classify((w[e >> 1] >> ((e & 1) * 16)) & 0xFFFFu, det);
    n_nan += cls & 1;
    n_inf += cls >> 1;
  }
  return n_nan | (n_inf << 16);
}

// Whether a vector holds a non-finite lane that `det` does not repair
// (out of line, as count_vec).
__device__ __noinline__ bool keeps_nonfinite(const uint4 q, uint32_t ieee_exp,
                                             const Detector det) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  bool any = false;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t b = (w[e >> 1] >> ((e & 1) * 16)) & 0xFFFFu;
    any |= (b & ieee_exp) == ieee_exp && repro::classify(b, det) == 0;
  }
  return any;
}

// One block per (b, j) slot: its K and V tiles read once, SCAN_VECS
// vectors of each in flight per thread, coalesced.  Flags: K is 1 where
// the K tile holds a fatal lane; V bit 0 likewise, bit 1 where the V tile
// stays non-finite after the repair (poison_end[b] then covers the slot).
__global__ void __launch_bounds__(SCAN_THREADS) prefill_scan(const PageScan s) {
  __shared__ int cnt[5];
  if (threadIdx.x < 5) cnt[threadIdx.x] = 0;
  __syncthreads();
  const int slot = blockIdx.x;
  const long long base = ((long long)s.bt[slot] * s.L + s.layer) * s.vecs;
  const uint4* k = s.k + base;
  const uint4* v = s.v + base;
  int nk = 0, ik = 0, nv = 0, iv = 0, kept = 0;
  for (unsigned v0 = 0; v0 < s.vecs; v0 += SCAN_THREADS * SCAN_VECS) {
    uint4 qk[SCAN_VECS], qv[SCAN_VECS];
#pragma unroll
    for (int i = 0; i < SCAN_VECS; ++i) {
      const unsigned vi = v0 + threadIdx.x + i * SCAN_THREADS;
      if (vi < s.vecs) {
        qk[i] = __ldg(k + vi);
        qv[i] = __ldg(v + vi);
      }
    }
#pragma unroll
    for (int i = 0; i < SCAN_VECS; ++i) {
      if (v0 + threadIdx.x + i * SCAN_THREADS >= s.vecs) continue;
      if (may_be_fatal(qk[i], s.det_k.exp_mask, s.floor_k)) {
        const int c = count_vec(qk[i], s.det_k);
        nk += c & 0xFFFF;
        ik += c >> 16;
      }
      if (may_be_fatal(qv[i], s.det_v.exp_mask, s.floor_v)) {
        const int c = count_vec(qv[i], s.det_v);
        nv += c & 0xFFFF;
        iv += c >> 16;
      }
      if (may_be_fatal(qv[i], s.ieee_exp, s.ieee_exp))
        kept |= keeps_nonfinite(qv[i], s.ieee_exp, s.det_v);
    }
  }
  repro::block_add(&cnt[0], nk);
  repro::block_add(&cnt[1], ik);
  repro::block_add(&cnt[2], nv);
  repro::block_add(&cnt[3], iv);
  repro::block_add(&cnt[4], kept);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int fk = cnt[0] + cnt[1], fv = cnt[2] + cnt[3];
    // with a table the V fill, and whether it is finite, is the page's
    // (an f32 sum of large bf16 lanes can overflow to Inf)
    const bool fill_finite =
        s.fills_v ? (__ldg(s.fills_v + s.bt[slot]) & s.ieee_exp) != s.ieee_exp
                  : s.fill_v_finite;
    const bool poison = cnt[4] > 0 || (fv > 0 && !fill_finite);
    s.slot_counts[slot] = fk + fv;
    s.flags[2 * slot] = fk > 0;
    s.flags[2 * slot + 1] = (fv > 0) | (poison << 1);
    if (poison) atomicMax(&s.poison_end[slot / s.M], slot % s.M + 1);
    if (cnt[0]) atomicAdd(&s.counts[0], cnt[0]);
    if (cnt[1]) atomicAdd(&s.counts[1], cnt[1]);
    if (fk) atomicAdd(&s.counts[2], 1);
    if (cnt[2]) atomicAdd(&s.counts[3], cnt[2]);
    if (cnt[3]) atomicAdd(&s.counts[4], cnt[3]);
    if (fv) atomicAdd(&s.counts[5], 1);
    if (fk || fv) atomicAdd(&s.counts[6], 1);
  }
}

// Shapes both kernels take: 16-bit lanes, whole 16-lane key steps, lanes
// that fit an int.
bool shape_ok(int dt, int B, int M, long long P, int L, int pg, int Kh,
              int Dh) {
  return (dt == repro::DT_BF16 || dt == repro::DT_F16) &&
         (Dh == 64 || Dh == 128) && B > 0 && M > 0 && P > 0 && L > 0 &&
         Kh > 0 && pg >= 16 && pg <= BKV && pg % 16 == 0 &&
         P * L * pg * Kh * Dh < (1ll << 31);
}

// `counts` holds int32[8 + B]: the AT counts, then poison_end.
cudaError_t launch_scan(const void* kp, const void* vp, const int* bt, int dt,
                        int B, int M, int L, int pg, int Kh, int Dh, int layer,
                        const int* det_k, const int* det_v, unsigned fill_v,
                        const unsigned* fills_v, int* slot_counts, int* flags,
                        int* counts, cudaStream_t stream) {
  cudaError_t err =
      cudaMemsetAsync(counts, 0, (8 + (size_t)B) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const Detector dk = repro::detector_from(det_k),
                 dv = repro::detector_from(det_v);
  const uint32_t ieee_exp = dt == repro::DT_BF16 ? 0x7F80u : 0x7C00u;
  const PageScan s{static_cast<const uint4*>(kp),
                   static_cast<const uint4*>(vp),
                   bt,
                   M,
                   L,
                   layer,
                   (unsigned)(pg * Kh * Dh / 8),
                   dk,
                   dv,
                   fatal_floor(dk),
                   fatal_floor(dv),
                   ieee_exp,
                   (fill_v & ieee_exp) != ieee_exp,
                   fills_v,
                   slot_counts,
                   flags,
                   counts,
                   counts + 8};
  prefill_scan<<<(unsigned)B * M, SCAN_THREADS, 0, stream>>>(s);
  return cudaGetLastError();
}

// The TMA map of a pool (P, L, pg, Kh, Dh) viewed as (P * L * pg, Kh, Dh) in
// boxes of (pg, 1, 64), cached by pointer and shape (a pool is allocated
// once and read by every layer's call) and copied out: a later lookup may
// evict the entry.
bool pool_map(CUtensorMap* map, const void* pool, int dt, long long rows,
              int Kh, int Dh, int pg) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    long long rows;
    int dt, Kh, Dh, pg;
  };
  static Entry cache[8];
  static int next = 0;
  for (const Entry& e : cache)
    if (e.ptr == pool && e.rows == rows && e.dt == dt && e.Kh == Kh &&
        e.Dh == Dh && e.pg == pg) {
      *map = e.map;
      return true;
    }
  Entry& e = cache[next];
  next = (next + 1) % 8;
  const long long dims[3] = {Dh, Kh, rows};
  const int box[3] = {64, 1, pg};
  e.ptr = nullptr;
  if (!tensor_map_nd(&e.map, pool, dt, 3, dims, box)) return false;
  e.ptr = pool;
  e.rows = rows;
  e.dt = dt;
  e.Kh = Kh;
  e.Dh = Dh;
  e.pg = pg;
  *map = e.map;
  return true;
}

template <int DT, int D>
cudaError_t launch_main(const CUtensorMap& map_k, const CUtensorMap& map_v,
                        const Prefill& p, int B, cudaStream_t stream) {
  static bool smem_set = false;  // the attribute is set once per kernel
  if (!smem_set) {
    const cudaError_t err = repro::allow_smem(
        (const void*)prefill_repair_wgmma<DT, D>, Tile<D>::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int row_blocks = (p.C * (p.H / p.Kh) + BQ - 1) / BQ;
  prefill_repair_wgmma<DT, D>
      <<<dim3(B, p.Kh, row_blocks), THREADS, Tile<D>::SMEM_BYTES, stream>>>(
          map_k, map_v, p);
  return cudaGetLastError();
}

}  // namespace pw

}  // namespace

// q (B, C, H, Dh) and pages (P, L, pg, Kh, Dh) in `dtype` (0 f32, 1 bf16,
// 2 f16); bt (B, M), q_start (B,) int32 on the device; det_k/det_v host
// int32[8]; fill_k/fill_v the repaired lanes' bit patterns, or with
// fills_k/fills_v (device uint32 per page of the layer, from
// repro_tile_fill; null: none) the page's entry.  Outputs acc (B, C, H,
// Dh), m/l (B, C*H) f32, slot_counts (B, M) int32, counts int32[8] (zeroed
// by the caller).  Returns cudaGetLastError().
extern "C" int repro_paged_prefill(
    const void* q, const void* kp, const void* vp, const int* bt,
    const int* q_start, int dtype, int B, int C, int H, int Dh, int L, int pg,
    int Kh, int M, int layer, const int* det_k, const int* det_v,
    unsigned int fill_k_bits, unsigned int fill_v_bits,
    const unsigned int* fills_k, const unsigned int* fills_v, float* acc,
    float* m, float* l, int* slot_counts, int* counts, void* stream) {
  if (H % Kh != 0 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const repro::Fill fill_k{fills_k, fill_k_bits}, fill_v{fills_v, fill_v_bits};
  switch (dtype) {
    case repro::DT_F32:
      return (int)launch<repro::DT_F32>(q, kp, vp, bt, q_start, B, C, H, Dh, L,
                                        pg, Kh, M, layer, det_k, det_v, fill_k,
                                        fill_v, acc, m, l, slot_counts, counts,
                                        s);
    case repro::DT_BF16:
      return (int)launch<repro::DT_BF16>(q, kp, vp, bt, q_start, B, C, H, Dh,
                                         L, pg, Kh, M, layer, det_k, det_v,
                                         fill_k, fill_v, acc, m, l, slot_counts,
                                         counts, s);
    case repro::DT_F16:
      return (int)launch<repro::DT_F16>(q, kp, vp, bt, q_start, B, C, H, Dh, L,
                                        pg, Kh, M, layer, det_k, det_v, fill_k,
                                        fill_v, acc, m, l, slot_counts, counts,
                                        s);
  }
  return (int)cudaErrorInvalidValue;
}

// The wgmma route's scan alone: pages (P, L, pg, Kh, Dh) bf16 (dtype 1) or
// f16 (2), 16-byte aligned, Dh 64 or 128, pg a multiple of 16 up to 128;
// bt (B, M) int32 on the device; det_k/det_v host int32[8]; fill_v the
// repaired V lanes' bit pattern, or with fills_v (device uint32 per page of
// the layer; null: none) the page's entry.  Writes slot_counts (B, M), flags (B, M,
// 2) [K, V] (bit 0: the slot's tile holds a fatal lane; bit 1 of V: it
// stays non-finite after the repair) and counts int32[8 + B]: the AT
// counts, then per request the end of its last slot with V bit 1 (zeroed
// first, on the stream).
extern "C" int repro_paged_prefill_scan(
    const void* kp, const void* vp, const int* bt, int dtype, int B, int M,
    int P, int L, int pg, int Kh, int Dh, int layer, const int* det_k,
    const int* det_v, unsigned int fill_v, const unsigned int* fills_v,
    int* slot_counts, int* flags, int* counts, void* stream) {
  if (!pw::shape_ok(dtype, B, M, P, L, pg, Kh, Dh) || layer < 0 || layer >= L)
    return (int)cudaErrorInvalidValue;
  return (int)pw::launch_scan(kp, vp, bt, dtype, B, M, L, pg, Kh, Dh, layer,
                              det_k, det_v, fill_v, fills_v, slot_counts,
                              flags, counts, static_cast<cudaStream_t>(stream));
}

// The wgmma route: the scan, then prefill_repair_wgmma.  q (B, C, H, Dh)
// and the pages as for the scan, all in `dtype`; q_start (B,) int32;
// fill_k/fill_v and fills_k/fills_v as for repro_paged_prefill; out (B, C,
// H, Dh) in
// `dtype`; slot_counts, flags and counts (int32[8 + B]) as the scan's.
// Returns cudaGetLastError() after the launches.
extern "C" int repro_paged_prefill_wgmma(
    const void* q, const void* kp, const void* vp, const int* bt,
    const int* q_start, int dtype, int B, int C, int H, int Dh, int P, int L,
    int pg, int Kh, int M, int layer, const int* det_k, const int* det_v,
    unsigned int fill_k, unsigned int fill_v, const unsigned int* fills_k,
    const unsigned int* fills_v, void* out, int* slot_counts, int* flags,
    int* counts, void* stream) {
  if (!pw::shape_ok(dtype, B, M, P, L, pg, Kh, Dh) || layer < 0 ||
      layer >= L || C < 1 || H % Kh || (long long)B * C * H * Dh >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = pw::launch_scan(kp, vp, bt, dtype, B, M, L, pg, Kh, Dh,
                                    layer, det_k, det_v, fill_v, fills_v,
                                    slot_counts,
                                    flags, counts, s);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)P * L * pg;
  CUtensorMap mk, mv;
  if (!pw::pool_map(&mk, kp, dtype, rows, Kh, Dh, pg) ||
      !pw::pool_map(&mv, vp, dtype, rows, Kh, Dh, pg))
    return (int)cudaErrorInvalidValue;
  const pw::Prefill p{static_cast<const uint16_t*>(q),
                      static_cast<uint16_t*>(out),
                      bt,
                      q_start,
                      flags,
                      counts + 8,
                      C,
                      H,
                      Kh,
                      M,
                      L,
                      pg,
                      layer,
                      (float)(1.0 / std::sqrt((double)Dh) * pw::LOG2E),
                      repro::detector_from(det_k),
                      repro::detector_from(det_v),
                      hopper::fatal_floor(repro::detector_from(det_k)),
                      hopper::fatal_floor(repro::detector_from(det_v)),
                      {fills_k, fill_k},
                      {fills_v, fill_v}};
  if (dtype == repro::DT_BF16)
    err = Dh == 64 ? pw::launch_main<repro::DT_BF16, 64>(mk, mv, p, B, s)
                   : pw::launch_main<repro::DT_BF16, 128>(mk, mv, p, B, s);
  else
    err = Dh == 64 ? pw::launch_main<repro::DT_F16, 64>(mk, mv, p, B, s)
                   : pw::launch_main<repro::DT_F16, 128>(mk, mv, p, B, s);
  return (int)err;
}
