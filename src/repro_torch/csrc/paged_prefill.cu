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
// Both routes launch `page_scan` first (paged.cuh, one block a slot),
// which reads K and V of every (b, j) slot once (16-byte loads, the
// exponent-floor prefilter, `classify` only on suspect vectors), writes
// slot_counts and one K and one V flag per slot, and adds the seven AT
// counts and each request's poison_end (zeroed by a memset first).  A main
// kernel block then reads only its own KV head's rows of the slots it
// needs and takes no count.
//
// FFMA route (`page_scan` + `prefill_repair_ffma`): f32, and the 16-bit
// shapes the wgmma route does not take (pages not of whole 16-key steps,
// head dims other than 64 and 128, offset views), Dh up to 512, where one
// KV head's page fits a block's shared memory.  What bounds it on an H100:
// bytes, q, the visited pages and out over 3.35 TB/s: 0.000939 ms at
// StableLM-1.6B's f32 pool (B = 1, C = 64, H = Kh = 32, Dh = 64, M = 8, pg
// = 16), against ~0.05 GFLOP on the FP32 pipe (0.00075 ms).  In practice
// latency again, so the design is the wgmma route's on the FP32 pipe:
//   * one block per (b, KV head kh, 32 of that head's C * G rows in (C, G)
//     order): 64 blocks at that pool, 96 at StarCoder2-15B's (G = 12), at
//     C = 64 (64-row blocks would give 32 and 48);
//   * it loads only the live slots (j * pg <= q_start[b] + the block's last
//     chunk row, and up to the request's poison_end), only its KV head's
//     pg rows of each, a round of pages at once (every 16 bytes one
//     cp.async, all the block's threads issuing, all in flight together;
//     lane by lane for an offset view), and repairs only the flagged pages
//     in shared memory;
//   * scores: each thread a tile of 4 rows x 4 keys over float4 reads of q
//     (f32) and K, masked; then the online-softmax step page by page as the
//     reference's, eight lanes a row, p rounded to the storage dtype; then
//     P . V with each thread's (rows, 4 lanes) accumulators in registers
//     across pages and rounds, acc = acc * alpha + P . V;
//   * it writes the normalised output acc / max(l, 1e-30) in q's dtype, so
//     no pass over unnormalised partials follows.
// Every loaded key enters P . V, masked ones with p = 0.  f32 is exact f32:
// the plain version's arithmetic up to summation order.
//
// wgmma route (`page_scan`, `prefill_repair_wgmma`): q and both pools
// all bf16 or all f16, Dh 64 or 128, pg a multiple of 16 up to 128,
// 16-byte aligned.  What bounds it on an H100: bytes, q, the visited pages
// and out over 3.35 TB/s: 0.000157 ms at the engine's C = 64 (B = 1, H =
// 12, Kh = 2, Dh = 128, M = 8, pg = 16), where the products are ~0.1 GFLOP.
// In practice it is latency: two launches, a round trip to memory for the
// block table, one for the pages, a few dependent steps on one SM.  So
// the design does each step once, in parallel, and keeps every block short:
//   * `page_scan`, as above.
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
#include "paged.cuh"

namespace {

using repro::Detector;
using repro::NEG_INF;
using repro::Storage;

// ---------------------------------------------------------------- FFMA route
namespace pf {

using hopper::smem_u32;
using paged::cp_async16;
using paged::cp_async_wait_all;
using paged::load_lanes;
using paged::nan_max;
using paged::store4;

constexpr int R = 32;           // q rows a block: one KV head's, in (C, G) order
constexpr int THREADS = 256;
constexpr int MAX_ROUND = 32;   // pages a round
static_assert(THREADS == 8 * R, "the softmax step takes eight lanes a row");

// What every block of one call shares.
struct Ffma {
  const uint8_t* q;     // (B, C, H, Dh)
  const uint8_t* kp;    // (P, L, pg, Kh, Dh)
  const uint8_t* vp;
  uint8_t* out;         // (B, C, H, Dh)
  const int* bt;        // (B, M)
  const int* q_start;   // (B,)
  const int* flags;     // (B, M, 2): [K, V] of each slot, from page_scan
  const int* poison_end;  // (B,): from page_scan
  int C, H, Kh, Dh, M, L, pg, layer;
  int round;            // pages a round (kernels/paged_attention.py::ffma_round)
  float scale;
  Detector det_k, det_v;
  repro::Fill fill_k, fill_v;  // a table is indexed by page id
  bool vec;    // pools 16-byte aligned and a row a multiple of 16 bytes
  bool vec_q;  // q's and out's rows in whole, aligned 4-lane groups
};

// Byte offsets into a block's dynamic shared memory
// (kernels/paged_attention.py::ffma_smem): the block's R q rows as f32 (R,
// dpad), dpad = Dh rounded up to 4 lanes, zeros past Dh; per page of the
// round its id and K and V flags (4 ints); the softmax
// rescale of each (page, row); each row's final l; the round's scores and
// softmax weights (R, ls); then the round's K rows (ldk bytes apart: a row
// padded by 16 bytes, so that the lanes of a warp, each on its own key,
// read distinct banks) and V rows (ldv bytes apart), in the storage dtype.
struct Layout {
  int dpad, ls, ldk, ldv;
  long long q, ids, alpha, l, s, k, v, total;
  __host__ __device__ Layout(int Dh, int pg, int es, int round) {
    dpad = (Dh + 3) & ~3;
    ldv = (dpad * es + 15) & ~15;
    ldk = ldv + 16;
    ls = round * pg + 4;
    q = 0;
    ids = q + 4ll * R * dpad;
    alpha = ids + 16ll * round;
    l = alpha + 4ll * R * round;
    s = l + 4ll * R;
    k = s + 4ll * R * ls;
    v = k + (long long)round * pg * ldk;
    total = v + (long long)round * pg * ldv;
  }
};

// Repairs the fatal lanes of one page's pg rows of Dh lanes (`ld` bytes
// apart) in shared memory: each lane classified, a fatal one set to `fill`.
template <int DT>
__device__ __forceinline__ void repair_page(uint8_t* rows, int pg, int Dh,
                                            int ld, const Detector& det,
                                            uint32_t fill) {
  using bits_t = typename Storage<DT>::bits_t;
  for (int e = threadIdx.x; e < pg * Dh; e += THREADS) {
    const int t = e / Dh;
    bits_t* x = reinterpret_cast<bits_t*>(rows + t * ld) + (e - t * Dh);
    if (repro::classify(*x, det)) *x = (bits_t)fill;
  }
}

// One block per (request b, KV head kh, R of that head's C * G rows in (C,
// G) order); the last row blocks, which see the most keys, first.  DP: the
// largest dpad the instance takes (64, 128, 256 or 512), which sizes each
// thread's accumulator tile.
template <int DT, int DP>
__global__ void __launch_bounds__(THREADS)
    prefill_repair_ffma(const __grid_constant__ Ffma p) {
  using bits_t = typename Storage<DT>::bits_t;
  constexpr int ES = sizeof(bits_t);
  // P . V: thread (ry, cx) owns lanes 4 cx .. 4 cx + 3 of rows ry + RG i
  constexpr int CX = DP / 4, RG = THREADS / CX, TR = R / RG;
  extern __shared__ __align__(128) uint8_t smem[];
  const int pg = p.pg, Dh = p.Dh;
  const Layout lay(Dh, pg, ES, p.round);
  const int dpad = lay.dpad, n4 = dpad / 4, ls = lay.ls;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.H / p.Kh, CG = p.C * G;
  const int b = blockIdx.x, kh = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * R;
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  int* ids = reinterpret_cast<int*>(smem + lay.ids);
  float* alpha_s = reinterpret_cast<float*>(smem + lay.alpha);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);
  uint8_t* k_s = smem + lay.k;
  uint8_t* v_s = smem + lay.v;

  // the loaded slots: those with j * pg <= q_start + the block's last chunk
  // row, and every slot up to the request's last one whose V stays
  // non-finite after the repair (0 * NaN reaches the rows that mask it)
  const int qs = p.q_start[b];
  const int c_last = (min(r0 + R, CG) - 1) / G;
  const int n_live = min(p.M, max((qs + c_last) / pg + 1, p.poison_end[b]));
  const long long page_bytes = (long long)pg * p.Kh * Dh * ES;

  // each softmax row (8 lanes a row): its running max and sum
  const int srow = tid >> 3, l8 = tid & 7;
  float m_row = NEG_INF, l_row = 0.f;
  float acc[TR][4];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const int cx = tid % CX, ry = tid / CX;
  // the q rows as f32, zeros past C * G and past Dh (in the first
  // round, while its K and V copies are in flight)
  auto load_q = [&]() {
    for (int i = tid; i < R * n4; i += THREADS) {
      const int r = i / n4, c4 = i - r * n4, gr = r0 + r;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (gr < CG) {
        const int c = gr / G, g = gr - c * G;
        const long long at =
            (((long long)b * p.C + c) * p.H + kh * G + g) * Dh + 4 * c4;
        if (p.vec_q) {
          load_lanes<DT, 4>(p.q + at * ES, f);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * c4 + e < Dh)
              f[e] = Storage<DT>::to_float(reinterpret_cast<const bits_t*>(p.q)[at + e]);
        }
      }
      *reinterpret_cast<float4*>(q_s + r * dpad + 4 * c4) =
          make_float4(f[0], f[1], f[2], f[3]);
    }
  };

  for (int j0 = 0; j0 < n_live; j0 += p.round) {
    const int n = min(p.round, n_live - j0), nk = n * pg;
    // ---- the round's page ids and flags, then its rows of KV head kh
    if (tid < n) {
      const long long slot = (long long)b * p.M + j0 + tid;
      ids[4 * tid] = p.bt[slot];
      ids[4 * tid + 1] = p.flags[2 * slot] & 1;
      ids[4 * tid + 2] = p.flags[2 * slot + 1] & 1;
    }
    __syncthreads();
    if (p.vec) {
      // every 16-byte chunk of every row by cp.async, all in flight at once
      const int cpr = Dh * ES / 16;   // chunks a row
      for (int e = tid; e < nk * cpr; e += THREADS) {
        const int c = e / cpr, x = e - c * cpr, i = c / pg;
        const long long off = ((long long)ids[4 * i] * p.L + p.layer) * page_bytes +
                              ((long long)(c - i * pg) * p.Kh + kh) * Dh * ES + 16 * x;
        cp_async16(smem_u32(k_s + (long long)c * lay.ldk + 16 * x), p.kp + off);
        cp_async16(smem_u32(v_s + (long long)c * lay.ldv + 16 * x), p.vp + off);
      }
      if (j0 == 0) load_q();
      cp_async_wait_all();
    } else {
      if (j0 == 0) load_q();
      // lane by lane (an offset pool view, or rows not of whole 16 bytes),
      // zeros past Dh
      for (long long e = tid; e < (long long)nk * dpad; e += THREADS) {
        const int c = (int)(e / dpad), d = (int)(e - (long long)c * dpad);
        const int i = c / pg;
        bits_t kb = 0, vb = 0;
        if (d < Dh) {
          const long long at = ((long long)ids[4 * i] * p.L + p.layer) * pg * p.Kh * Dh +
                               ((long long)(c - i * pg) * p.Kh + kh) * Dh + d;
          kb = reinterpret_cast<const bits_t*>(p.kp)[at];
          vb = reinterpret_cast<const bits_t*>(p.vp)[at];
        }
        reinterpret_cast<bits_t*>(k_s + (long long)c * lay.ldk)[d] = kb;
        reinterpret_cast<bits_t*>(v_s + (long long)c * lay.ldv)[d] = vb;
      }
    }
    __syncthreads();
    // ---- the flagged pages repaired in place (a page is one logical tile)
    for (int i = 0; i < n; ++i) {
      const int id = ids[4 * i];
      if (ids[4 * i + 1])
        repair_page<DT>(k_s + (long long)i * pg * lay.ldk, pg, Dh, lay.ldk, p.det_k,
                        p.fill_k.table ? p.fill_k.at(id) : p.fill_k.value);
      if (ids[4 * i + 2])
        repair_page<DT>(v_s + (long long)i * pg * lay.ldv, pg, Dh, lay.ldv, p.det_v,
                        p.fill_v.table ? p.fill_v.at(id) : p.fill_v.value);
    }
    __syncthreads();

    // ---- scores: warp w takes rows w + 8 i and lane x keys x + 32 j (i, j
    // < 4) of each 128 keys, a 4 x 4 tile of dot products a thread over
    // float4 reads of q (f32, the same for the whole warp) and K
    for (int kb = 0; kb < nk; kb += 128) {
      float dot[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dot[i][j] = 0.f;
      const uint8_t* kr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kr[j] = k_s + (long long)min(kb + lane + 32 * j, nk - 1) * lay.ldk;
#pragma unroll 2
      for (int c4 = 0; c4 < n4; ++c4) {
        float4 qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(q_s + (warp + 8 * i) * dpad + 4 * c4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float kf[4];
          load_lanes<DT, 4>(kr[j] + 4 * c4 * ES, kf);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dot[i][j] = fmaf(qv[i].x, kf[0], dot[i][j]);
            dot[i][j] = fmaf(qv[i].y, kf[1], dot[i][j]);
            dot[i][j] = fmaf(qv[i].z, kf[2], dot[i][j]);
            dot[i][j] = fmaf(qv[i].w, kf[3], dot[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kb + lane + 32 * j;
        if (key >= nk) continue;
        const int pi = key / pg;
        const int kpos = (j0 + pi) * pg + (key - pi * pg);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = warp + 8 * i;
          const int tq = qs + (r0 + r) / G;
          s_s[r * ls + key] = kpos <= tq ? dot[i][j] * p.scale : NEG_INF;
        }
      }
    }
    __syncthreads();

    // ---- the online-softmax step, page by page as the reference's: eight
    // lanes a row, p rounded to the storage dtype in place
    {
      float* sr = s_s + srow * ls;
      for (int i = 0; i < n; ++i) {
        float* sp = sr + i * pg;
        float mx = NEG_INF;
        for (int t = l8; t < pg; t += 8) mx = nan_max(mx, sp[t]);
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) mx = nan_max(mx, __shfl_xor_sync(~0u, mx, o));
        const float m_new = nan_max(m_row, mx);
        float sum = 0.f;
        for (int t = l8; t < pg; t += 8) {
          const float sv = sp[t];
          const float e = sv > NEG_INF * 0.5f ? expf(sv - m_new) : 0.f;
          sum += e;
          sp[t] = Storage<DT>::quantize(e);
        }
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(~0u, sum, o);
        const float alpha = expf(m_row - m_new);
        l_row = l_row * alpha + sum;
        m_row = m_new;
        if (l8 == 0) alpha_s[i * R + srow] = alpha;
      }
    }
    __syncthreads();

    // ---- P . V: acc = acc * alpha + P . V page by page, in registers;
    // every loaded key enters, masked ones with p = 0 (a V lane that stays
    // non-finite after the repair reaches its rows through 0 * NaN)
    if (cx < n4) {
      for (int i = 0; i < n; ++i) {
#pragma unroll
        for (int u = 0; u < TR; ++u) {
          const float a = alpha_s[i * R + ry + RG * u];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][e] *= a;
        }
        const uint8_t* vr = v_s + (long long)i * pg * lay.ldv + 4 * cx * ES;
        const float* pr = s_s + i * pg;
        int t = 0;
        if (pg % 4 == 0) {
          // four keys a step: each row's four weights in one float4 read
          for (; t < pg; t += 4) {
            float vf[4][4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              load_lanes<DT, 4>(vr + (long long)(t + k) * lay.ldv, vf[k]);
#pragma unroll
            for (int u = 0; u < TR; ++u) {
              const float4 w =
                  *reinterpret_cast<const float4*>(pr + (ry + RG * u) * ls + t);
              const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
              for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[u][e] = fmaf(ws[k], vf[k][e], acc[u][e]);
            }
          }
        }
        for (; t < pg; ++t) {
          float vf[4];
          load_lanes<DT, 4>(vr + (long long)t * lay.ldv, vf);
#pragma unroll
          for (int u = 0; u < TR; ++u) {
            const float w = pr[(ry + RG * u) * ls + t];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[u][e] = fmaf(w, vf[e], acc[u][e]);
          }
        }
      }
    }
    __syncthreads();   // the next round's copies overwrite what was read
  }

  // ---- out = acc / max(l, 1e-30) in q's dtype
  if (l8 == 0) l_s[srow] = l_row;
  __syncthreads();
  if (cx < n4) {
#pragma unroll
    for (int u = 0; u < TR; ++u) {
      const int r = ry + RG * u, gr = r0 + r;
      if (gr >= CG) continue;
      const int c = gr / G, g = gr - c * G;
      const float den = fmaxf(l_s[r], 1e-30f);
      const long long at =
          (((long long)b * p.C + c) * p.H + kh * G + g) * Dh + 4 * cx;
      const float4 o = make_float4(acc[u][0] / den, acc[u][1] / den,
                                   acc[u][2] / den, acc[u][3] / den);
      if (p.vec_q) {
        store4<DT>(p.out + at * ES, o);
      } else {
        const float f[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * cx + e < Dh)
            reinterpret_cast<bits_t*>(p.out)[at + e] = Storage<DT>::from_float(f[e]);
      }
    }
  }
}

template <int DT, int DP>
cudaError_t launch(const Ffma& p, int B, size_t smem, cudaStream_t stream) {
  static size_t smem_set = 48 * 1024;  // the attribute, raised as needed
  if (smem > smem_set) {
    const cudaError_t err =
        repro::allow_smem((const void*)prefill_repair_ffma<DT, DP>, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const int row_blocks = (p.C * (p.H / p.Kh) + R - 1) / R;
  prefill_repair_ffma<DT, DP>
      <<<dim3(B, p.Kh, row_blocks), THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_dt(const Ffma& p, int B, size_t smem, cudaStream_t stream) {
  const int dpad = (p.Dh + 3) & ~3;
  if (dpad <= 64) return launch<DT, 64>(p, B, smem, stream);
  if (dpad <= 128) return launch<DT, 128>(p, B, smem, stream);
  if (dpad <= 256) return launch<DT, 256>(p, B, smem, stream);
  return launch<DT, 512>(p, B, smem, stream);
}

}  // namespace pf

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
  const int* flags;     // (B, M, 2): [K, V] of each slot, from page_scan
  const int* poison_end;  // (B,): from page_scan
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

// Shapes the wgmma route takes: 16-bit lanes, whole 16-lane key steps,
// lanes that fit an int.
bool shape_ok(int dt, int B, int M, long long P, int L, int pg, int Kh,
              int Dh) {
  return (dt == repro::DT_BF16 || dt == repro::DT_F16) &&
         (Dh == 64 || Dh == 128) && B > 0 && M > 0 && P > 0 && L > 0 &&
         Kh > 0 && pg >= 16 && pg <= BKV && pg % 16 == 0 &&
         P * L * pg * Kh * Dh < (1ll << 31);
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

// The FFMA route: q (B, C, H, Dh) and pages (P, L, pg, Kh, Dh) in `dtype`
// (0 f32, 1 bf16, 2 f16), any views (each contiguous), Dh up to 512; bt
// (B, M), q_start (B,) int32 on the device; det_k/det_v host int32[8];
// fill_k/fill_v the repaired lanes' bit patterns, or with fills_k/fills_v
// (device uint32 per page of the layer, from repro_tile_fill; null: none)
// the page's entry; round the pages a round and smem the block's dynamic
// shared-memory bytes (kernels/paged_attention.py::ffma_round,
// ffma_smem).  Zeroes counts (int32[8 + B]: the AT counts, then
// poison_end) on the stream, launches page_scan (slot_counts (B, M), flags
// (B, M, 2)), then prefill_repair_ffma (out (B, C, H, Dh) in `dtype`).
// Returns the first error.
extern "C" int repro_paged_prefill(
    const void* q, const void* kp, const void* vp, const int* bt,
    const int* q_start, int dtype, int B, int C, int H, int Dh, int P, int L,
    int pg, int Kh, int M, int layer, int round, int smem, const int* det_k,
    const int* det_v, unsigned int fill_k, unsigned int fill_v,
    const unsigned int* fills_k, const unsigned int* fills_v, void* out,
    int* slot_counts, int* flags, int* counts, void* stream) {
  const int es = dtype == repro::DT_F32 ? 4 : 2;
  if (!paged::scan_shape_ok(dtype, B, M, P, L, pg, Kh, Dh, layer) || C < 1 ||
      H % Kh || Dh > 512 || round < 1 || round > pf::MAX_ROUND ||
      smem < pf::Layout(Dh, pg, es, round).total || B > 65535 || Kh > 65535 ||
      (C * (H / Kh) + pf::R - 1) / pf::R > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = paged::launch_scan(kp, vp, bt, dtype, B, M, L, pg, Kh, Dh,
                                       layer, det_k, det_v, fill_v, fills_v,
                                       slot_counts, flags, counts, s);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t vec = 4 * es;   // a 4-lane group's bytes
  const pf::Ffma p{static_cast<const uint8_t*>(q),
                   static_cast<const uint8_t*>(kp),
                   static_cast<const uint8_t*>(vp),
                   static_cast<uint8_t*>(out),
                   bt,
                   q_start,
                   flags,
                   counts + 8,
                   C,
                   H,
                   Kh,
                   Dh,
                   M,
                   L,
                   pg,
                   layer,
                   round,
                   (float)(1.0 / std::sqrt((double)Dh)),
                   repro::detector_from(det_k),
                   repro::detector_from(det_v),
                   {fills_k, fill_k},
                   {fills_v, fill_v},
                   (reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) % 16 == 0 &&
                       Dh * es % 16 == 0,
                   (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(out)) % vec == 0 &&
                       Dh % 4 == 0};
  switch (dtype) {
    case repro::DT_F32: return (int)pf::launch_dt<repro::DT_F32>(p, B, smem, s);
    case repro::DT_BF16: return (int)pf::launch_dt<repro::DT_BF16>(p, B, smem, s);
    default: return (int)pf::launch_dt<repro::DT_F16>(p, B, smem, s);
  }
}

// page_scan alone (paged.cuh), the twin of
// kernels/paged_attention.py::prefill_scan_plain: pages (P, L, pg, Kh, Dh)
// in `dtype` (0 f32, 1 bf16, 2 f16), any view; bt (B, M) int32 on the
// device; det_k/det_v host int32[8]; fill_v the repaired V lanes' bit
// pattern, or with fills_v (device uint32 per page of the layer; null:
// none) the page's entry.  Writes slot_counts (B, M), flags (B, M, 2) [K,
// V] (bit 0: the slot's tile holds a fatal lane; bit 1 of V: it stays
// non-finite after the repair) and counts int32[8 + B]: the AT counts,
// then per request the end of its last slot with V bit 1 (zeroed first, on
// the stream).
extern "C" int repro_paged_prefill_scan(
    const void* kp, const void* vp, const int* bt, int dtype, int B, int M,
    int P, int L, int pg, int Kh, int Dh, int layer, const int* det_k,
    const int* det_v, unsigned int fill_v, const unsigned int* fills_v,
    int* slot_counts, int* flags, int* counts, void* stream) {
  if (!paged::scan_shape_ok(dtype, B, M, P, L, pg, Kh, Dh, layer))
    return (int)cudaErrorInvalidValue;
  return (int)paged::launch_scan(kp, vp, bt, dtype, B, M, L, pg, Kh, Dh, layer,
                                 det_k, det_v, fill_v, fills_v, slot_counts,
                                 flags, counts, static_cast<cudaStream_t>(stream));
}

// The wgmma route: page_scan, then prefill_repair_wgmma.  q (B, C, H, Dh)
// and the pages bf16 (dtype 1) or f16 (2), 16-byte aligned, Dh 64 or 128,
// pg a multiple of 16 up to 128; the rest as for repro_paged_prefill; out
// (B, C, H, Dh) in `dtype`; slot_counts, flags and counts (int32[8 + B])
// as the scan's.
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
  cudaError_t err = paged::launch_scan(kp, vp, bt, dtype, B, M, L, pg, Kh, Dh,
                                       layer, det_k, det_v, fill_v, fills_v,
                                       slot_counts, flags, counts, s);
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
