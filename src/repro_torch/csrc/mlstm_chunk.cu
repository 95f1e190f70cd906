// Chunked mLSTM with stabilized exponential gating and on-load repair of
// the q/k/v tiles (the math is on repro_torch/kernels/mlstm_chunk.py).
//
// Replaces src/repro/kernels/mlstm_chunk.py::_mlstm_kernel (:46, behind
// `mlstm_chunk_raw`).  The TPU kernel walks the grid (B, H, nc) in order
// and keeps the state C (P x P f32), n and m in VMEM across the chunk
// axis.  At P = 1024, C is 4 MiB; one H100 block has at most 227 KB of
// shared memory, so C cannot live in one block.  The design splits it:
//
//   pass 1  mlstm_qk     grid (B*H*nc): one block per logical (b, h, c)
//                        tile.  Repairs q and k while streaming them along
//                        P and writes S = q k^T (Q x Q, f32) to a scratch
//                        buffer; classifies every q, k and v lane and adds
//                        the tile's seven counts with one atomic each, so
//                        the counts are the reference's exactly.
//   pass 2  mlstm_scan   grid (B*H, ceil(P / 32)): each block owns the
//                        (P x 32) slab of C for 32 value columns, in
//                        shared memory (128 KB at P = 1024), and walks
//                        the chunks in order.  The value columns of num,
//                        y and C are independent, so the slabs never talk.
//                        What does not depend on the slab (the gate scan,
//                        m*, den, n) every block computes itself: it is
//                        O(Q) or O(Q P) per chunk against the slab's
//                        O(Q P 32).  q and k are streamed along P in
//                        (Q x 32) tiles (the L2 serves the 32 slabs of a
//                        head); each tile is first read against the old
//                        C rows (q C, q n) and then used to update them
//                        (C, n <- resc (C, n) + (src k)^T (v, 1)).
//
// Products take f32 operands after the repair and accumulate in f32 on the
// FP32 pipe: no tensor cores, so no TF32.  Detection is on the storage
// bits before the cast (16-bit views zero-extended, repair.cuh); a fatal
// lane takes the fill's bit pattern, or for neighbor_mean its operand's
// entry for the (b, h, c) tile in the table that tile_fill.cu wrote (q, k
// and v each have their own).  Every block repairs what it reads; only
// pass 1 counts.
//
// What bounds it on an H100: operations.  Per chunk and head the function
// needs 2 Q^2 P + 4 Q P^2 flops (the causal halves of q k^T and W v, then
// q C and the C update) against 3 Q P inputs; at Q = 128, P = 1024 that
// is ~725 flops per input byte in bf16, far above the card's ~295.
//
// Two routes, chosen by the wrapper from dtypes, shapes and alignment alone
// (kernels/mlstm_chunk.py::route).  The FFMA route (`mlstm_qk`, then
// `mlstm_scan`, above) takes f32, f16 and every shape the wgmma route does
// not: it runs on the FP32 pipe (67 TFLOP/s), so exact f32 stays exact.
//
// wgmma route (`mlstm_prep_wgmma`, then `mlstm_scan_wgmma`, namespace wg):
// bf16 q, k, v, contiguous and 16-byte aligned, P a multiple of 8 up to
// 1024, Q a multiple of 16 up to 128.  The state C stays f32 in the block
// for the whole call, as wgmma accumulators; it reaches the tensor cores as
// a bf16 hi/lo pair (hi = bf16(x), lo = bf16(x - hi), ~16 bits of x), two
// products summed in f32, never TF32.
//   pass 1  mlstm_prep_wgmma, two kinds of block in one grid:
//     * one per logical (b, h, c) tile: TMA brings q and k in (128 x 64)
//       boxes (128-byte swizzle) through a 4-stage ring; every lane of q,
//       k and v is classified once behind the exponent-floor prefilter,
//       counted on the logical tile as the reference counts it, fatal q/k
//       lanes repaired in shared memory, and each (tile, 64-column box)
//       of q, k and v flagged if it holds a fatal lane.  S = q k^T by
//       wgmma m64n128k16.  The gate chain m_{c-1} is walked over chunks
//       0..c by one warp (each lane a chunk, its cumsum in order), so
//       the tile writes W = tril(S src) as three bf16 terms (hi, mid,
//       lo: exact for f32) in wgmma A-fragment order, den's intra-chunk
//       sum in f32, src, the clamp and resc.  Row t is scaled by the
//       power of two s_t that brings its terms (all <= exp(m_t - m*),
//       m_t = max(m_prev, b_0..b_t)) back to ~1: with the xLSTM's forget
//       gates (log f ~ -0.7 a step) a chunk's first rows fall into f32's
//       subnormal range, below any bf16 term.  y = num / max(|den|,
//       clamp) is the same for all three scaled alike, and W as the
//       plain version rounds it, times a power of two, is exact.
//     * one per (b, h, 64-column slice of P): walks the chunks in order
//       and keeps its slice of n in f32 on the FP32 pipe, writing each
//       chunk's partial q . n_{c-1}.  den never needs the slabs of C, so
//       it is formed once per (b, h, c), not in each of them.
//   pass 2  mlstm_scan_wgmma, grid (B*H, ceil(P / 32)): each block owns
//     the (P x 32) slab of C for 32 value columns as f32 accumulators of
//     m64n16k16 (each of two warpgroups 16 of the columns, 128 registers
//     a thread), plus its hi/lo copy in shared memory (P rows of [hi 32 |
//     lo 32] bf16, the B operand of q C).  Per chunk: the value slab is
//     repaired if flagged and goes to shared memory as v^T and as the
//     hi/lo pair of src * v (moving src from k onto v leaves the sum
//     unchanged, so only this small operand is split); W v by wgmma
//     m64n32k16 with W's terms as register A fragments; then, box by box
//     of P as TMA brings q and k (2-stage ring, flagged boxes repaired in
//     shared memory): q [C_hi | C_lo] by m64n64k16 and C <- resc C +
//     k^T [U_hi + U_lo] by m64n16k16 (k^T MN-major); then y = (W v + s_t
//     resc q C) / max(|den|, clamp) in f32 and C's new hi/lo copy.  A
//     2-stage ring is what the copy of C leaves room for; the box loop
//     waits on its loads from L2 (PERF.md, section 6).
//   A non-finite v lane (an Inf the detector lets through) would meet the
//   split terms of W: hi * Inf + mid * Inf is NaN where mid's sign differs,
//   and 0 * Inf where W is exact in bf16.  So the tensor cores see such a
//   lane as 0, and its terms W_tj v_jn are added in f32 afterwards, with W
//   rebuilt exactly from its three terms: NaN and Inf land where the plain
//   version's do.
#include "attention_wgmma.cuh"

namespace {

using repro::Detector;
using repro::Storage;

constexpr int kThreads = 256;
constexpr int QMAX = 128;   // longest chunk
constexpr int TP = 32;      // columns of a streamed q/k tile
constexpr int LD = TP + 1;  // padded row stride of the q/k/W tiles
constexpr int BV = 32;      // value columns per block (C slab width)
constexpr float NEG = -1e30f;

// jnp.maximum / torch.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

constexpr int PER = QMAX * TP / kThreads;  // tile lanes per thread

// One (QMAX x TP) tile of a row-major (Q, P) operand, columns [p0, p0 +
// TP), held as raw storage bits in registers: lane r of a thread is row
// tid / TP + r * (kThreads / TP), column tid % TP, so a warp reads one
// row's TP consecutive values.  `fetch` issues all of a thread's loads
// before any is used (one memory latency per tile, and the next tile's
// loads overlap the current tile's products); `store` repairs, widens to
// f32 (times row_scale[t] when given) and writes dst[t * ld + column].
// Lanes outside (Q, P) are 0 and never counted.
template <int DT>
struct Tile {
  uint32_t b[PER];

  __device__ __forceinline__ void fetch(
      const typename Storage<DT>::bits_t* __restrict__ src, int Q, int P,
      int p0) {
    const int p = p0 + threadIdx.x % TP, t0 = threadIdx.x / TP;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int t = t0 + r * (kThreads / TP);
      b[r] = (t < Q && p < P) ? (uint32_t)src[(long long)t * P + p] : 0u;
    }
  }

  __device__ __forceinline__ void store(int Q, int P, int p0,
                                        const Detector& det,
                                        const repro::Fill& fill,
                                        long long tile,
                                        const float* row_scale, float* dst,
                                        int ld, int& n_nan,
                                        int& n_inf) const {
    const int c = threadIdx.x % TP, t0 = threadIdx.x / TP;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int t = t0 + r * (kThreads / TP);
      float val = 0.f;
      if (t < Q && p0 + c < P) {
        uint32_t bits = b[r];
        const int cls = repro::classify(bits, det);
        n_nan += cls & 1;
        n_inf += cls >> 1;
        if (cls) bits = fill.at(tile);
        val = Storage<DT>::to_float(bits);
        if (row_scale) val *= row_scale[t];
      }
      dst[t * ld + c] = val;
    }
  }

  // Counts only (the v tiles of pass 1).
  __device__ __forceinline__ void count(int Q, int P, int p0,
                                        const Detector& det, int& n_nan,
                                        int& n_inf) const {
    const int c = threadIdx.x % TP, t0 = threadIdx.x / TP;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int t = t0 + r * (kThreads / TP);
      if (t < Q && p0 + c < P) {
        const int cls = repro::classify(b[r], det);
        n_nan += cls & 1;
        n_inf += cls >> 1;
      }
    }
  }
};

// Pass 1: S = repair(q) repair(k)^T per (b, h, c) tile, and the counts.
// Thread micro-tile 8 x 8: rows ty*4 + {0..3, 64..67}, columns likewise.
template <int DT>
__global__ void __launch_bounds__(kThreads)
    mlstm_qk(const typename Storage<DT>::bits_t* __restrict__ q,
             const typename Storage<DT>::bits_t* __restrict__ k,
             const typename Storage<DT>::bits_t* __restrict__ v, int Q, int P,
             Detector det, repro::Fill fill_q, repro::Fill fill_k,
             float* __restrict__ S, int* __restrict__ counts) {
  __shared__ float qs[QMAX * LD];
  __shared__ float ks[QMAX * LD];
  __shared__ int cnt[6];  // nan/inf lanes of q, k, v
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  if (tid < 6) cnt[tid] = 0;
  __syncthreads();
  const long long tile = blockIdx.x;
  const long long off = tile * Q * P;
  int n[6] = {0, 0, 0, 0, 0, 0};
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  Tile<DT> tq, tk, tv;
  tq.fetch(q + off, Q, P, 0);
  tk.fetch(k + off, Q, P, 0);
  tv.fetch(v + off, Q, P, 0);
  for (int p0 = 0; p0 < P; p0 += TP) {
    tq.store(Q, P, p0, det, fill_q, tile, nullptr, qs, LD, n[0], n[1]);
    tk.store(Q, P, p0, det, fill_k, tile, nullptr, ks, LD, n[2], n[3]);
    tv.count(Q, P, p0, det, n[4], n[5]);  // v enters the counts only
    __syncthreads();
    if (p0 + TP < P) {
      tq.fetch(q + off, Q, P, p0 + TP);
      tk.fetch(k + off, Q, P, p0 + TP);
      tv.fetch(v + off, Q, P, p0 + TP);
    }
#pragma unroll 4
    for (int p = 0; p < TP; ++p) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        a[i] = qs[(ty * 4 + (i & 3) + (i >> 2) * 64) * LD + p];
        b[i] = ks[(tx * 4 + (i & 3) + (i >> 2) * 64) * LD + p];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < 6; ++s) repro::block_add(&cnt[s], n[s]);

  float* St = S + tile * Q * Q;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 4 + (i & 3) + (i >> 2) * 64;
    if (r >= Q) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx * 4 + (j & 3) + (j >> 2) * 64;
      if (c < Q) St[r * Q + c] = acc[i][j];
    }
  }
  __syncthreads();
  if (tid == 0) {
    const int ev_q = (cnt[0] + cnt[1]) > 0;
    const int ev_kv = (cnt[2] + cnt[3] + cnt[4] + cnt[5]) > 0;
    const int add[7] = {cnt[0], cnt[1], ev_q, cnt[2] + cnt[4], cnt[3] + cnt[5],
                        ev_kv, ev_q | ev_kv};
#pragma unroll
    for (int s = 0; s < 7; ++s)
      if (add[s]) atomicAdd(&counts[s], add[s]);
  }
}

// Pass 2: the chunk recurrence for value columns [v0, v0 + BV) of one
// (b, h).  Output micro-tile per thread: rows ty*4 + {0..3}, columns
// tx*4 + {0..3} (ty = tid / 8 covers Q <= 128 rows, tx the 32 columns).
template <int DT>
__global__ void __launch_bounds__(kThreads)
    mlstm_scan(const typename Storage<DT>::bits_t* __restrict__ q,
               const typename Storage<DT>::bits_t* __restrict__ k,
               const typename Storage<DT>::bits_t* __restrict__ v,
               const float* __restrict__ log_i,
               const float* __restrict__ log_f, const float* __restrict__ S,
               int nc, int Q, int P, Detector det, repro::Fill fill_q,
               repro::Fill fill_k, repro::Fill fill_v, float* __restrict__ y) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;               // P x BV: this block's slab of C
  float* vs = Cs + P * BV;        // QMAX x BV: the chunk's value columns
  float* ts = vs + QMAX * BV;     // QMAX x LD: a q tile, or a W tile
  float* ks = ts + QMAX * LD;     // QMAX x LD: a k tile times src
  float* ns = ks + QMAX * LD;     // P: n
  float* Fs = ns + P;             // QMAX: F = cumsum(log_f)
  float* bs = Fs + QMAX;          // QMAX: b = log_i - F
  float* src = bs + QMAX;         // QMAX: exp(b - m*)
  float* clampv = src + QMAX;     // QMAX: exp(-F - m*)
  float* den = clampv + QMAX;     // QMAX
  float* scal = den + QMAX;       // [max_j b_j, F_end]

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const long long bh = blockIdx.x;
  const int v0 = blockIdx.y * BV;
  for (int e = tid; e < P * BV; e += kThreads) Cs[e] = 0.f;
  for (int e = tid; e < P; e += kThreads) ns[e] = 0.f;
  float m_prev = NEG;
  int unused_nan = 0, unused_inf = 0;

  for (int c = 0; c < nc; ++c) {
    const long long chunk = bh * nc + c;
    const long long off = chunk * Q * P;

    // gates: F, b and their maximum (one thread, in order, like cumsum)
    if (tid < Q) {
      Fs[tid] = log_f[chunk * Q + tid];
      bs[tid] = log_i[chunk * Q + tid];
    }
    __syncthreads();
    if (tid == 0) {
      float F = 0.f, m_loc = __int_as_float(0xff800000);  // -inf
      for (int t = 0; t < Q; ++t) {
        F += Fs[t];
        Fs[t] = F;
        bs[t] -= F;
        m_loc = nan_max(m_loc, bs[t]);
      }
      scal[0] = m_loc;
      scal[1] = F;
    }
    __syncthreads();
    const float m_star = nan_max(m_prev, scal[0]);
    const float resc = expf(m_prev - m_star);
    for (int t = tid; t < Q; t += kThreads) {
      src[t] = expf(bs[t] - m_star);
      clampv[t] = expf(-Fs[t] - m_star);
    }
    // this block's value columns of the chunk, repaired
    {
      Tile<DT> tv;
      tv.fetch(v + off, Q, P, v0);
      tv.store(Q, P, v0, det, fill_v, chunk, nullptr, vs, BV, unused_nan,
               unused_inf);
    }
    __syncthreads();

    // intra-chunk: num = W v and den = sum_j W, W = tril(S * src) in tiles
    float num[4][4], num_c[4][4], d_w[4] = {0.f, 0.f, 0.f, 0.f},
                                  d_n[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) num[a][b] = num_c[a][b] = 0.f;
    const float* Sc = S + chunk * Q * Q;
    for (int j0 = 0; j0 < Q; j0 += TP) {
      {
        const int jj = tid % TP, j = j0 + jj, t0 = tid / TP;
        float w[PER];
#pragma unroll
        for (int r = 0; r < PER; ++r) {
          const int t = t0 + r * (kThreads / TP);
          w[r] = (t < Q && j <= t) ? Sc[t * Q + j] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < PER; ++r) {
          const int t = t0 + r * (kThreads / TP);
          ts[t * LD + jj] = (t < Q && j <= t) ? w[r] * src[j] : 0.f;
        }
      }
      __syncthreads();
      const int jn = min(TP, Q - j0);
      for (int jj = 0; jj < jn; ++jj) {
        float w[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) w[a] = ts[(ty * 4 + a) * LD + jj];
        const float4 vv =
            *reinterpret_cast<const float4*>(&vs[(j0 + jj) * BV + tx * 4]);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          num[a][0] = fmaf(w[a], vv.x, num[a][0]);
          num[a][1] = fmaf(w[a], vv.y, num[a][1]);
          num[a][2] = fmaf(w[a], vv.z, num[a][2]);
          num[a][3] = fmaf(w[a], vv.w, num[a][3]);
        }
        if (tx == 0) {
#pragma unroll
          for (int a = 0; a < 4; ++a) d_w[a] += w[a];
        }
      }
      __syncthreads();
    }

    // inter-chunk reads of the old state, then its update, along P
    Tile<DT> tq, tk;
    tq.fetch(q + off, Q, P, 0);
    tk.fetch(k + off, Q, P, 0);
    for (int p0 = 0; p0 < P; p0 += TP) {
      tq.store(Q, P, p0, det, fill_q, chunk, nullptr, ts, LD, unused_nan,
               unused_inf);
      tk.store(Q, P, p0, det, fill_k, chunk, src, ks, LD, unused_nan,
               unused_inf);
      __syncthreads();
      if (p0 + TP < P) {
        tq.fetch(q + off, Q, P, p0 + TP);
        tk.fetch(k + off, Q, P, p0 + TP);
      }
      const int pn = min(TP, P - p0);
      for (int pp = 0; pp < pn; ++pp) {
        float qa[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) qa[a] = ts[(ty * 4 + a) * LD + pp];
        const float4 cv =
            *reinterpret_cast<const float4*>(&Cs[(p0 + pp) * BV + tx * 4]);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          num_c[a][0] = fmaf(qa[a], cv.x, num_c[a][0]);
          num_c[a][1] = fmaf(qa[a], cv.y, num_c[a][1]);
          num_c[a][2] = fmaf(qa[a], cv.z, num_c[a][2]);
          num_c[a][3] = fmaf(qa[a], cv.w, num_c[a][3]);
        }
        if (tx == 0) {
          const float nv = ns[p0 + pp];
#pragma unroll
          for (int a = 0; a < 4; ++a) d_n[a] = fmaf(qa[a], nv, d_n[a]);
        }
      }
      __syncthreads();
      // rows p0 + ty of C and n: one row per 8 threads, 4 columns each;
      // even and odd j accumulate apart (two independent FMA chains)
      if (ty < pn) {
        const int p = p0 + ty;
        float u[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float s[2] = {0.f, 0.f};
        for (int j = 0; j < Q; ++j) {
          const int h = j & 1;
          const float kj = ks[j * LD + ty];
          const float4 vv =
              *reinterpret_cast<const float4*>(&vs[j * BV + tx * 4]);
          u[h][0] = fmaf(kj, vv.x, u[h][0]);
          u[h][1] = fmaf(kj, vv.y, u[h][1]);
          u[h][2] = fmaf(kj, vv.z, u[h][2]);
          u[h][3] = fmaf(kj, vv.w, u[h][3]);
          s[h] += kj;
        }
        float4* cp = reinterpret_cast<float4*>(&Cs[p * BV + tx * 4]);
        float4 cv = *cp;
        cv.x = resc * cv.x + (u[0][0] + u[1][0]);
        cv.y = resc * cv.y + (u[0][1] + u[1][1]);
        cv.z = resc * cv.z + (u[0][2] + u[1][2]);
        cv.w = resc * cv.w + (u[0][3] + u[1][3]);
        *cp = cv;
        if (tx == 0) ns[p] = resc * ns[p] + (s[0] + s[1]);
      }
      __syncthreads();
    }

    // y = (num + resc q C) / max(|den + resc q n|, exp(-F - m*))
    if (tx == 0) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
        if (ty * 4 + a < Q) den[ty * 4 + a] = d_w[a] + resc * d_n[a];
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = ty * 4 + a;
      if (t >= Q) continue;
      const float d = nan_max(fabsf(den[t]), clampv[t]);
      float* yr = y + off + (long long)t * P;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = v0 + tx * 4 + b;
        if (col < P) yr[col] = (num[a][b] + resc * num_c[a][b]) / d;
      }
    }
    m_prev = scal[1] + m_star;
    __syncthreads();  // the next chunk rewrites the gate arrays, vs and den
  }
}

size_t scan_smem(int P) {
  return sizeof(float) *
         ((size_t)P * BV + QMAX * BV + 2 * QMAX * LD + P + 5 * QMAX + 8);
}

template <int DT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* log_i, const float* log_f, int B, int H,
                   int nc, int Q, int P, const int* det_host,
                   const repro::Fill* fills, float* S, float* y, int* counts,
                   cudaStream_t stream) {
  using bits_t = typename Storage<DT>::bits_t;
  const long long tiles = (long long)B * H * nc;
  if (tiles == 0) return cudaGetLastError();
  const Detector det = repro::detector_from(det_host);
  const bits_t* qb = static_cast<const bits_t*>(q);
  const bits_t* kb = static_cast<const bits_t*>(k);
  const bits_t* vb = static_cast<const bits_t*>(v);
  mlstm_qk<DT><<<(unsigned)tiles, kThreads, 0, stream>>>(
      qb, kb, vb, Q, P, det, fills[0], fills[1], S, counts);
  const size_t smem = scan_smem(P);
  cudaError_t err = repro::allow_smem((const void*)mlstm_scan<DT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((P + BV - 1) / BV));
  mlstm_scan<DT><<<grid, kThreads, smem, stream>>>(
      qb, kb, vb, log_i, log_f, S, nc, Q, P, det, fills[0], fills[1], fills[2],
      y);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- wgmma route
namespace wg {

using namespace hopper;

constexpr int THREADS = 256;         // two warpgroups, no producer warp
constexpr int QP = 128;              // rows of a q/k box: Q, then TMA's zeros
constexpr int BOX_BYTES = QP * 128;  // one (128 x 64) 16-bit box
constexpr int MAX_BOXES = 16;        // 64-column boxes of P: P <= 1024
constexpr int W_TERMS = 3;           // W = hi + mid + lo, exact for f32
// uint4 of one tile's W fragments: [term][k step][warpgroup][thread]
constexpr int W_U4 = W_TERMS * (QP / 16) * 2 * 128;
// floats a tile: src, the clamp, den's intra-chunk sum, [resc], the row scale
constexpr int GATES = 5 * QP;
constexpr int PREP_STAGES = 4;
constexpr int CHAIN = 32;            // chunks of gates staged at once
constexpr int LDS = 65;              // row stride of a slice block's q/k tiles
// pass 1: the ring, then the barriers, the chain's gates, five gate
// arrays, the reductions, the box flags and the counts
constexpr int PREP_SMEM = 1024 + PREP_STAGES * 2 * BOX_BYTES +
                          PREP_STAGES * 8 + 2 * CHAIN * (QP + 1) * 4 +
                          5 * QP * 4 + 16 * 4 + 3 * MAX_BOXES * 4 + 8 * 4;
constexpr int SCAN_STAGES = 2;
constexpr int UV_BYTES = 2 * 32 * 128;  // 32 rows of Q <= 128 lanes, K-major

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The k-th bf16 term of x (0 hi, 1 mid, 2 lo): hi = bf16(x), and each
// further term rounds what the earlier ones leave; where hi is not finite
// the rest is 0, so an Inf or NaN is carried by hi alone.
__device__ __forceinline__ float term_of(float x, int k) {
  const float hi = bf16_rn(x);
  if (k == 0) return hi;
  const float r = isfinite(hi) ? x - hi : 0.f;
  const float mid = bf16_rn(r);
  return k == 1 ? mid : bf16_rn(r - mid);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// A 16-bit lane (n, t) of a K-major (N rows x K lanes) operand in 64-lane
// boxes of 32 rows, 128-byte swizzle: the layout TMA writes and wgmma reads.
__device__ __forceinline__ void store_kmajor(uint8_t* buf, int n, int t,
                                             uint32_t bits) {
  *reinterpret_cast<uint16_t*>(buf + (t >> 6) * 4096 + n * 128 +
                               ((((t & 63) >> 3) ^ (n & 7)) << 4) +
                               (t & 7) * 2) = (uint16_t)bits;
}

// Classifies the 8 lanes of a 16-byte chunk x; with p, stores it back with
// its fatal lanes set to the fill.  Returns NaN lanes | Inf lanes << 4.  Out
// of line: clean data never calls it.
__device__ __noinline__ int scan_fix(uint4* p, uint4 x, Detector det,
                                     uint32_t fill) {
  uint32_t w[4] = {x.x, x.y, x.z, x.w};
  int n_nan = 0, n_inf = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int sh = (e & 1) * 16;
    const int cls = repro::classify((w[e >> 1] >> sh) & 0xFFFFu, det);
    n_nan += cls & 1;
    n_inf += cls >> 1;
    if (cls) w[e >> 1] = (w[e >> 1] & ~(0xFFFFu << sh)) | (fill << sh);
  }
  if (p && (n_nan | n_inf)) *p = make_uint4(w[0], w[1], w[2], w[3]);
  return n_nan | (n_inf << 4);
}

__device__ __forceinline__ uint4 fix_vec(uint4 x, const Detector& det,
                                         uint32_t fill) {
  uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int sh = (e & 1) * 16;
    if (repro::classify((w[e >> 1] >> sh) & 0xFFFFu, det))
      w[e >> 1] = (w[e >> 1] & ~(0xFFFFu << sh)) | (fill << sh);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// F_t = lf_0 + ... + lf_t, left to right: the order of the sequential
// cumsum, so every block that needs F_t gets the same bits.
__device__ __forceinline__ float prefix(const float* lf, int t) {
  float F = 0.f;
  for (int s = 0; s <= t; ++s) F += lf[s];
  return F;
}

// m_t = max(m_prev, b_0, ..., b_t): row t's own stabilizer.
__device__ __forceinline__ float row_max(const float* b, int t, float m_prev) {
  float m = m_prev;
  for (int s = 0; s <= t; ++s) m = nan_max(m, b[s]);
  return m;
}

// 2^e with e = floor((m* - m_t) log2 e) in [0, 126]: the power of two that
// brings row t's terms (src_j, resc and the clamp, all <= exp(m_t - m*))
// back to ~1.  With strong forget gates they fall into f32's subnormal
// range, below the smallest bf16 term; y = num / max(|den|, clamp) is the
// same for num, den and clamp scaled alike, and a power of two scales
// exactly.
__device__ __forceinline__ float row_scale(float m_star, float m_t) {
  const float d = (m_star - m_t) * 1.4426950408889634f;
  const int e = d >= 126.f ? 126 : (d >= 1.f ? (int)d : 0);
  return __int_as_float((127 + e) << 23);
}

// nan_max over the block (order-free: NaN wins, else the maximum).
__device__ float block_nan_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int i = 1; i < THREADS / 32; ++i) m = nan_max(m, red[i]);
  __syncthreads();
  return m;
}

// m_{c-1} of one (b, h): from m = NEG, m <- F_end + max(m, max_t b_t) over
// chunks 0..c-1 in order.  The gates of CHAIN chunks at a time are staged in
// shared memory; lane i of warp 0 walks chunk i's gates in order (F as
// prefix() sums it), then the fold runs in chunk order.
__device__ float chain_m(const float* li, const float* lf, int Q, int c,
                         float* buf, float* out) {
  float m = NEG;
  for (int g = 0; g < c; g += CHAIN) {
    const int n = min(CHAIN, c - g);
    for (int e = threadIdx.x; e < n * Q; e += THREADS) {
      const int i = e / Q, t = e - i * Q;
      buf[i * (QP + 1) + t] = lf[(long long)g * Q + e];
      buf[(CHAIN + i) * (QP + 1) + t] = li[(long long)g * Q + e];
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      float fe = 0.f, mx = __int_as_float(0xff800000);  // -inf
      if (lane < n) {
        const float* pf = buf + lane * (QP + 1);
        const float* pi = buf + (CHAIN + lane) * (QP + 1);
        float F = 0.f;
        for (int t = 0; t < Q; ++t) {
          F += pf[t];
          mx = nan_max(mx, pi[t] - F);
        }
        fe = F;
      }
      for (int i = 0; i < n; ++i) {
        const float fi = __shfl_sync(0xffffffffu, fe, i);
        const float mi = __shfl_sync(0xffffffffu, mx, i);
        m = fi + nan_max(m, mi);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = m;
  __syncthreads();
  return *out;
}

// d(64 x 64) += A(64 x 16, K-major) B(16 x 64, MN-major)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
               REPRO_D32 ", %32, %33, p, 1, 1, 0, 1;\n}\n"
               : REPRO_ACC32(d)
               : "l"(da), "l"(db), "r"(1));
}

// d(64 x 16) += A(64 x 16, MN-major) B(16 x 16, K-major)
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da,
                                          uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                 "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
               : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}

__device__ __forceinline__ uint64_t mnmajor(uint32_t addr) {
  return sw128_desc(addr, BOX_BYTES, 1024);
}

// x, computed where it is used: the compiler cannot hoist it out of an
// unrolled loop (hoisted descriptors of every box would take registers).
__device__ __forceinline__ uint32_t here(uint32_t x) {
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
  return x;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

struct Args {
  const float* log_i;  // (B*H*nc, Q) f32
  const float* log_f;
  const uint16_t* q;   // (B*H*nc, Q, P) bf16 bits
  const uint16_t* k;
  const uint16_t* v;
  int nc, Q, P, nbox;  // nbox = ceil(P / 64): boxes, and slices of n
  long long tiles;     // B*H*nc
  Detector det;
  uint32_t floor, fill;
  const uint32_t* fills[3];  // neighbor_mean: q, k, v per tile, else null
  uint4* wfrag;  // [tile][W_U4]
  float* gates;  // [tile][GATES]
  float* qn;     // [tile][nbox][QP]: q . n_{c-1} over each 64-column slice
  int* flags;    // [tile][q, k, v][nbox]
  int* counts;   // int32[8]
  float* y;      // (B*H*nc, Q, P) f32
};

// The fill of a fatal lane of operand `which` (0 q, 1 k, 2 v) in `tile`.
__device__ __forceinline__ uint32_t fill_at(const Args& a, int which,
                                            long long tile) {
  const uint32_t* t = a.fills[which];
  return t ? __ldg(t + tile) : a.fill;
}

// Pass 1, a tile block: counts, flags, S by wgmma, the gates, W's terms.
__device__ void prep_tile(const CUtensorMap* map_q, const CUtensorMap* map_k,
                          const Args& a, uint8_t* smem, long long tile) {
  uint8_t* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + PREP_STAGES * 2 * BOX_BYTES);
  float* chain = reinterpret_cast<float*>(full + PREP_STAGES);
  float* lf_s = chain + 2 * CHAIN * (QP + 1);
  float* li_s = lf_s + QP;
  float* src_s = li_s + QP;
  float* b_s = src_s + QP;
  float* sc_s = b_s + QP;   // the row scales
  float* red = sc_s + QP;   // [8], then the chain's result
  int* bflag = reinterpret_cast<int*>(red + 16);  // [q, k, v][MAX_BOXES]
  int* cnt = bflag + 3 * MAX_BOXES;               // NaN/Inf lanes of q, k, v
  const int tid = threadIdx.x, wgi = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int Q = a.Q, P = a.P, nbox = a.nbox;
  const long long bh = tile / a.nc;
  const int c = (int)(tile - bh * a.nc);

  if (tid == 0) {
    for (int s = 0; s < PREP_STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < 3 * MAX_BOXES) bflag[tid] = 0;
  if (tid < 6) cnt[tid] = 0;
  __syncthreads();
  auto issue = [&](int it) {
    const int s = it % PREP_STAGES;
    const uint32_t bar = smem_u32(&full[s]);
    const uint32_t dst = smem_u32(ring + s * 2 * BOX_BYTES);
    mbar_expect_tx(bar, 2 * BOX_BYTES);
    tma_load_3d(dst, map_q, it * 64, 0, (int)tile, bar);
    tma_load_3d(dst + BOX_BYTES, map_k, it * 64, 0, (int)tile, bar);
  };
  if (tid == 0)
    for (int it = 0; it < min(nbox, PREP_STAGES); ++it) issue(it);

  // the gates: m_{c-1} by the chain, then this chunk's F, b, src, clamp
  const float* lf0 = a.log_f + bh * a.nc * Q;
  const float* li0 = a.log_i + bh * a.nc * Q;
  if (tid < Q) {
    lf_s[tid] = lf0[(long long)c * Q + tid];
    li_s[tid] = li0[(long long)c * Q + tid];
  }
  const float m_prev = chain_m(li0, lf0, Q, c, chain, red + 8);
  float F = 0.f, b = __int_as_float(0xff800000);
  if (tid < Q) {
    F = prefix(lf_s, tid);
    b = li_s[tid] - F;
    b_s[tid] = b;
  }
  const float m_star = nan_max(m_prev, block_nan_max(b, red));
  float* g = a.gates + tile * GATES;
  if (tid < Q) {
    const float src = expf(b - m_star);
    const float scale = row_scale(m_star, row_max(b_s, tid, m_prev));
    src_s[tid] = src;
    sc_s[tid] = scale;
    g[tid] = src;
    g[QP + tid] = expf(-F - m_star) * scale;
    g[4 * QP + tid] = scale;
  }
  if (tid == 0) g[3 * QP] = expf(m_prev - m_star);

  // q and k box by box: classify, count, repair, flag; v straight from
  // global memory, counted and flagged; S += q k^T
  float S[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) S[i] = 0.f;
  int n[6] = {0, 0, 0, 0, 0, 0};
  const uint16_t* vt = a.v + tile * Q * P;
  for (int it = 0; it < nbox; ++it) {
    const int s = it % PREP_STAGES;
    uint8_t* qb = ring + s * 2 * BOX_BYTES;
    uint4 vv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = tid + j * THREADS, r = e >> 3, col = it * 64 + (e & 7) * 8;
      vv[j] = (r < Q && col < P)
                  ? __ldg(reinterpret_cast<const uint4*>(vt + (long long)r * P + col))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
    mbar_wait(smem_u32(&full[s]), (it / PREP_STAGES) & 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = tid + j * THREADS, which = j >> 2, slot = e & 1023;
      const int r = slot >> 3, col = it * 64 + ((slot & 7) ^ (r & 7)) * 8;
      if (r < Q && col < P) {
        uint4* p = reinterpret_cast<uint4*>(qb + which * BOX_BYTES) + slot;
        const uint4 x = *p;
        if (may_be_fatal(x, a.det.exp_mask, a.floor)) {
          const int f = scan_fix(p, x, a.det, fill_at(a, which, tile));
          if (f) {
            n[2 * which] += f & 15;
            n[2 * which + 1] += f >> 4;
            bflag[which * MAX_BOXES + it] = 1;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (may_be_fatal(vv[j], a.det.exp_mask, a.floor)) {
        const int f = scan_fix(nullptr, vv[j], a.det, a.fill);
        if (f) {
          n[4] += f & 15;
          n[5] += f >> 4;
          bflag[2 * MAX_BOXES + it] = 1;
        }
      }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (wgi * 64 < Q) {
      const uint32_t qa = smem_u32(qb) + wgi * 64 * 128;
      const uint32_t ka = smem_u32(qb + BOX_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        attn::wgmma_qk<repro::DT_BF16>(S, kmajor(qa + kk * 32),
                                       kmajor(ka + kk * 32), (it | kk) != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(S);
    }
    __syncthreads();  // both warpgroups are done with stage s
    if (tid == 0 && it + PREP_STAGES < nbox) issue(it + PREP_STAGES);
  }

  // the tile's counts, as the reference counts them
#pragma unroll
  for (int s = 0; s < 6; ++s) repro::block_add(&cnt[s], n[s]);
  __syncthreads();
  if (tid == 0) {
    const int ev_q = (cnt[0] + cnt[1]) > 0;
    const int ev_kv = (cnt[2] + cnt[3] + cnt[4] + cnt[5]) > 0;
    const int add[7] = {cnt[0], cnt[1], ev_q, cnt[2] + cnt[4], cnt[3] + cnt[5],
                        ev_kv, ev_q | ev_kv};
#pragma unroll
    for (int s = 0; s < 7; ++s)
      if (add[s]) atomicAdd(&a.counts[s], add[s]);
  }
  if (tid < 3 * nbox)
    a.flags[tile * 3 * nbox + tid] = bflag[tid / nbox * MAX_BOXES + tid % nbox];

  // W = tril(S src) and den's intra-chunk sum, each row times its scale;
  // W's three terms in the A fragment order of wgmma m64nNk16 (rows 16 warp
  // + lane/4 (+8), columns 2 (lane % 4) (+1) (+8) of each 16-column k step)
  const int r0 = wgi * 64 + warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e >> 1), col = 8 * j + c0 + (e & 1);
      // W as the plain version rounds it, then scaled (exactly) by the row's
      // power of two
      const float w = (row < Q && col <= row)
                          ? (S[4 * j + e] * src_s[col]) * sc_s[row]
                          : 0.f;
      S[4 * j + e] = w;
      rs[e >> 1] += w;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float sum = attn::quad_sum(rs[i]);
    const int row = r0 + 8 * i;
    if ((lane & 3) == 0 && row < Q) g[2 * QP + row] = sum;
  }
  uint4* wf = a.wfrag + tile * W_U4 + wgi * 128 + (tid & 127);
#pragma unroll
  for (int kk = 0; kk < QP / 16; ++kk)
#pragma unroll
    for (int t = 0; t < W_TERMS; ++t) {
      const float* x = S + 8 * kk;
      wf[(t * (QP / 16) + kk) * 256] = make_uint4(
          pack_bf16(term_of(x[0], t), term_of(x[1], t)),
          pack_bf16(term_of(x[2], t), term_of(x[3], t)),
          pack_bf16(term_of(x[4], t), term_of(x[5], t)),
          pack_bf16(term_of(x[6], t), term_of(x[7], t)));
    }
}

// Pass 1, a slice block: n over 64 columns of P in f32, chunk by chunk, and
// each chunk's q . n_{c-1} over the slice.
__device__ void prep_norm(const Args& a, uint8_t* smem, long long blk) {
  float* qs = reinterpret_cast<float*>(smem);  // [QP][LDS]
  float* ks = qs + QP * LDS;
  float* nv = ks + QP * LDS;  // [64]
  float* part = nv + 64;      // [2][64]
  float* lf_s = part + 128;
  float* li_s = lf_s + QP;
  float* src_s = li_s + QP;
  float* red = src_s + QP;  // [8], then F_end
  const int tid = threadIdx.x, Q = a.Q, P = a.P, nsl = a.nbox;
  const long long bh = blk / nsl;
  const int p0 = (int)(blk - bh * nsl) * 64;
  if (tid < 64) nv[tid] = 0.f;
  float m_prev = NEG;

  uint4 rq[4], rk[4];
  auto fetch = [&](long long tile) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = tid + j * THREADS, r = e >> 3, col = p0 + (e & 7) * 8;
      const bool in = r < Q && col < P;
      const long long off = (tile * Q + r) * P + col;
      rq[j] = in ? __ldg(reinterpret_cast<const uint4*>(a.q + off))
                 : make_uint4(0u, 0u, 0u, 0u);
      rk[j] = in ? __ldg(reinterpret_cast<const uint4*>(a.k + off))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  fetch(bh * a.nc);
  for (int c = 0; c < a.nc; ++c) {
    const long long tile = bh * a.nc + c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = tid + j * THREADS, r = e >> 3, col = (e & 7) * 8;
      if (r >= QP) continue;
      uint4 x[2] = {rq[j], rk[j]};
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        if (may_be_fatal(x[w], a.det.exp_mask, a.floor))
          x[w] = fix_vec(x[w], a.det, fill_at(a, w, tile));
        const uint32_t b[4] = {x[w].x, x[w].y, x[w].z, x[w].w};
        float* dst = (w ? ks : qs) + r * LDS + col;
#pragma unroll
        for (int l = 0; l < 8; ++l)
          dst[l] = __uint_as_float(((b[l >> 1] >> ((l & 1) * 16)) & 0xFFFFu) << 16);
      }
    }
    if (tid < Q) {
      lf_s[tid] = a.log_f[tile * Q + tid];
      li_s[tid] = a.log_i[tile * Q + tid];
    }
    if (c + 1 < a.nc) fetch(tile + 1);
    __syncthreads();
    float F = 0.f, b = __int_as_float(0xff800000);
    if (tid < Q) {
      F = prefix(lf_s, tid);
      b = li_s[tid] - F;
      if (tid == Q - 1) red[8] = F;
    }
    const float m_star = nan_max(m_prev, block_nan_max(b, red));
    const float resc = expf(m_prev - m_star);
    if (tid < Q) src_s[tid] = expf(b - m_star);
    __syncthreads();
    if (tid < QP) {
      if (tid < Q) {
        float acc = 0.f;
        for (int p = 0; p < 64; ++p) acc = fmaf(qs[tid * LDS + p], nv[p], acc);
        a.qn[(tile * nsl + blk - bh * nsl) * QP + tid] = acc;
      }
    } else {
      const int p = tid & 63, h = (tid >> 6) & 1, t1 = (h + 1) * (Q / 2);
      float acc = 0.f;
      for (int t = h * (Q / 2); t < t1; ++t) acc += src_s[t] * ks[t * LDS + p];
      part[h * 64 + p] = acc;
    }
    __syncthreads();
    if (tid < 64) nv[tid] = resc * nv[tid] + (part[tid] + part[64 + tid]);
    m_prev = red[8] + m_star;
    __syncthreads();  // the next chunk rewrites the tiles, gates and red
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    mlstm_prep_wgmma(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  if (blockIdx.x < a.tiles)
    prep_tile(&map_q, &map_k, a, smem, blockIdx.x);
  else
    prep_norm(a, smem, blockIdx.x - a.tiles);
}

// W_tj of a tile, rebuilt in f32 from its three terms (exact).
__device__ __forceinline__ float w_at(const Args& a, long long tile, int t,
                                      int j) {
  const int rr = t & 63;
  const int thread = (rr >> 4) * 32 + (rr & 7) * 4 + ((j & 7) >> 1);
  const int reg = ((rr >> 3) & 1) + 2 * ((j >> 3) & 1);
  const uint16_t* base = reinterpret_cast<const uint16_t*>(a.wfrag + tile * W_U4);
  float w = 0.f;
#pragma unroll
  for (int k = 0; k < W_TERMS; ++k) {
    const long long u4 = (k * (QP / 16) + (j >> 4)) * 256 + (t >> 6) * 128 + thread;
    w += __uint_as_float((uint32_t)base[u4 * 8 + reg * 2 + (j & 1)] << 16);
  }
  return w;
}

size_t scan_wgmma_smem(int nbox) {
  return 1024 + (size_t)nbox * 64 * 128 + SCAN_STAGES * 2 * BOX_BYTES +
         3 * UV_BYTES + SCAN_STAGES * 8 + 32 * 4 * 4 + 16 +
         3 * MAX_BOXES * 4;
}

// d(64 x 32) += A(64 x 16, four registers a thread) B(16 x 32, K-major)
__device__ __forceinline__ void wgmma_n32_rs(float (&d)[16], const uint4& a,
                                             uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
               "%14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                 "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                 "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
                 "+f"(d[14]), "+f"(d[15])
               : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(db), "r"(1));
}

// Pass 2: the chunk recurrence for value columns [v0, v0 + 32) of one (b, h).
// Row t's output is formed scaled by its power of two s_t (pass 1 scaled W,
// den's intra-chunk sum and the clamp): num = W v + (s_t resc) q C.
__global__ void __launch_bounds__(THREADS, 1)
    mlstm_scan_wgmma(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const int Q = a.Q, P = a.P, nbox = a.nbox, nc = a.nc;
  uint8_t* chl = align1024(smem_raw);  // P rows of [C_hi 32 | C_lo 32] bf16
  uint8_t* ring = chl + nbox * 64 * 128;
  uint8_t* vt = ring + SCAN_STAGES * 2 * BOX_BYTES;  // v^T
  uint8_t* uh = vt + UV_BYTES;                       // (src v)^T, hi and lo
  uint8_t* ul = uh + UV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ul + UV_BYTES);
  uint32_t* nf = reinterpret_cast<uint32_t*>(full + SCAN_STAGES);  // [32][4]
  int* nf_any = reinterpret_cast<int*>(nf + 128);
  int* fl = nf_any + 4;  // the chunk's flags: [q, k, v][nbox]
  const int tid = threadIdx.x, wgi = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const long long bh = blockIdx.x;
  const int v0 = blockIdx.y * 32, total = nc * nbox;
  const int r0 = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);

  if (tid == 0) {
    for (int s = 0; s < SCAN_STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int e = tid; e < nbox * 64 * 8; e += THREADS)
    reinterpret_cast<uint4*>(chl)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  auto issue = [&](int it) {
    const int s = it % SCAN_STAGES, c = it / nbox, b = it - c * nbox;
    const uint32_t bar = smem_u32(&full[s]);
    const uint32_t dst = smem_u32(ring + s * 2 * BOX_BYTES);
    mbar_expect_tx(bar, 2 * BOX_BYTES);
    tma_load_3d(dst, &map_q, b * 64, 0, (int)(bh * nc + c), bar);
    tma_load_3d(dst + BOX_BYTES, &map_k, b * 64, 0, (int)(bh * nc + c), bar);
  };
  if (tid == 0)
    for (int it = 0; it < min(total, SCAN_STAGES); ++it) issue(it);

  // this warpgroup's 16 columns of C, 64 rows a box of P
  float C[MAX_BOXES][8];
#pragma unroll
  for (int b = 0; b < MAX_BOXES; ++b)
#pragma unroll
    for (int i = 0; i < 8; ++i) C[b][i] = 0.f;
  int it = 0;
  for (int c = 0; c < nc; ++c) {
    const long long tile = bh * nc + c;
    const float* g = a.gates + tile * GATES;
    const float resc = g[3 * QP];

    // ---- this thread's two rows: s_t resc and max(|den|, clamp), scaled;
    // the partial q . n of every slice loaded at once
    float sr[2], den[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = min(wgi * 64 + r0 + 8 * i, Q - 1);
      const float* qn = a.qn + tile * nbox * QP + r;
      float part[MAX_BOXES];
#pragma unroll
      for (int sl = 0; sl < MAX_BOXES; ++sl)
        part[sl] = sl < nbox ? qn[sl * QP] : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int sl = 0; sl < MAX_BOXES; ++sl)
        if (sl < nbox) sum += part[sl];
      sr[i] = g[4 * QP + r] * resc;
      den[i] = nan_max(fabsf(g[2 * QP + r] + sr[i] * sum), g[QP + r]);
    }

    // ---- the value slab, repaired: v^T and the hi/lo pair of (src v)^T.
    // nf, nf_any and fl were last read before the previous chunk's final box
    // barrier (the non-finite terms are added before the box loop for this
    // reason), so warpgroup 0 may clear them here without a barrier of its
    // own; a read of them after the box loop would race with this reset.
    if (tid < 128) nf[tid] = 0u;
    if (tid == 0) *nf_any = 0;
    if (tid < 3 * nbox) fl[tid] = a.flags[tile * 3 * nbox + tid];
    __syncthreads();
    const int vflag = fl[2 * nbox + (v0 >> 6)];
    // rows past Q are zeros: the products below always run all QP / 16 k
    // steps (a branch between two wgmma makes ptxas fence them apart)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = tid + j * THREADS, t = e >> 2, ch = e & 3;
      const int col = v0 + ch * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (t < Q && col < P)
        x = __ldg(reinterpret_cast<const uint4*>(a.v + (tile * Q + t) * P + col));
      // v's tile fill goes in before the hi/lo split below
      if (vflag) x = fix_vec(x, a.det, fill_at(a, 2, tile));
      const float src = t < Q ? g[t] : 0.f;
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        const uint32_t bits = (w[l >> 1] >> ((l & 1) * 16)) & 0xFFFFu;
        const int n = ch * 8 + l;
        const bool fin = (bits & 0x7F80u) != 0x7F80u;
        if (!fin) {
          atomicOr(&nf[n * 4 + (t >> 5)], 1u << (t & 31));
          *nf_any = 1;
        }
        const float u = src * __uint_as_float(bits << 16);
        const float u_hi = bf16_rn(u);
        store_kmajor(vt, n, t, fin ? bits : 0u);
        store_kmajor(uh, n, t, bf16_bits(u_hi));
        store_kmajor(ul, n, t, isfinite(u_hi) ? bf16_bits(u - u_hi) : 0u);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();

    // ---- W v (the finite lanes of v), W's scaled terms as A fragments,
    // four k steps at a time
    float wv[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) wv[i] = 0.f;
    fence_regs(wv);
    {
      const uint4* wf = a.wfrag + tile * W_U4 + wgi * 128 + (tid & 127);
      const uint32_t vb = smem_u32(vt);
#pragma unroll
      for (int t = 0; t < W_TERMS; ++t)
#pragma unroll
        for (int k0 = 0; k0 < QP / 16; k0 += 4) {
          uint4 fr[4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            fr[kk] = __ldg(wf + (t * (QP / 16) + k0 + kk) * 256);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_n32_rs(wv, fr[kk], kmajor(vb + ((k0 + kk) >> 2) * 4096 +
                                           (kk & 3) * 32));
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(wv);
        }
      // the non-finite lanes' terms, in f32
      if (*nf_any) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wgi * 64 + r0 + 8 * i;
          if (r >= Q) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = 8 * j + cq + e;
              float corr = 0.f;
              bool any = false;
#pragma unroll 1
              for (int w4 = 0; w4 < 4; ++w4) {
                uint32_t bits = nf[n * 4 + w4];
                while (bits) {
                  const int jj = w4 * 32 + __ffs(bits) - 1;
                  bits &= bits - 1;
                  uint32_t vb16 = a.v[(tile * Q + jj) * P + v0 + n];
                  if (repro::classify(vb16, a.det)) vb16 = fill_at(a, 2, tile);
                  corr += w_at(a, tile, r, jj) * __uint_as_float(vb16 << 16);
                  any = true;
                }
              }
              if (any) wv[4 * j + 2 * i + e] += corr;
            }
        }
      }
    }

    // ---- box by box of P: q C (the old C, from its hi/lo copy) and the
    // update C <- resc C + k^T (U_hi + U_lo) of this warpgroup's columns
    float qc[32];  // [q C_hi | q C_lo]
#pragma unroll
    for (int i = 0; i < 32; ++i) qc[i] = 0.f;
    fence_regs(qc);
#pragma unroll
    for (int b = 0; b < MAX_BOXES; ++b) {
      if (b < nbox) {
        const int s = it % SCAN_STAGES;
        uint8_t* qb = ring + s * 2 * BOX_BYTES;
        mbar_wait(smem_u32(&full[s]), (it / SCAN_STAGES) & 1);
        const int fq = fl[b], fk = fl[nbox + b];
        if (fq | fk) {
          for (int e = tid; e < 2 * 1024; e += THREADS) {
            const int which = e >> 10, slot = e & 1023;
            if (!(which ? fk : fq)) continue;
            const int r = slot >> 3, col = b * 64 + ((slot & 7) ^ (r & 7)) * 8;
            if (r < Q && col < P)
              repair_chunk(reinterpret_cast<uint4*>(qb + which * BOX_BYTES) + slot,
                           8, a.det, fill_at(a, which, tile));
          }
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) C[b][i] *= resc;
        fence_regs(C[b]);  // scaled before the group, not sunk into it
        const uint32_t qa = smem_u32(qb) + wgi * 64 * 128;
        const uint32_t ka = smem_u32(qb + BOX_BYTES);
        const uint32_t cb = here(smem_u32(chl) + b * 64 * 128);
        const uint32_t ub = here(smem_u32(uh) + wgi * 16 * 128);
        const uint32_t lb = ub + UV_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n64(qc, kmajor(qa + kk * 32), mnmajor(cb + kk * 16 * 128));
#pragma unroll
        for (int kk = 0; kk < QP / 16; ++kk) {
          const uint32_t off = (kk >> 2) * 4096 + (kk & 3) * 32;
          wgmma_n16(C[b], mnmajor(ka + kk * 16 * 128), kmajor(ub + off));
          wgmma_n16(C[b], mnmajor(ka + kk * 16 * 128), kmajor(lb + off));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(qc);
        fence_regs(C[b]);
        __syncthreads();  // both warpgroups are done with stage s
        if (tid == 0 && it + SCAN_STAGES < total) issue(it + SCAN_STAGES);
        ++it;
      }
    }

    // ---- y = (W v + s_t resc q C) / max(|den|, clamp), all scaled by s_t
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wgi * 64 + r0 + 8 * i;
      if (r >= Q) continue;
      float* yr = a.y + (tile * Q + r) * P;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + 8 * j + cq;
        if (col >= P) continue;
        const int e = 4 * j + 2 * i;
        const float n0 = wv[e] + sr[i] * (qc[e] + qc[16 + e]);
        const float n1 = wv[e + 1] + sr[i] * (qc[e + 1] + qc[17 + e]);
        *reinterpret_cast<float2*>(yr + col) =
            make_float2(n0 / den[i], n1 / den[i]);
      }
    }
    if (c + 1 == nc) break;

    // ---- C's new hi/lo copy (rows past P stay 0); the next chunk's q C
    // reads it, after the barrier that follows its value slab
#pragma unroll
    for (int b = 0; b < MAX_BOXES; ++b) {
      if (b >= nbox) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = b * 64 + r0 + 8 * i;
        if (p >= P) continue;
        uint8_t* row = chl + p * 128;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = wgi * 16 + 8 * j + cq;
          const float x0 = C[b][4 * j + 2 * i], x1 = C[b][4 * j + 2 * i + 1];
          const float h0 = bf16_rn(x0), h1 = bf16_rn(x1);
          const uint32_t hi = pack_bf16(h0, h1);
          const uint32_t lo = pack_bf16(isfinite(h0) ? x0 - h0 : 0.f,
                                        isfinite(h1) ? x1 - h1 : 0.f);
          *reinterpret_cast<uint32_t*>(
              row + (((n >> 3) ^ (p & 7)) << 4) + (n & 7) * 2) = hi;
          *reinterpret_cast<uint32_t*>(
              row + ((((n + 32) >> 3) ^ (p & 7)) << 4) + (n & 7) * 2) = lo;
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
}

// Byte offsets of the route's scratch parts, each 16-byte aligned: W's
// fragments first, then the gates, the partial q . n and the box flags.
struct Scratch {
  size_t gates, qn, flags, total;
  Scratch(long long tiles, int nbox) {
    gates = (size_t)tiles * W_U4 * 16;
    qn = gates + (size_t)tiles * GATES * 4;
    flags = qn + (size_t)tiles * nbox * QP * 4;
    total = (flags + (size_t)tiles * 3 * nbox * 4 + 15) & ~(size_t)15;
  }
};

bool shape_ok(int B, int H, int nc, int Q, int P) {
  return B > 0 && H > 0 && nc > 0 && Q >= 16 && Q <= QP && Q % 16 == 0 &&
         P >= 8 && P <= MAX_BOXES * 64 && P % 8 == 0 &&
         (long long)B * H * nc < (1ll << 31) &&
         (long long)B * H * ((P + 63) / 64) < (1ll << 30);
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* log_i, const float* log_f, int B, int H,
                   int nc, int Q, int P, const int* det_host,
                   unsigned int fill, const unsigned int* const* fills,
                   void* scratch, float* y, int* counts,
                   cudaStream_t stream) {
  const long long tiles = (long long)B * H * nc;
  const int nbox = (P + 63) / 64;
  CUtensorMap map_q, map_k;
  if (!tensor_map_3d(&map_q, q, repro::DT_BF16, (int)tiles, Q, P, QP, 64) ||
      !tensor_map_3d(&map_k, k, repro::DT_BF16, (int)tiles, Q, P, QP, 64))
    return cudaErrorInvalidValue;
  static bool smem_set = false;  // the attributes are set once per kernel
  if (!smem_set) {
    cudaError_t err =
        repro::allow_smem((const void*)mlstm_prep_wgmma, PREP_SMEM);
    if (err == cudaSuccess)
      err = repro::allow_smem((const void*)mlstm_scan_wgmma,
                              scan_wgmma_smem(MAX_BOXES));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const Scratch sc(tiles, nbox);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  const Detector det = repro::detector_from(det_host);
  const Args a{log_i,
               log_f,
               static_cast<const uint16_t*>(q),
               static_cast<const uint16_t*>(k),
               static_cast<const uint16_t*>(v),
               nc,
               Q,
               P,
               nbox,
               tiles,
               det,
               fatal_floor(det),
               fill,
               {fills[0], fills[1], fills[2]},
               reinterpret_cast<uint4*>(base),
               reinterpret_cast<float*>(base + sc.gates),
               reinterpret_cast<float*>(base + sc.qn),
               reinterpret_cast<int*>(base + sc.flags),
               counts,
               y};
  mlstm_prep_wgmma<<<(unsigned)(tiles + (long long)B * H * nbox), THREADS,
                     PREP_SMEM, stream>>>(map_q, map_k, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_scan_wgmma<<<dim3((unsigned)(B * H), (unsigned)((P + 31) / 32)),
                     THREADS, scan_wgmma_smem(nbox), stream>>>(map_q, map_k,
                                                               a);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// q, k, v: (B, H, nc, Q, P) row-major on the device in dtype dt (0 f32,
// 1 bf16, 2 f16); log_i, log_f: (B, H, nc, Q) f32; det: host int32[8];
// fill: the repaired lane's bit pattern, or with fills_q/k/v (device
// uint32 per (b, h, c) tile of each operand, from repro_tile_fill; null:
// none) the lane's tile's entry; S: (B, H, nc, Q, Q) f32 scratch; y: (B,
// H, nc, Q, P) f32 out; counts: zeroed int32[8].  Returns
// cudaGetLastError() after the launches.
extern "C" int repro_mlstm_chunk(const void* q, const void* k, const void* v,
                                 const float* log_i, const float* log_f,
                                 int dt, int B, int H, int nc, int Q, int P,
                                 const int* det, unsigned int fill,
                                 const unsigned int* fills_q,
                                 const unsigned int* fills_k,
                                 const unsigned int* fills_v, float* S,
                                 float* y, int* counts, void* stream) {
  if (Q < 1 || Q > QMAX || P < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const repro::Fill f[3] = {{fills_q, fill}, {fills_k, fill}, {fills_v, fill}};
  switch (dt) {
    case repro::DT_F32:
      return (int)launch<repro::DT_F32>(q, k, v, log_i, log_f, B, H, nc, Q, P,
                                        det, f, S, y, counts, s);
    case repro::DT_BF16:
      return (int)launch<repro::DT_BF16>(q, k, v, log_i, log_f, B, H, nc, Q,
                                         P, det, f, S, y, counts, s);
    case repro::DT_F16:
      return (int)launch<repro::DT_F16>(q, k, v, log_i, log_f, B, H, nc, Q, P,
                                        det, f, S, y, counts, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The wgmma route's scratch in bytes for a shape it takes, into *bytes;
// cudaErrorInvalidValue for any other shape.
extern "C" int repro_mlstm_wgmma_scratch(int B, int H, int nc, int Q, int P,
                                         long long* bytes) {
  if (!wg::shape_ok(B, H, nc, Q, P)) return (int)cudaErrorInvalidValue;
  *bytes = (long long)wg::Scratch((long long)B * H * nc, (P + 63) / 64).total;
  return 0;
}

// The wgmma route: q, k, v (B, H, nc, Q, P) bf16 row-major on the device,
// each 16-byte aligned, Q a multiple of 16 up to 128, P a multiple of 8 up to
// 1024; log_i, log_f (B, H, nc, Q) f32; det host int32[8]; fill the repaired
// lane's bf16 bits, fills_q/k/v as for repro_mlstm_chunk; scratch repro_mlstm_wgmma_scratch bytes, 16-byte
// aligned (every byte the kernels read is written first); y (B, H, nc, Q, P)
// f32 out; counts zeroed int32[8].  Launches mlstm_prep_wgmma, then
// mlstm_scan_wgmma; returns cudaGetLastError().
extern "C" int repro_mlstm_chunk_wgmma(const void* q, const void* k,
                                       const void* v, const float* log_i,
                                       const float* log_f, int B, int H,
                                       int nc, int Q, int P, const int* det,
                                       unsigned int fill,
                                       const unsigned int* fills_q,
                                       const unsigned int* fills_k,
                                       const unsigned int* fills_v,
                                       void* scratch, float* y, int* counts,
                                       void* stream) {
  if (!wg::shape_ok(B, H, nc, Q, P) ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(scratch)) &
       15))
    return (int)cudaErrorInvalidValue;
  const unsigned int* fills[3] = {fills_q, fills_k, fills_v};
  return (int)wg::launch(q, k, v, log_i, log_f, B, H, nc, Q, P, det, fill,
                         fills, scratch, y, counts,
                         static_cast<cudaStream_t>(stream));
}
