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
// lane takes the fill's bit pattern.  Every block repairs what it reads;
// only pass 1 counts.
//
// What bounds it on an H100: operations.  Per chunk and head the function
// needs 2 Q^2 P + 4 Q P^2 flops (the causal halves of q k^T and W v, then
// q C and the C update) against 3 Q P inputs; at Q = 128, P = 1024 that
// is ~725 flops per input byte in bf16, far above the card's ~295.  This first form runs on the FP32 pipe
// (67 TFLOP/s), so it is expected to sit an order of magnitude above the
// bf16 tensor-core bound; wgmma on the slab products is the redesign.
#include "repair.cuh"

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
                                        const Detector& det, uint32_t fill,
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
        if (cls) bits = fill;
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
             Detector det, uint32_t fill, float* __restrict__ S,
             int* __restrict__ counts) {
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
    tq.store(Q, P, p0, det, fill, nullptr, qs, LD, n[0], n[1]);
    tk.store(Q, P, p0, det, fill, nullptr, ks, LD, n[2], n[3]);
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
               int nc, int Q, int P, Detector det, uint32_t fill,
               float* __restrict__ y) {
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
      tv.store(Q, P, v0, det, fill, nullptr, vs, BV, unused_nan, unused_inf);
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
      tq.store(Q, P, p0, det, fill, nullptr, ts, LD, unused_nan, unused_inf);
      tk.store(Q, P, p0, det, fill, src, ks, LD, unused_nan, unused_inf);
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
                   unsigned int fill, float* S, float* y, int* counts,
                   cudaStream_t stream) {
  using bits_t = typename Storage<DT>::bits_t;
  const long long tiles = (long long)B * H * nc;
  if (tiles == 0) return cudaGetLastError();
  const Detector det = repro::detector_from(det_host);
  const bits_t* qb = static_cast<const bits_t*>(q);
  const bits_t* kb = static_cast<const bits_t*>(k);
  const bits_t* vb = static_cast<const bits_t*>(v);
  mlstm_qk<DT><<<(unsigned)tiles, kThreads, 0, stream>>>(
      qb, kb, vb, Q, P, det, fill, S, counts);
  const size_t smem = scan_smem(P);
  cudaError_t err = repro::allow_smem((const void*)mlstm_scan<DT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((P + BV - 1) / BV));
  mlstm_scan<DT><<<grid, kThreads, smem, stream>>>(
      qb, kb, vb, log_i, log_f, S, nc, Q, P, det, fill, y);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, H, nc, Q, P) row-major on the device in dtype dt (0 f32,
// 1 bf16, 2 f16); log_i, log_f: (B, H, nc, Q) f32; det: host int32[8];
// fill: the repaired lane's bit pattern; S: (B, H, nc, Q, Q) f32 scratch;
// y: (B, H, nc, Q, P) f32 out; counts: zeroed int32[8].  Returns
// cudaGetLastError() after the launches.
extern "C" int repro_mlstm_chunk(const void* q, const void* k, const void* v,
                                 const float* log_i, const float* log_f,
                                 int dt, int B, int H, int nc, int Q, int P,
                                 const int* det, unsigned int fill, float* S,
                                 float* y, int* counts, void* stream) {
  if (Q < 1 || Q > QMAX || P < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dt) {
    case repro::DT_F32:
      return (int)launch<repro::DT_F32>(q, k, v, log_i, log_f, B, H, nc, Q, P,
                                        det, fill, S, y, counts, s);
    case repro::DT_BF16:
      return (int)launch<repro::DT_BF16>(q, k, v, log_i, log_f, B, H, nc, Q,
                                         P, det, fill, S, y, counts, s);
    case repro::DT_F16:
      return (int)launch<repro::DT_F16>(q, k, v, log_i, log_f, B, H, nc, Q, P,
                                        det, fill, S, y, counts, s);
  }
  return (int)cudaErrorInvalidValue;
}
