// Flash attention (online softmax) with the K/V tiles repaired on load, and
// the AT event counts.
//
// Replaces src/repro/kernels/repair_attention.py::_flash_kernel (:44, behind
// `flash_attention_raw`).  One block per (b, h, 64-row q tile).  It walks the
// K/V tiles of KV head h / G (G = H / Kh) in order from position 0, repairs
// each 64-key tile into shared memory as f32 (a fatal lane takes the fill's
// bit pattern, precomputed by the host in the storage dtype), and keeps the
// online-softmax state (m, l, acc) across tiles:
//   s = q . k^T * (1 / sqrt(D)) in f32; masked positions get -1e30 (the
//   reference's mask value, not -inf); m_new = max(m, rowmax s);
//   p = exp(s - m_new); alpha = exp(m - m_new); l = l * alpha + rowsum p;
//   acc = acc * alpha + p . v   (p stays f32, unlike the paged kernels)
//   out = acc / max(l, 1e-30), cast to q's dtype.
// Causal masking is the reference kernel's top-left alignment (query s sees
// keys t <= s, also for S != T); tiles past the q tile's last row are
// skipped.  q is not repaired, as in the reference.
//
// Counts: defined on the reference's logical (bq, bk) grid, whose tiles this
// kernel does not share, so a counting pass reads the live K/V tiles once
// more: flash_count_tiles adds each logical tile's NaN/Inf lanes of K and V
// into per-tile counters (a tile may span several blocks, integer atomics),
// and a one-block epilogue weights every tile by its visit count G * L(kj)
// (L(kj) = q tiles with kj*bk <= qi*bq + bq - 1 when causal, S / bq
// otherwise) into the seven AT counts.
//
// What bounds it on an H100: operations (2*B*H*S*T*D flops at causal
// S = T, against the bf16 tensor-core peak).  This first form multiplies on
// the FP32 pipe from padded shared memory (row stride D + 1, so the score
// loop reads are conflict-free), 4 x 4 scores and 4 x D/16 outputs per
// thread; heavy (late) causal q tiles are launched first.  wgmma and a
// TMA-fed K/V ring are the later redesign.
#include "repair.cuh"

namespace {

using repro::Detector;
using repro::NEG_INF;
using repro::Storage;

constexpr int BQ = 64, BKV = 64, kThreads = 256;
constexpr int PS = BKV + 1;       // row stride of the score tile
constexpr long long kChunk = 8192;  // lanes per counting block

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
                     Detector det_k, Detector det_v,
                     typename Storage<DT>::bits_t fill_k,
                     typename Storage<DT>::bits_t fill_v) {
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
        if (repro::classify(kb, det_k)) kb = fill_k;
        if (repro::classify(vb, det_v)) vb = fill_v;
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
                   const int* det_v, unsigned int fill_k, unsigned int fill_v,
                   int* tiles, int* counts, cudaStream_t stream) {
  using bits_t = typename Storage<DT>::bits_t;
  const Detector dk = repro::detector_from(det_k);
  const Detector dv = repro::detector_from(det_v);
  const int nk = T / bk, nq = S / bq;
  // live logical K/V tiles form a prefix: kj*bk <= S - 1 when causal
  const int s_tiles = (S + bk - 1) / bk;
  const int n_live = causal && s_tiles < nk ? s_tiles : nk;
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
  cudaError_t err = repro::allow_smem((const void*)flash_repair_fwd<DT, D>, smem);
  if (err != cudaSuccess) return err;
  if (S > 0 && B * H > 0)
    flash_repair_fwd<DT, D><<<dim3((S + BQ - 1) / BQ, H, B), kThreads, smem,
                              stream>>>(
        static_cast<const bits_t*>(q), static_cast<const bits_t*>(k),
        static_cast<const bits_t*>(v), static_cast<bits_t*>(out), H, Kh, S, T,
        causal, sm_scale, dk, dv, (bits_t)fill_k, (bits_t)fill_v);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* out, int B, int H, int Kh, int S, int T, int bq,
                     int bk, int causal, float sm_scale, const int* det_k,
                     const int* det_v, unsigned int fill_k,
                     unsigned int fill_v, int* tiles, int* counts,
                     cudaStream_t s) {
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

}  // namespace

// q (B, H, S, D), k/v (B, Kh, T, D), out (B, H, S, D), all in `dtype`
// (0 f32, 1 bf16, 2 f16) and contiguous on the device; D is 64 or 128;
// (bq, bk) the logical blocks, which must divide (S, T); sm_scale
// 1/sqrt(D) rounded once from double; det_k/det_v host int32[8];
// fill_k/fill_v the repaired lanes' bit patterns; tiles int32[4 * B * Kh *
// (T / bk)] zeroed scratch; counts int32[8] out.  Returns
// cudaGetLastError() after the launches.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int H, int Kh, int S, int T, int D, int bq, int bk, int causal,
    float sm_scale, const int* det_k, const int* det_v, unsigned int fill_k,
    unsigned int fill_v, int* tiles, int* counts, void* stream) {
  if (Kh < 1 || H % Kh || bq < 1 || bk < 1 || S % bq || T % bk || T < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
