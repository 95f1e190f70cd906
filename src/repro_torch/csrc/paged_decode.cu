// One-token paged decode attention with fused on-read repair, serial or
// split-K, plus the log-sum-exp merge.
//
// Replaces two Pallas kernels of src/repro/kernels/paged_attention.py:
//   _paged_kernel (:147, `paged_attention_raw`), the serial page walk, and
//   _paged_splitk_kernel (:633, `paged_attention_splitk_raw`) with its
//   merge `_lse_merge` (:131).
// One block walks one (request b, split s) slice of the block table: for
// each page slot j it loads the page's (pg, Kh, Dh) K and V tiles of this
// layer, repairs their fatal lanes into shared memory, counts them (one
// visit covers the whole tile across all KV heads, as on the TPU grid, so
// EV_K/EV_V and slot_counts[b, j] are decided inside the block), and runs
// the online softmax: scores masked to key position <= pos[b], p zeroed
// where the score is <= NEG_INF/2 (the null-tail guard, a no-op for a
// serial walk), p cast to the cache dtype before the value product, f32
// accumulation.  Every split writes its unnormalised (acc, m, l) partial;
// the merge gives a dead partial zero weight.  With splits == 1 the merge is
// exactly the serial flush (weight 1.0, acc / max(l, 1e-30)).
// What bounds it on an H100: bytes, and at the serving shapes latency.  A
// decode step reads each visited page once per layer (2 x 8 KiB in bf16 at
// Qwen2-1.5B width) and does 4 flops per key lane, far below the card's
// ridge point.  With B x splits blocks (16 at B = 4, 4 splits) the kernel
// fills few SMs; the split-K walk exists to raise that number.  K rows sit
// in shared memory with a padded stride so the score loop's lanes fall in
// different banks.  wgmma and TMA are not used: the products are tiny.
#include "repair.cuh"

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
    float sm_scale, Detector det_k, Detector det_v,
    typename Storage<DT>::bits_t fill_k, typename Storage<DT>::bits_t fill_v,
    float* o_part, float* m_part, float* l_part, int* slot_counts,
    int* counts) {
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
    repro::repair_tile<DT>(kp + base, rows, Dh, ks, det_k, fill_k, k_s, &cnt[0]);
    repro::repair_tile<DT>(vp + base, rows, Dh, Dh, det_v, fill_v, v_s, &cnt[2]);
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
                   const int* det_k, const int* det_v, unsigned int fill_k,
                   unsigned int fill_v, float* o_part, float* m_part,
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
      (bits_t)fill_k, (bits_t)fill_v, o_part, m_part, l_part, slot_counts,
      counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lse_merge<DT><<<B, kThreads, 0, stream>>>(o_part, m_part, l_part, splits, H,
                                            Dh, static_cast<bits_t*>(out));
  return cudaGetLastError();
}

}  // namespace

// q (B, H, Dh), pages (P, L, pg, Kh, Dh) in `dtype` (0 f32, 1 bf16, 2 f16);
// bt (B, M) and pos (B,) int32 on the device; det_k/det_v host int32[8];
// fill_k/fill_v the repaired lanes' bit patterns.  Outputs: o_part
// (B, splits, H, Dh), m_part/l_part (B, splits, H) f32 scratch,
// slot_counts (B, M) int32, counts int32[8] (zeroed by the caller), out
// (B, H, Dh) in `dtype`.  Returns cudaGetLastError() after the launches.
extern "C" int repro_paged_decode(
    const void* q, const void* kp, const void* vp, const int* bt,
    const int* pos, int dtype, int B, int H, int Dh, int L, int pg, int Kh,
    int M, int splits, int layer, const int* det_k, const int* det_v,
    unsigned int fill_k, unsigned int fill_v, float* o_part, float* m_part,
    float* l_part, int* slot_counts, int* counts, void* out, void* stream) {
  if (splits < 1 || M % splits != 0 || H % Kh != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
