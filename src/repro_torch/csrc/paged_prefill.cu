// Chunked-q causal prefill against the paged pool, with fused on-read
// repair.
//
// Replaces src/repro/kernels/paged_attention.py::_paged_prefill_kernel
// (:362, behind `paged_prefill_raw`).  The chunk's q rows (B, C, H, Dh) are
// flattened to R = C * H rows in (C, Kh, G) order; row r sits at context
// position q_start[b] + r / H and reads keys at positions <= that.  The
// kernel emits unnormalised partials (acc (B, C, H, Dh), m and l (B, C*H),
// f32); the wrapper normalises them, as the reference does outside its
// kernel (`_prefill_normalize`).
// The TPU walked one request's whole chunk per grid step.  Here a block
// takes kRows rows of one request and walks all M page slots of its block
// table, so a long chunk spreads over many SMs.  Each block repairs the
// pages it reads into its own shared memory (the same fill on every copy);
// only the request's first row block reports the page visit, so slot_counts
// and the AT counts keep the reference's one-visit-per-(b, j) definition.
// What bounds it on an H100: at serving chunk sizes (C <= 128) the score and
// value products are small (4 * R * pg * Dh flops per page), so it is
// latency and the per-block re-read of each page from L2; the floor is the
// bytes of q, the visited pages and the outputs over 3.35 TB/s.  K rows are
// padded in shared memory against bank conflicts; tensor cores are not used.
#include "repair.cuh"

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
    float sm_scale, Detector det_k, Detector det_v,
    typename Storage<DT>::bits_t fill_k, typename Storage<DT>::bits_t fill_v,
    float* acc_out, float* m_out, float* l_out, int* slot_counts,
    int* counts) {
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
    repro::repair_tile<DT>(kp + base, rows, Dh, ks, det_k, fill_k, k_s, &cnt[0]);
    repro::repair_tile<DT>(vp + base, rows, Dh, Dh, det_v, fill_v, v_s, &cnt[2]);
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
                   const int* det_k, const int* det_v, unsigned int fill_k,
                   unsigned int fill_v, float* acc, float* m, float* l,
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
      (bits_t)fill_k, (bits_t)fill_v, acc, m, l, slot_counts, counts);
  return cudaGetLastError();
}

}  // namespace

// q (B, C, H, Dh) and pages (P, L, pg, Kh, Dh) in `dtype` (0 f32, 1 bf16,
// 2 f16); bt (B, M), q_start (B,) int32 on the device; det_k/det_v host
// int32[8]; fill_k/fill_v the repaired lanes' bit patterns.  Outputs acc
// (B, C, H, Dh), m/l (B, C*H) f32, slot_counts (B, M) int32, counts
// int32[8] (zeroed by the caller).  Returns cudaGetLastError().
extern "C" int repro_paged_prefill(
    const void* q, const void* kp, const void* vp, const int* bt,
    const int* q_start, int dtype, int B, int C, int H, int Dh, int L, int pg,
    int Kh, int M, int layer, const int* det_k, const int* det_v,
    unsigned int fill_k, unsigned int fill_v, float* acc, float* m, float* l,
    int* slot_counts, int* counts, void* stream) {
  if (H % Kh != 0 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
