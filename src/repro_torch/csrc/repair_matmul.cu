// C = repair(A) @ repair(B) with f32 accumulation and the MM event counts:
// the paper's register-repairing mechanism fused into the operand load.
//
// Replaces src/repro/kernels/repair_matmul.py::_mm_kernel (:60, behind
// `repair_matmul_raw`).  Every lane of an A or B tile is classified against
// its operand's detector as it is loaded into shared memory; a fatal lane
// takes the fill (bit pattern precomputed by the host in the operand's
// storage dtype) before it reaches the product.  The stored operands are
// never written: the memory-mode origin scrub is a separate call
// (kernels/ops.py).
//
// Arithmetic: operands are widened to f32 in shared memory and multiplied
// with FFMA, no TF32 and no tensor cores, so a bf16 x bf16 product is exact
// and f32 parity with the plain version holds to summation order.  C is
// written in the output dtype (round to nearest even).
//
// Tiling: a classic 128 x 128 output tile per block with a k step of 8,
// 256 threads, an 8 x 8 register micro-tile per thread (rows ty*4+i and
// ty*4+64+i, columns likewise, so the shared-memory reads are float4 and
// conflict-free).  Edges are guarded, so any M, N, K works.
//
// Counts: defined on the reference's logical (bm, bn, bk) grid, not on this
// physical one.  Each A lane is loaded by every block of its row band; the
// blocks of physical column 0 load each A lane exactly once, so they alone
// count A, adding NaN/Inf lanes into per-logical-tile counters with integer
// atomics on fatal lanes only.  The blocks of physical row 0 count B.  A
// one-block epilogue turns the per-tile counters into the seven MM counts
// by the closed forms (nj x A lanes, ni x B lanes, and
// ev_total = sum_k FA_k*nj + FB_k*ni - FA_k*FB_k).
//
// What bounds it on an H100: operations.  2*M*N*K flops against the bf16
// tensor-core peak (989 TFLOP/s) is the floor; this first form runs on the
// FP32 pipe (67 TFLOP/s) and is expected to lose to cuBLAS by an order of
// magnitude.  wgmma with TMA-fed shared-memory rings is the later redesign.
#include "repair.cuh"

namespace {

using repro::Detector;
using repro::Storage;

constexpr int BM = 128, BN = 128, BK = 8, kThreads = 256;

__device__ __forceinline__ void count_lane(int* tiles, long long t, int cls) {
  if (cls & 1) atomicAdd(&tiles[2 * t], 1);
  if (cls >> 1) atomicAdd(&tiles[2 * t + 1], 1);
}

__device__ __forceinline__ void store_out(void* C, int dt, long long i,
                                          float v) {
  if (dt == repro::DT_F32)
    static_cast<float*>(C)[i] = v;
  else if (dt == repro::DT_BF16)
    static_cast<uint16_t*>(C)[i] = Storage<repro::DT_BF16>::from_float(v);
  else
    static_cast<uint16_t*>(C)[i] = Storage<repro::DT_F16>::from_float(v);
}

template <int DA, int DB>
__global__ void __launch_bounds__(kThreads)
    repair_mm_tiles(const typename Storage<DA>::bits_t* __restrict__ A,
                    const typename Storage<DB>::bits_t* __restrict__ B,
                    void* C, int out_dt, int M, int N, int K, int bm, int bn,
                    int bk, Detector det_a, Detector det_b, uint32_t fill_a,
                    uint32_t fill_b, int* tiles_a, int* tiles_b) {
  __shared__ __align__(16) float As[BK][BM];  // A tile, transposed: [k][m]
  __shared__ __align__(16) float Bs[BK][BN];  // B tile: [k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool count_a = blockIdx.x == 0, count_b = blockIdx.y == 0;
  const int nk_log = K / bk, nj_log = N / bn;
  // loader lanes: A 128 rows x 8 columns, B 8 rows x 128 columns, 4 each
  const int a_r = tid >> 1, a_c = (tid & 1) * 4;
  const int b_r = tid >> 5, b_c = (tid & 31) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      const int r = m0 + a_r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + a_c + j;
        float val = 0.f;
        if (r < M && c < K) {
          uint32_t bits = A[(long long)r * K + c];
          const int cls = repro::classify(bits, det_a);
          if (cls) {
            bits = fill_a;
            if (count_a)
              count_lane(tiles_a, (long long)(r / bm) * nk_log + c / bk, cls);
          }
          val = Storage<DA>::to_float(bits);
        }
        As[a_c + j][a_r] = val;
      }
    }
    {
      const int r = k0 + b_r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + b_c + j;
        float val = 0.f;
        if (r < K && c < N) {
          uint32_t bits = B[(long long)r * N + c];
          const int cls = repro::classify(bits, det_b);
          if (cls) {
            bits = fill_b;
            if (count_b)
              count_lane(tiles_b, (long long)(r / bk) * nj_log + c / bn, cls);
          }
          val = Storage<DB>::to_float(bits);
        }
        Bs[b_r][b_c + j] = val;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4 + 64]);
      const float ra[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float rb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty * 4 + (i & 3) + (i >> 2) * 64;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + tx * 4 + (j & 3) + (j >> 2) * 64;
      if (c < N) store_out(C, out_dt, (long long)r * N + c, acc[i][j]);
    }
  }
}

// counts[0..7] from the per-logical-tile [nan, inf] pairs of A (ni x nk)
// and B (nk x nj).
__global__ void repair_mm_counts(const int* tiles_a, const int* tiles_b,
                                 int ni, int nj, int nk, int* counts) {
  __shared__ unsigned long long acc[7];
  if (threadIdx.x < 7) acc[threadIdx.x] = 0ull;
  __syncthreads();
  long long v[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int k = threadIdx.x; k < nk; k += blockDim.x) {
    long long fa = 0, fb = 0;
    for (int i = 0; i < ni; ++i) {
      const int* t = tiles_a + 2 * ((long long)i * nk + k);
      v[0] += t[0];
      v[1] += t[1];
      fa += (t[0] + t[1]) > 0;
    }
    for (int j = 0; j < nj; ++j) {
      const int* t = tiles_b + 2 * ((long long)k * nj + j);
      v[3] += t[0];
      v[4] += t[1];
      fb += (t[0] + t[1]) > 0;
    }
    v[2] += fa;
    v[5] += fb;
    v[6] += fa * nj + fb * ni - fa * fb;
  }
  v[0] *= nj;
  v[1] *= nj;
  v[2] *= nj;
  v[3] *= ni;
  v[4] *= ni;
  v[5] *= ni;
  for (int s = 0; s < 7; ++s)
    if (v[s]) atomicAdd(&acc[s], (unsigned long long)v[s]);
  __syncthreads();
  if (threadIdx.x < 7) counts[threadIdx.x] = (int)acc[threadIdx.x];
  if (threadIdx.x == 7) counts[7] = 0;
}

template <int DA, int DB>
cudaError_t launch(const void* a, const void* b, void* c, int out_dt, int M,
                   int N, int K, int bm, int bn, int bk, const int* det_a,
                   const int* det_b, unsigned int fill_a, unsigned int fill_b,
                   int* tiles_a, int* tiles_b, int* counts,
                   cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (M > 0 && N > 0)
    repair_mm_tiles<DA, DB><<<grid, kThreads, 0, stream>>>(
        static_cast<const typename Storage<DA>::bits_t*>(a),
        static_cast<const typename Storage<DB>::bits_t*>(b), c, out_dt, M, N,
        K, bm, bn, bk, repro::detector_from(det_a),
        repro::detector_from(det_b), fill_a, fill_b, tiles_a, tiles_b);
  repair_mm_counts<<<1, 256, 0, stream>>>(tiles_a, tiles_b, M / bm, N / bn,
                                          K / bk, counts);
  return cudaGetLastError();
}

template <int DA>
cudaError_t launch_b(int dt_b, const void* a, const void* b, void* c,
                     int out_dt, int M, int N, int K, int bm, int bn, int bk,
                     const int* det_a, const int* det_b, unsigned int fill_a,
                     unsigned int fill_b, int* tiles_a, int* tiles_b,
                     int* counts, cudaStream_t s) {
  switch (dt_b) {
    case repro::DT_F32:
      return launch<DA, repro::DT_F32>(a, b, c, out_dt, M, N, K, bm, bn, bk,
                                       det_a, det_b, fill_a, fill_b, tiles_a,
                                       tiles_b, counts, s);
    case repro::DT_BF16:
      return launch<DA, repro::DT_BF16>(a, b, c, out_dt, M, N, K, bm, bn, bk,
                                        det_a, det_b, fill_a, fill_b, tiles_a,
                                        tiles_b, counts, s);
    case repro::DT_F16:
      return launch<DA, repro::DT_F16>(a, b, c, out_dt, M, N, K, bm, bn, bk,
                                       det_a, det_b, fill_a, fill_b, tiles_a,
                                       tiles_b, counts, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// a (M, K), b (K, N) row-major on the device in dtypes dt_a / dt_b, c (M, N)
// in out_dt (0 f32, 1 bf16, 2 f16); (bm, bn, bk) the logical blocks, which
// must divide (M, N, K); det_a/det_b host int32[8]; fill_a/fill_b the
// repaired lanes' bit patterns; tiles_a int32[2 * ni * nk] and tiles_b
// int32[2 * nk * nj] zeroed scratch; counts int32[8] out.  Returns
// cudaGetLastError() after the launches.
extern "C" int repro_repair_matmul(const void* a, const void* b, void* c,
                                   int dt_a, int dt_b, int out_dt, int M,
                                   int N, int K, int bm, int bn, int bk,
                                   const int* det_a, const int* det_b,
                                   unsigned int fill_a, unsigned int fill_b,
                                   int* tiles_a, int* tiles_b, int* counts,
                                   void* stream) {
  if (bm < 1 || bn < 1 || bk < 1 || M % bm || N % bn || K % bk ||
      out_dt < 0 || out_dt > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dt_a) {
    case repro::DT_F32:
      return (int)launch_b<repro::DT_F32>(dt_b, a, b, c, out_dt, M, N, K, bm,
                                          bn, bk, det_a, det_b, fill_a, fill_b,
                                          tiles_a, tiles_b, counts, s);
    case repro::DT_BF16:
      return (int)launch_b<repro::DT_BF16>(dt_b, a, b, c, out_dt, M, N, K, bm,
                                           bn, bk, det_a, det_b, fill_a,
                                           fill_b, tiles_a, tiles_b, counts, s);
    case repro::DT_F16:
      return (int)launch_b<repro::DT_F16>(dt_b, a, b, c, out_dt, M, N, K, bm,
                                          bn, bk, det_a, det_b, fill_a, fill_b,
                                          tiles_a, tiles_b, counts, s);
  }
  return (int)cudaErrorInvalidValue;
}
