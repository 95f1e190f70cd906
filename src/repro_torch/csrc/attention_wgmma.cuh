// The online-softmax step of the wgmma attention kernels
// (flash_attention.cu, paged_prefill.cu), on one consumer warpgroup's
// fragment: S = Q K^T by wgmma m64n128k16 (both operands K-major in shared
// memory), the mask as selects against two per-row limits, the softmax in
// the log2 domain, P rounded to the operand dtype and fed from registers to
// O += P V by wgmma m64n{D}k16 (V MN-major through the transposed-B bit).
// A K or V tile is 128 rows in D / 64 boxes of 128 rows x 64 lanes
// (128-byte swizzle), as TMA writes it; so is a Q tile.  sm_90a only.
#pragma once

#include "hopper.cuh"

namespace attn {

using namespace hopper;

constexpr int BKV = 128;               // keys of a K/V tile
constexpr int BOX_BYTES = 128 * 128;   // one box: 128 rows of 64 lanes

#define REPRO_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63}"
#define REPRO_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define REPRO_ACC64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
  "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define REPRO_ACC32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31])

// S(64 x 128) = Q(64 x 16, K-major) . K(128 x 16, K-major)^T, added to S
// unless `accumulate` is 0.
template <int DT>
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t desc_q,
                                         uint64_t desc_k, int accumulate) {
#define REPRO_WGMMA_QK(TY)                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
               REPRO_D64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"                  \
               : REPRO_ACC64(d)                                              \
               : "l"(desc_q), "l"(desc_k), "r"(accumulate))
  if constexpr (DT == repro::DT_BF16)
    REPRO_WGMMA_QK("bf16");
  else
    REPRO_WGMMA_QK("f16");
#undef REPRO_WGMMA_QK
}

// O(64 x D) += P(64 x 16, four registers a thread) . V(16 x D, MN-major).
template <int DT>
__device__ __forceinline__ void wgmma_pv(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t desc_v) {
#define REPRO_WGMMA_PV128(TY)                                                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
               REPRO_D64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"    \
               : REPRO_ACC64(d)                                              \
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_v), "r"(1))
  if constexpr (DT == repro::DT_BF16)
    REPRO_WGMMA_PV128("bf16");
  else
    REPRO_WGMMA_PV128("f16");
#undef REPRO_WGMMA_PV128
}

template <int DT>
__device__ __forceinline__ void wgmma_pv(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t desc_v) {
#define REPRO_WGMMA_PV64(TY)                                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "   \
               REPRO_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"    \
               : REPRO_ACC32(d)                                              \
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_v), "r"(1))
  if constexpr (DT == repro::DT_BF16)
    REPRO_WGMMA_PV64("bf16");
  else
    REPRO_WGMMA_PV64("f16");
#undef REPRO_WGMMA_PV64
}

// Two f32 values rounded (to nearest even) into one register of the
// operand dtype, `lo` in the low half.
template <int DT>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (DT == repro::DT_BF16) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The accumulator layout of m64nNk16: warp w of the warpgroup holds rows
// 16w + lane/4 and 16w + lane/4 + 8; d[4j..4j+3] are columns 8j + 2*(lane%4)
// (+1), the second pair on the row + 8.

// S = Q K^T for one warpgroup: q_base its 64 Q rows, k_base the K tile.
template <int DT, int D>
__device__ __forceinline__ void qk_tile(float (&sc)[64], uint32_t q_base,
                                        uint32_t k_base) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * BOX_BYTES + (kk & 3) * 32;
    wgmma_qk<DT>(sc, sw128_desc(q_base + off, 16, 1024),
                 sw128_desc(k_base + off, 16, 1024), kk);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
}

// Scores at -1e30 from each row's limit on: lim0 (the thread's first row)
// and lim1 (its row + 8) count columns from the thread's first column, so
// the test is against a constant per lane, as selects (a branch per element
// cost most of a step).
__device__ __forceinline__ void mask_tile(float (&sc)[64], int lim0, int lim1) {
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[4 * j + e] = 8 * j + (e & 1) >= ((e >> 1) ? lim1 : lim0)
                          ? repro::NEG_INF
                          : sc[4 * j + e];
}

// One tile of the online softmax in the log2 domain: m is the running max
// of s * scale_log2, p = 2^(s * scale_log2 - m) by one FFMA and ex2; l and
// O are rescaled, and P goes out rounded to the operand dtype as the A
// registers of P . V (k-step t takes n-blocks 2t and 2t+1 of the scores).
template <int DT, int D>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&o)[D / 2],
                                             float scale_log2,
                                             uint32_t (&pa)[32]) {
  float mx[2] = {repro::NEG_INF, repro::NEG_INF};
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  float alpha[2], neg_m[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m_new = fmaxf(m[i], quad_max(mx[i]) * scale_log2);
    alpha[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    neg_m[i] = -m_new;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sc[i] = ex2(fmaf(sc[i], scale_log2, neg_m[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) pa[i] = pack2<DT>(sc[2 * i], sc[2 * i + 1]);
}

// O += P V over the tile's first `nt` 16-key steps (the rest of P is 0 and
// their V rows are never read).
template <int DT, int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 2],
                                        const uint32_t (&pa)[32],
                                        uint32_t v_base, int nt) {
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < BKV / 16; ++t)
    if (t < nt)
      wgmma_pv<DT>(o, pa[4 * t], pa[4 * t + 1], pa[4 * t + 2], pa[4 * t + 3],
                   sw128_desc(v_base + t * 16 * 128, BOX_BYTES, 1024));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

}  // namespace attn
