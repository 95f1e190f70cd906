// Shared on-read repair logic of the Hopper kernels (scrub, paged decode,
// paged prefill).
//
// Detection is data, not code: the detector-constants operand (int32[8],
// layout in repro_torch/core/rules.py) arrives by value as a `Detector`,
// read as uint32 exactly like the reference's masks_from_consts
// (src/repro/kernels/common.py:105).  A 16-bit lane is widened to uint32 by
// zero extension, as the reference's uint16 view does.  A fatal lane takes
// the fill's bit pattern, which the host precomputes in the storage dtype
// (or, for neighbor_mean, tile_fill.cu writes per logical tile), so a
// repaired lane is bit-identical to the plain PyTorch version.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr uint32_t FLAG_NAN = 1, FLAG_INF = 2, FLAG_RANGE = 4,
                   FLAG_BITPATTERN = 8;
constexpr float NEG_INF = -1e30f;  // the reference's mask value, not -inf

enum DType { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

struct Detector {
  uint32_t exp_mask, man_mask, flags, range, bp_mask, bp_value, n_valid, pad;
};

// What a fatal lane takes: `value` in every tile (zero, constant,
// clamp_finite_max), or, with a `table` (neighbor_mean), the entry of the
// lane's logical tile in the table that tile_fill.cu wrote before the
// launch.  The table is read only where a fatal lane is found.
struct Fill {
  const uint32_t* table;
  uint32_t value;
  __device__ __forceinline__ uint32_t at(long long tile) const {
    return table ? __ldg(table + tile) : value;
  }
};

inline Detector detector_from(const int* c) {
  Detector d;
  d.exp_mask = (uint32_t)c[0];
  d.man_mask = (uint32_t)c[1];
  d.flags = (uint32_t)c[2];
  d.range = (uint32_t)c[3];
  d.bp_mask = (uint32_t)c[4];
  d.bp_value = (uint32_t)c[5];
  d.n_valid = (uint32_t)c[6];
  d.pad = (uint32_t)c[7];
  return d;
}

// Bit 0: the lane is in the NaN bucket; bit 1: the Inf bucket.  A custom
// bit pattern with a zero mantissa can sit in both, as in the reference.
__device__ __forceinline__ int classify(uint32_t b, const Detector& d) {
  const bool exp_all = (b & d.exp_mask) == d.exp_mask;
  const bool man_nz = (b & d.man_mask) != 0u;
  bool nan_m = exp_all && man_nz && (d.flags & FLAG_NAN);
  nan_m = nan_m ||
          (((b & d.bp_mask) == d.bp_value) && (d.flags & FLAG_BITPATTERN));
  bool inf_m = exp_all && !man_nz && (d.flags & FLAG_INF);
  inf_m = inf_m || (((b & d.exp_mask) >= d.range) &&
                    (d.flags & FLAG_RANGE) && !nan_m);
  return (nan_m ? 1 : 0) | (inf_m ? 2 : 0);
}

// Storage types: raw bits in, f32 values out, and the cast to the storage
// dtype (round to nearest even) that the reference applies to softmax
// weights before the value product.
template <int DT>
struct Storage;

template <>
struct Storage<DT_F32> {
  using bits_t = uint32_t;
  static __device__ __forceinline__ float to_float(uint32_t b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ bits_t from_float(float f) {
    return __float_as_uint(f);
  }
  static __device__ __forceinline__ float quantize(float f) { return f; }
};

template <>
struct Storage<DT_BF16> {
  using bits_t = uint16_t;
  static __device__ __forceinline__ float to_float(uint32_t b) {
    return __uint_as_float(b << 16);
  }
  static __device__ __forceinline__ bits_t from_float(float f) {
    return __bfloat16_as_ushort(__float2bfloat16(f));
  }
  static __device__ __forceinline__ float quantize(float f) {
    return __bfloat162float(__float2bfloat16(f));
  }
};

template <>
struct Storage<DT_F16> {
  using bits_t = uint16_t;
  static __device__ __forceinline__ float to_float(uint32_t b) {
    return __half2float(__ushort_as_half((unsigned short)b));
  }
  static __device__ __forceinline__ bits_t from_float(float f) {
    return __half_as_ushort(__float2half(f));
  }
  static __device__ __forceinline__ float quantize(float f) {
    return __half2float(__float2half(f));
  }
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Adds `v` into *dst once per warp (dst in shared memory).
__device__ __forceinline__ void block_add(int* dst, int v) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(dst, v);
}

// Repairs one (pg, Kh, Dh) page tile of a pool leaf into shared memory as
// f32 (row stride `stride` floats per (token, kv-head) row of Dh lanes) and
// counts its fatal lanes into cnt[0] (NaN) and cnt[1] (Inf).  The page is
// one logical tile: `page` indexes a fill table.
template <int DT>
__device__ __forceinline__ void repair_tile(
    const typename Storage<DT>::bits_t* src, int rows, int dh, int stride,
    const Detector& det, const Fill& fill, long long page, float* dst,
    int* cnt) {
  int n_nan = 0, n_inf = 0;
  for (int e = threadIdx.x; e < rows * dh; e += blockDim.x) {
    uint32_t b = src[e];
    const int c = classify(b, det);
    n_nan += c & 1;
    n_inf += c >> 1;
    if (c) b = fill.at(page);
    dst[(e / dh) * stride + (e % dh)] = Storage<DT>::to_float(b);
  }
  block_add(&cnt[0], n_nan);
  block_add(&cnt[1], n_inf);
}

inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace repro
