// Hopper building blocks shared by the wgmma kernels (repair_matmul.cu,
// flash_attention.cu, paged_prefill.cu) and the fused paged decode
// (paged_decode.cu): shared-memory addresses, mbarriers, TMA and bulk
// loads, tensor maps, wgmma shared-memory descriptors, the in-smem chunk
// repair of a flagged tile, and the fault scan's exponent-floor prefilter.
// sm_90a only (wgmma, setmaxnreg); TMA descriptors come from
// cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint so that
// no library links against libcuda.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time

#include "repair.cuh"

namespace hopper {

using repro::Detector;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A contiguous run of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory by the bulk-copy engine, reported
// to `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major operand: 8-row
// groups 1024 bytes apart (SBO), LBO unused.  MN-major operand: 8-row
// groups of k 1024 bytes apart (SBO), 64-column boxes LBO bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from touching registers across wgmma's async window
// (it sees only the issuing asm as writing them).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Repairs the fatal lanes of one 16-byte chunk (8 lanes) in shared memory;
// only the first `n_in` lanes are in bounds.  Fatal lane e takes
// fill_of(e), called only for a fatal lane: a chunk may span logical tiles.
template <typename FillOf>
__device__ __forceinline__ void repair_chunk_with(uint4* p, int n_in,
                                                  const Detector& det,
                                                  FillOf fill_of) {
  uint4 v = *p;
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
  bool hit = false;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int sh = (e & 1) * 16;
    if (e < n_in && repro::classify((w[e >> 1] >> sh) & 0xFFFFu, det)) {
      w[e >> 1] = (w[e >> 1] & ~(0xFFFFu << sh)) | (fill_of(e) << sh);
      hit = true;
    }
  }
  if (hit) *p = make_uint4(w[0], w[1], w[2], w[3]);
}

// The same with one fill for the whole chunk.
__device__ __forceinline__ void repair_chunk(uint4* p, int n_in,
                                             const Detector& det,
                                             uint32_t fill) {
  repair_chunk_with(p, n_in, det, [fill](int) { return fill; });
}

// Repairs the fatal lanes of one 16-byte chunk of four f32 lanes in shared
// memory, all in bounds: fatal lane e takes fill_of(e).
template <typename FillOf>
__device__ __forceinline__ void repair_chunk32_with(float* p,
                                                   const Detector& det,
                                                   FillOf fill_of) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
  bool hit = false;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (repro::classify(w[e], det)) {
      w[e] = fill_of(e);
      hit = true;
    }
  }
  if (hit) *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// A lane whose exponent field is below this cannot be fatal under `d`
// (NaN and Inf need it all ones, the range guard at least `range`); a
// bit-pattern detector admits any lane.
inline uint32_t fatal_floor(const Detector& d) {
  if (d.flags & repro::FLAG_BITPATTERN) return 0;
  uint32_t t = 0xFFFFFFFFu;
  if (d.flags & (repro::FLAG_NAN | repro::FLAG_INF)) t = d.exp_mask;
  if ((d.flags & repro::FLAG_RANGE) && d.range < t) t = d.range;
  return t;
}

// The cheap test of a clean 16-byte vector of 16-bit lanes: the largest
// exponent field of its 8 lanes against the floor, ~4 integer operations
// per pair of lanes.
__device__ __forceinline__ bool may_be_fatal(const uint4& q, uint32_t exp_mask,
                                             uint32_t floor) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    m = max(m, max(w[i] & exp_mask, (w[i] >> 16) & exp_mask));
  return m >= floor;
}

// The same test for a 16-byte vector of four 32-bit lanes.
__device__ __forceinline__ bool may_be_fatal32(const uint4& q,
                                               uint32_t exp_mask,
                                               uint32_t floor) {
  const uint32_t m = max(max(q.x & exp_mask, q.y & exp_mask),
                         max(q.z & exp_mask, q.w & exp_mask));
  return m >= floor;
}

// A 16-byte cp.async (L2 only) of the first `src_bytes` (0 or 16) of src;
// the rest of the 16 bytes at dst are zeros, so src_bytes 0 reads nothing.
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's committed cp.async groups are
// still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// The driver's tensor-map encoder, fetched through the runtime so that the
// library needs no link against libcuda.
inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A TMA map of a row-major 16-bit tensor of `rank` (2 or 3) dimensions,
// innermost first (dims[0] contiguous), in boxes of `box`; 128-byte
// swizzle, zeros outside the tensor.
inline bool tensor_map_nd(CUtensorMap* map, const void* ptr, int dt, int rank,
                          const long long* dims, const int* box) {
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  cuuint64_t gdims[3], strides[2];
  cuuint32_t gbox[3], elem[3] = {1, 1, 1};
  long long stride = 2;
  for (int i = 0; i < rank; ++i) {
    gdims[i] = (cuuint64_t)dims[i];
    gbox[i] = (cuuint32_t)box[i];
    if (i > 0) strides[i - 1] = (cuuint64_t)stride;
    stride *= dims[i];
  }
  return encode(map,
                dt == repro::DT_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                rank, const_cast<void*>(ptr), gdims, strides, gbox, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (rows, cols) row-major matrix in boxes of (box_rows, box_cols).
inline bool tensor_map(CUtensorMap* map, const void* ptr, int dt, int rows,
                       int cols, int box_rows, int box_cols) {
  const long long dims[2] = {cols, rows};
  const int box[2] = {box_cols, box_rows};
  return tensor_map_nd(map, ptr, dt, 2, dims, box);
}

// A (n, rows, cols) row-major tensor in boxes of (1, box_rows, box_cols):
// a box never crosses from one of the n matrices into the next, and its
// rows past `rows` are zeros.
inline bool tensor_map_3d(CUtensorMap* map, const void* ptr, int dt, int n,
                          int rows, int cols, int box_rows, int box_cols) {
  const long long dims[3] = {cols, rows, n};
  const int box[3] = {box_cols, box_rows, 1};
  return tensor_map_nd(map, ptr, dt, 3, dims, box);
}

}  // namespace hopper
