// What the paged attention kernels share (paged_decode.cu,
// paged_prefill.cu): lane helpers for 16- and 32-bit storage, and
// `page_scan`, which classifies every (b, j) page visit once.
//
// page_scan: one block per (b, j) slot of the block table reads the slot's
// whole (pg, Kh, Dh) K and V tiles at `layer` once, each lane once, up to
// VECS 16-byte vectors of each in flight per thread, coalesced; the lanes
// before a tile's first 16-byte boundary and after its last whole vector
// (an offset pool view, a tile that is not a whole number of vectors) are
// read one by one.  A block's reads are held by the bytes it can keep in
// flight: StableLM-1.6B's f32 slot (256 KiB) takes 6-7 us at 512 threads
// and at 1024 alike; cutting a slot over several blocks, whose sums the
// last one to finish reads back, gained ~0.2 us there and cost the
// one-block scans ~10 % (scripts/paged_f32_routes.py).  A vector passes the exponent-floor prefilter unless it
// may hold a fatal lane; only suspect vectors are classified.  It writes
// slot_counts[b, j] (the visit's fatal-lane total over every KV head), the
// slot's flags [K, V] (bit 0: the tile holds a fatal lane; bit 1 of V: the
// V tile stays non-finite after the repair, through a lane the V detector
// lets through or a non-finite fill) and adds the AT counts and, per
// request, poison_end (one past its last slot with V bit 1) into buffers
// the launcher zeroes first.  So the main kernels, which each read only
// some KV heads or some slots of a visit, take a visit's events from here
// and repair only flagged pages.  The plain twin is
// kernels/paged_attention.py::prefill_scan_plain.
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace {  // each library its own copy
namespace paged {

using repro::Detector;
using repro::Storage;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;  // NaN wins, as torch.maximum's
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_fsum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// The 16 / size lanes of a 16-byte chunk as f32.
template <int DT>
__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (DT == repro::DT_F32) {
      f[i] = __uint_as_float(w[i]);
    } else if constexpr (DT == repro::DT_BF16) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    } else {
      const float2 h = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = h.x;
      f[2 * i + 1] = h.y;
    }
  }
}

// N consecutive lanes (N * size = 4, 8 or 16 bytes, aligned) as f32.
template <int DT, int N>
__device__ __forceinline__ void load_lanes(const uint8_t* ptr, float* f) {
  constexpr int WORDS = N * (DT == repro::DT_F32 ? 4 : 2) / 4;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if constexpr (WORDS == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(ptr);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (WORDS == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(ptr);
    w[0] = v.x, w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(ptr);
  }
#pragma unroll
  for (int i = 0; i < WORDS; ++i) {
    if constexpr (DT == repro::DT_F32) {
      f[i] = __uint_as_float(w[i]);
    } else if constexpr (DT == repro::DT_BF16) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    } else {
      const float2 h = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = h.x;
      f[2 * i + 1] = h.y;
    }
  }
}

// Four f32 values in the storage dtype (round to nearest even, as the
// plain version's cast), stored at `ptr` (aligned to their size).
template <int DT>
__device__ __forceinline__ void store4(uint8_t* ptr, const float4& v) {
  if constexpr (DT == repro::DT_F32) {
    *reinterpret_cast<float4*>(ptr) = v;
  } else {
    using S = Storage<DT>;
    *reinterpret_cast<uint2*>(ptr) = make_uint2(
        (uint32_t)S::from_float(v.x) | ((uint32_t)S::from_float(v.y) << 16),
        (uint32_t)S::from_float(v.z) | ((uint32_t)S::from_float(v.w) << 16));
  }
}

// Whether a 16-byte chunk of ES-byte lanes may hold a fatal lane: its
// largest exponent field against the detector's floor (hopper.cuh's
// prefilter, for 32-bit lanes too).
template <int ES>
__device__ __forceinline__ bool suspect(const uint4& v, uint32_t exp_mask,
                                        uint32_t floor) {
  if constexpr (ES == 4) {
    const uint32_t m = max(max(v.x & exp_mask, v.y & exp_mask),
                           max(v.z & exp_mask, v.w & exp_mask));
    return m >= floor;
  } else {
    return hopper::may_be_fatal(v, exp_mask, floor);
  }
}

// Lane e of a 16-byte chunk of ES-byte lanes, zero-extended.
template <int ES>
__device__ __forceinline__ uint32_t lane_of(const uint32_t (&w)[4], int e) {
  if constexpr (ES == 4) return w[e];
  return (w[e >> 1] >> ((e & 1) * 16)) & 0xFFFFu;
}

// Repairs the fatal lanes of a suspect chunk in place; returns its NaN
// lanes | Inf lanes << 16 (out of line: clean data never calls it).
template <int ES>
__device__ __noinline__ int repair_vec(uint4* chunk, const Detector det,
                                       uint32_t fill) {
  const uint4 v = *chunk;
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
  int n_nan = 0, n_inf = 0;
  constexpr int LANES = 16 / ES;
#pragma unroll
  for (int e = 0; e < LANES; ++e) {
    const int i = ES == 4 ? e : e >> 1;
    const int sh = ES == 4 ? 0 : (e & 1) * 16;
    const uint32_t lane_mask = ES == 4 ? 0xFFFFFFFFu : 0xFFFFu;
    const int c = repro::classify((w[i] >> sh) & lane_mask, det);
    n_nan += c & 1;
    n_inf += c >> 1;
    if (c) w[i] = (w[i] & ~(lane_mask << sh)) | (fill << sh);
  }
  if (n_nan | n_inf) *chunk = make_uint4(w[0], w[1], w[2], w[3]);
  return n_nan | (n_inf << 16);
}

// 16 bytes from device memory into shared memory by the load/store unit,
// cached in L2 only (cp.async; many in flight a thread, no registers held).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Waits for every cp.async this thread issued (the block then syncs).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// ------------------------------------------------------------- page_scan

// The scan's view of one call: every (b, j) slot's (pg, Kh, Dh) K and V
// tiles at `layer`, `lanes` lanes of ES bytes each.
struct PageScan {
  const uint8_t* k;
  const uint8_t* v;
  const int* bt;        // (B * M) page ids
  int M, L, layer;
  long long lanes;      // pg * Kh * Dh
  Detector det_k, det_v;
  uint32_t floor_k, floor_v;  // fatal_floor of each detector
  uint32_t ieee_exp;    // the storage dtype's exponent field
  bool fill_v_finite;   // whether the V fill is a finite value
  const uint32_t* fills_v;  // neighbor_mean: the V fill per page, else null
  int* slot_counts;     // (B * M)
  int* flags;           // (B * M, 2)
  int* counts;          // int32[8], zeroed before the launch
  int* poison_end;      // (B,), zeroed before the launch
};

// Threads a block and vectors of each operand in flight a thread: 16-bit
// pools keep the wgmma route's (256, 2); f32 tiles are twice the bytes and
// StableLM-1.6B's is 128 KiB, so more in flight.
template <int ES>
struct ScanShape {
  static constexpr int THREADS = ES == 4 ? 512 : 256;
  static constexpr int VECS = ES == 4 ? 4 : 2;
};

// NaN lanes | Inf lanes << 16 of a suspect vector (out of line: clean data
// never calls it).
template <int ES>
__device__ __noinline__ int count_vec(const uint4 q, const Detector det) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  int n_nan = 0, n_inf = 0;
#pragma unroll
  for (int e = 0; e < 16 / ES; ++e) {
    const int cls = repro::classify(lane_of<ES>(w, e), det);
    n_nan += cls & 1;
    n_inf += cls >> 1;
  }
  return n_nan | (n_inf << 16);
}

// Whether a lane is non-finite and `det` does not repair it.
__device__ __forceinline__ bool kept_lane(uint32_t b, uint32_t ieee_exp,
                                          const Detector& det) {
  return (b & ieee_exp) == ieee_exp && repro::classify(b, det) == 0;
}

// Whether a vector holds a non-finite lane that `det` does not repair
// (out of line, as count_vec).
template <int ES>
__device__ __noinline__ bool keeps_nonfinite(const uint4 q, uint32_t ieee_exp,
                                             const Detector det) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  bool any = false;
#pragma unroll
  for (int e = 0; e < 16 / ES; ++e) any |= kept_lane(lane_of<ES>(w, e), ieee_exp, det);
  return any;
}

// Lanes of a tile before its first 16-byte boundary (a tile starts on a
// lane boundary).
template <int ES>
__device__ __forceinline__ int head_lanes(const uint8_t* tile, long long lanes) {
  const int mis = (int)(reinterpret_cast<uintptr_t>(tile) & 15);
  return (int)min((long long)(mis ? (16 - mis) / ES : 0), lanes);
}

// One block per (b, j) slot (see the header).
template <int ES>
__global__ void __launch_bounds__(ScanShape<ES>::THREADS)
    page_scan(const PageScan s) {
  constexpr int THREADS = ScanShape<ES>::THREADS, VECS = ScanShape<ES>::VECS;
  constexpr int LPV = 16 / ES;  // lanes a vector
  __shared__ int cnt[5];
  if (threadIdx.x < 5) cnt[threadIdx.x] = 0;
  __syncthreads();
  const int slot = blockIdx.x;
  const long long off = ((long long)s.bt[slot] * s.L + s.layer) * s.lanes * ES;
  const uint8_t* k = s.k + off;
  const uint8_t* v = s.v + off;
  const int hk = head_lanes<ES>(k, s.lanes), hv = head_lanes<ES>(v, s.lanes);
  // 32-bit vector indices (a tile is under 2^32 lanes: scan_shape_ok)
  const unsigned nvk = (unsigned)((s.lanes - hk) / LPV),
                 nvv = (unsigned)((s.lanes - hv) / LPV);
  const uint4* k4 = reinterpret_cast<const uint4*>(k + hk * ES);
  const uint4* v4 = reinterpret_cast<const uint4*>(v + hv * ES);
  int nk = 0, ik = 0, nv = 0, iv = 0, kept = 0;
  const unsigned nvec = max(nvk, nvv);
  for (unsigned v0 = 0; v0 < nvec; v0 += THREADS * VECS) {
    uint4 qk[VECS], qv[VECS];
#pragma unroll
    for (int i = 0; i < VECS; ++i) {
      const unsigned vi = v0 + threadIdx.x + i * THREADS;
      if (vi < nvk) qk[i] = __ldg(k4 + vi);
      if (vi < nvv) qv[i] = __ldg(v4 + vi);
    }
#pragma unroll
    for (int i = 0; i < VECS; ++i) {
      const unsigned vi = v0 + threadIdx.x + i * THREADS;
      if (vi < nvk && suspect<ES>(qk[i], s.det_k.exp_mask, s.floor_k)) {
        const int c = count_vec<ES>(qk[i], s.det_k);
        nk += c & 0xFFFF;
        ik += c >> 16;
      }
      if (vi < nvv) {
        if (suspect<ES>(qv[i], s.det_v.exp_mask, s.floor_v)) {
          const int c = count_vec<ES>(qv[i], s.det_v);
          nv += c & 0xFFFF;
          iv += c >> 16;
        }
        if (suspect<ES>(qv[i], s.ieee_exp, s.ieee_exp))
          kept |= keeps_nonfinite<ES>(qv[i], s.ieee_exp, s.det_v);
      }
    }
  }
  // the lanes outside whole vectors: each operand's head, then its tail
  using bits_t = typename std::conditional<ES == 4, uint32_t, uint16_t>::type;
  for (int e = threadIdx.x; e < 4 * LPV; e += THREADS) {
    const bool is_v = e >= 2 * LPV;
    const int u = is_v ? e - 2 * LPV : e;
    const int h = is_v ? hv : hk;
    const long long tail = h + (is_v ? nvv : nvk) * LPV;
    const long long lane = u < LPV ? (u < h ? u : -1) : tail + (u - LPV);
    if (lane < 0 || lane >= s.lanes) continue;
    const uint32_t b =
        reinterpret_cast<const bits_t*>(is_v ? v : k)[lane];
    const int c = repro::classify(b, is_v ? s.det_v : s.det_k);
    if (is_v) {
      nv += c & 1;
      iv += c >> 1;
      kept |= kept_lane(b, s.ieee_exp, s.det_v);
    } else {
      nk += c & 1;
      ik += c >> 1;
    }
  }
  repro::block_add(&cnt[0], nk);
  repro::block_add(&cnt[1], ik);
  repro::block_add(&cnt[2], nv);
  repro::block_add(&cnt[3], iv);
  repro::block_add(&cnt[4], kept);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int* c = cnt;
    const int fk = c[0] + c[1], fv = c[2] + c[3];
    // with a table the V fill, and whether it is finite, is the page's
    // (an f32 sum of large 16-bit lanes can overflow to Inf)
    const bool fill_finite =
        s.fills_v ? (__ldg(s.fills_v + s.bt[slot]) & s.ieee_exp) != s.ieee_exp
                  : s.fill_v_finite;
    const bool poison = c[4] > 0 || (fv > 0 && !fill_finite);
    s.slot_counts[slot] = fk + fv;
    s.flags[2 * slot] = fk > 0;
    s.flags[2 * slot + 1] = (fv > 0) | (poison << 1);
    if (poison) atomicMax(&s.poison_end[slot / s.M], slot % s.M + 1);
    if (c[0]) atomicAdd(&s.counts[0], c[0]);
    if (c[1]) atomicAdd(&s.counts[1], c[1]);
    if (fk) atomicAdd(&s.counts[2], 1);
    if (c[2]) atomicAdd(&s.counts[3], c[2]);
    if (c[3]) atomicAdd(&s.counts[4], c[3]);
    if (fv) atomicAdd(&s.counts[5], 1);
    if (fk || fv) atomicAdd(&s.counts[6], 1);
  }
}

// Whether the scan takes a pool (any dtype and view, a tile under 2^32
// lanes; offsets in 64 bits).
inline bool scan_shape_ok(int dt, int B, int M, long long P, int L, int pg,
                          int Kh, int Dh, int layer) {
  return dt >= repro::DT_F32 && dt <= repro::DT_F16 && B > 0 && M > 0 &&
         P > 0 && L > 0 && pg > 0 && Kh > 0 && Dh > 0 && layer >= 0 &&
         layer < L && (long long)pg * Kh * Dh < (1ll << 32);
}

// Zeroes `counts` (int32[8 + B]: the AT counts, then poison_end) on the
// stream and launches the scan.
inline cudaError_t launch_scan(const void* kp, const void* vp, const int* bt,
                               int dt, int B, int M, int L, int pg, int Kh,
                               int Dh, int layer, const int* det_k,
                               const int* det_v, unsigned fill_v,
                               const unsigned* fills_v, int* slot_counts,
                               int* flags, int* counts, cudaStream_t stream) {
  cudaError_t err =
      cudaMemsetAsync(counts, 0, (8 + (size_t)B) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const Detector dk = repro::detector_from(det_k),
                 dv = repro::detector_from(det_v);
  const uint32_t ieee_exp = dt == repro::DT_F32    ? 0x7F800000u
                            : dt == repro::DT_BF16 ? 0x7F80u
                                                   : 0x7C00u;
  const PageScan s{static_cast<const uint8_t*>(kp),
                   static_cast<const uint8_t*>(vp),
                   bt,
                   M,
                   L,
                   layer,
                   (long long)pg * Kh * Dh,
                   dk,
                   dv,
                   hopper::fatal_floor(dk),
                   hopper::fatal_floor(dv),
                   ieee_exp,
                   (fill_v & ieee_exp) != ieee_exp,
                   fills_v,
                   slot_counts,
                   flags,
                   counts,
                   counts + 8};
  if (dt == repro::DT_F32)
    page_scan<4><<<(unsigned)B * M, ScanShape<4>::THREADS, 0, stream>>>(s);
  else
    page_scan<2><<<(unsigned)B * M, ScanShape<2>::THREADS, 0, stream>>>(s);
  return cudaGetLastError();
}

}  // namespace paged
}  // namespace
