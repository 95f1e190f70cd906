// C = repair(A) @ repair(B) with f32 accumulation and the MM event counts:
// the paper's register-repairing mechanism fused into the operand load.
//
// Replaces src/repro/kernels/repair_matmul.py::_mm_kernel (:60, behind
// `repair_matmul_raw`).  A fatal lane takes the fill (bit pattern
// precomputed by the host in the operand's storage dtype, or for
// neighbor_mean the entry of its logical (bm, bk) / (bk, bn) tile in the
// table that tile_fill.cu wrote) before it reaches the product.  The
// stored operands are never written: the memory-mode origin scrub is a
// separate call (kernels/ops.py).  Two routes, chosen by the wrapper from
// dtypes, shapes and alignment alone (kernels/repair_matmul.py::route):
//
// FFMA route (`repair_mm_tiles`): any dtype mix, any shape.  Every lane of
// an A or B tile is classified against its operand's detector as it is
// loaded into shared memory.  Operands are widened to f32 in shared memory
// and multiplied with FFMA, no TF32 and no tensor cores, so f32 parity with
// the plain version holds to summation order.  A classic 128 x 128 output
// tile per block with a k step of 8, 256 threads, an 8 x 8 register
// micro-tile per thread (rows ty*4+i and ty*4+64+i, columns likewise, so
// the shared-memory reads are float4 and conflict-free).  Bound by
// operations on the FP32 pipe (67 TFLOP/s), it is the exact-f32 path that
// the parity contract requires.  Counts: each A
// lane is loaded by every block of its row band; the blocks of physical
// column 0 load each A lane exactly once, so they alone count A, adding
// NaN/Inf lanes into per-logical-tile counters with integer atomics on
// fatal lanes only.  The blocks of physical row 0 count B.
//
// wgmma route (`repair_mm_scan`, then `repair_mm_wgmma`): A and B both
// bf16 or both f16, K and N multiples of 8, both 16-byte aligned (TMA's
// stride and address rules).  What bounds it on an H100: operations, 2*M*N*K
// flops against the 16-bit tensor-core peak (989 TFLOP/s).  At that rate a
// 128 x 256 x 64 stage is ~1,000 clocks of tensor work on one SM, and
// classifying its 24,576 lanes inside the loop (~10 integer operations
// each on 64 INT32 lanes) would cost about four times that.  So detection
// leaves the main loop:
//   * `repair_mm_scan` reads A and B once (four 16-byte loads in flight a
//     thread), tests each pair of lanes' exponent fields against the
//     detector's floor in ~4 integer operations and classifies only the
//     vectors that pass, adds their fatal lanes into the per-logical-tile
//     counters (each lane exactly once) and raises one flag per physical
//     operand tile of the main kernel (A 128 x 64, B 64 x 256) that holds
//     a fatal lane.  Its floor is bytes: (M*K + K*N) * 2 over 3.35 TB/s.
//   * `repair_mm_wgmma`, persistent (one block per SM walking the 128 x
//     256 output tiles): one producer thread keeps TMA loads of the A tile
//     (128 x 64, K-major) and the B tile (64 x 256 as four 64 x 64 boxes,
//     MN-major: B is (K, N) row-major and reaches wgmma through the
//     transposed-B descriptor) in flight in a ring of 4 shared-memory
//     stages (128-byte swizzle) with full/empty mbarriers, running on into
//     the next tile while the consumers store this one.  Two consumer
//     warpgroups each run wgmma m64n256k16 (f32 accumulators in registers)
//     on their 64 rows of the stage.  A stage whose A or B tile is flagged
//     is repaired in shared memory first, by both consumer warpgroups:
//     every fatal in-bounds lane takes the fill (lanes at or past M, N or
//     K are TMA's zero padding and are never touched), then
//     fence.proxy.async and a named barrier hand the tile to wgmma.
//     Unflagged stages go straight to wgmma, with no integer work at all.
//     C is written from the accumulators with the M and N edges guarded.
// The bf16 x bf16 and f16 x f16 products are exact in f32, so the route
// differs from the plain version only in summation order.
//
// Counts (both routes): defined on the reference's logical (bm, bn, bk)
// grid, not on a physical one.  A one-block epilogue (`repair_mm_counts`)
// turns the per-tile counters into the seven MM counts by the closed forms
// (nj x A lanes, ni x B lanes, and
// ev_total = sum_k FA_k*nj + FB_k*ni - FA_k*FB_k).
#include "hopper.cuh"

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
                    int bk, Detector det_a, Detector det_b, repro::Fill fill_a,
                    repro::Fill fill_b, int* tiles_a, int* tiles_b) {
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
            const long long t = (long long)(r / bm) * nk_log + c / bk;
            bits = fill_a.at(t);
            if (count_a) count_lane(tiles_a, t, cls);
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
            const long long t = (long long)(r / bk) * nj_log + c / bn;
            bits = fill_b.at(t);
            if (count_b) count_lane(tiles_b, t, cls);
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

// ---------------------------------------------------------------- wgmma route
namespace wg {

using namespace hopper;

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4, THREADS = 384;
constexpr int CONSUMER_THREADS = 256;         // warpgroups 0 and 1
constexpr int A_BYTES = BM * BK * 2;          // 16 KB, rows of 128 bytes
constexpr int B_BOX = 64;                     // B columns per TMA box
constexpr int B_BOX_BYTES = BK * B_BOX * 2;   // 8 KB, rows of 128 bytes
constexpr int STAGE_BYTES = A_BYTES + BN / B_BOX * B_BOX_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
// the ring, its 1024-byte alignment slack, the barriers and stage flags
constexpr int SMEM_BYTES = 1024 + RING_BYTES + 2 * STAGES * 8 + STAGES;

// d += A(64 x 16, K-major) * B(16 x 256, MN-major), f32 accumulators.
#define REPRO_WGMMA_M64N256K16(TY)                                            \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
      "%56, %57, %58, %59, %60, %61, %62, %63, "                              \
      "%64, %65, %66, %67, %68, %69, %70, %71, "                              \
      "%72, %73, %74, %75, %76, %77, %78, %79, "                              \
      "%80, %81, %82, %83, %84, %85, %86, %87, "                              \
      "%88, %89, %90, %91, %92, %93, %94, %95, "                              \
      "%96, %97, %98, %99, %100, %101, %102, %103, "                          \
      "%104, %105, %106, %107, %108, %109, %110, %111, "                      \
      "%112, %113, %114, %115, %116, %117, %118, %119, "                      \
      "%120, %121, %122, %123, %124, %125, %126, %127}, "                     \
      "%128, %129, p, 1, 1, 0, 1;\n}\n"                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),      \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),      \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),      \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),      \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),      \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),      \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),      \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),      \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),      \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),      \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),      \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),      \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),      \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),      \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),               \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),               \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),               \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),               \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),               \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),               \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                \
      : "l"(desc_a), "l"(desc_b), "r"(1))

template <int DT>
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t desc_a,
                                          uint64_t desc_b) {
  if constexpr (DT == repro::DT_BF16)
    REPRO_WGMMA_M64N256K16("bf16");
  else
    REPRO_WGMMA_M64N256K16("f16");
}
#undef REPRO_WGMMA_M64N256K16

// Every consumer thread takes its share of a flagged stage's 16-byte
// chunks.  Under the 128-byte swizzle, chunk c of smem row r holds the
// operand's logical chunk c ^ (r & 7) of that row.  A fatal lane's fill is
// its logical tile's (A: bm x bk, B: bk x bn): the 8 lanes of a chunk may
// span logical tiles when bk or bn is not a multiple of 8.
__device__ __forceinline__ void repair_a(uint8_t* tile, int m0, int k0, int M,
                                         int K, const Detector& det,
                                         const repro::Fill& fill, int bm,
                                         int bk) {
  const int nk = K / bk;
  for (int q = threadIdx.x; q < BM * 8; q += CONSUMER_THREADS) {
    const int r = q >> 3, k = k0 + ((q & 7) ^ (r & 7)) * 8;
    if (m0 + r < M && k < K)
      repair_chunk_with(reinterpret_cast<uint4*>(tile) + q, K - k, det,
                        [&](int e) {
                          return fill.at((long long)((m0 + r) / bm) * nk +
                                         (k + e) / bk);
                        });
  }
}

__device__ __forceinline__ void repair_b(uint8_t* tile, int k0, int n0, int K,
                                         int N, const Detector& det,
                                         const repro::Fill& fill, int bk,
                                         int bn) {
  const int nj = N / bn;
  for (int q = threadIdx.x; q < BK * BN / 8; q += CONSUMER_THREADS) {
    const int box = q >> 9, r = (q & 511) >> 3;
    const int n = n0 + box * B_BOX + ((q & 7) ^ (r & 7)) * 8;
    if (k0 + r < K && n < N)
      repair_chunk_with(reinterpret_cast<uint4*>(tile) + q, N - n, det,
                        [&](int e) {
                          return fill.at((long long)((k0 + r) / bk) * nj +
                                         (n + e) / bn);
                        });
  }
}

__device__ __forceinline__ void store_pair(void* C, int dt, long long i,
                                           float x, float y) {
  if (dt == repro::DT_F32) {
    *reinterpret_cast<float2*>(static_cast<float*>(C) + i) = make_float2(x, y);
  } else {
    const uint32_t lo = dt == repro::DT_BF16
                            ? Storage<repro::DT_BF16>::from_float(x)
                            : Storage<repro::DT_F16>::from_float(x);
    const uint32_t hi = dt == repro::DT_BF16
                            ? Storage<repro::DT_BF16>::from_float(y)
                            : Storage<repro::DT_F16>::from_float(y);
    *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(C) + i) = lo | (hi << 16);
  }
}

// One operand of the scan: (rows, cols) row-major 16-bit lanes, its logical
// tile (br, bc) for the counts and its flag tile (fr, fc).
struct ScanOperand {
  const uint4* x;
  unsigned vecs;  // rows * cols / 8
  int cols, br, bc, fr, fc;
  Detector det;
  uint32_t floor;  // fatal_floor(det)
  int* tiles;      // [rows/br][cols/bc][nan, inf]
  int* flags;      // [ceil(rows/fr)][ceil(cols/fc)]
};

// The full test of a suspect vector v of `op`: classify, count, flag (out
// of line: clean data never calls it).
__device__ __noinline__ void scan_vec(const ScanOperand op, unsigned v,
                                      const uint4 q) {
  const unsigned per_row = (unsigned)op.cols >> 3;
  const int r = (int)(v / per_row), c0 = (int)(v - (unsigned)r * per_row) * 8;
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  bool any = false;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int cls =
        repro::classify((w[e >> 1] >> ((e & 1) * 16)) & 0xFFFFu, op.det);
    if (cls) {
      any = true;
      count_lane(op.tiles,
                 (long long)(r / op.br) * (op.cols / op.bc) + (c0 + e) / op.bc,
                 cls);
    }
  }
  if (any)
    op.flags[(r / op.fr) * ((op.cols + op.fc - 1) / op.fc) + c0 / op.fc] = 1;
}

constexpr int SCAN_THREADS = 256, SCAN_VECS = 4;  // 64 bytes in flight a thread

// A's vectors first, then B's; a block reads SCAN_VECS * 4 KB, coalesced.
__global__ void __launch_bounds__(SCAN_THREADS)
    repair_mm_scan(ScanOperand a, ScanOperand b) {
  const unsigned base = blockIdx.x * (SCAN_THREADS * SCAN_VECS) + threadIdx.x;
  uint4 q[SCAN_VECS];
#pragma unroll
  for (int i = 0; i < SCAN_VECS; ++i) {
    const unsigned v = base + i * SCAN_THREADS;
    if (v < a.vecs)
      q[i] = __ldg(a.x + v);
    else if (v - a.vecs < b.vecs)
      q[i] = __ldg(b.x + (v - a.vecs));
  }
#pragma unroll
  for (int i = 0; i < SCAN_VECS; ++i) {
    const unsigned v = base + i * SCAN_THREADS;
    if (v < a.vecs) {
      if (may_be_fatal(q[i], a.det.exp_mask, a.floor)) scan_vec(a, v, q[i]);
    } else if (v - a.vecs < b.vecs) {
      if (may_be_fatal(q[i], b.det.exp_mask, b.floor))
        scan_vec(b, v - a.vecs, q[i]);
    }
  }
}

// Persistent: one block per SM walks the output tiles t = blockIdx.x,
// blockIdx.x + gridDim.x, ...; the ring and its phases run on across tiles,
// so the producer loads the next tile while the consumers store this one.
template <int DT>
__global__ void __launch_bounds__(THREADS, 1)
    repair_mm_wgmma(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, void* C,
                    int out_dt, int M, int N, int K, int bm, int bn, int bk,
                    Detector det_a, Detector det_b, repro::Fill fill_a,
                    repro::Fill fill_b, const int* flags_a,
                    const int* flags_b) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the ring to it
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING_BYTES);
  uint64_t* empty = full + STAGES;
  // per stage: bit 0 its A tile is flagged, bit 1 its B tile (written by
  // the producer before the stage's full barrier, which publishes it)
  uint8_t* stage_flags = reinterpret_cast<uint8_t*>(empty + STAGES);
  const int nkt = (K + BK - 1) / BK, nnb = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * nnb;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CONSUMER_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMER_THREADS) {
    // ---- producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == CONSUMER_THREADS) {
      int it = 0;  // stages issued by this block, over all its tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int mb = t / nnb, nb = t - mb * nnb;
        for (int kt = 0; kt < nkt; ++kt, ++it) {
          const int s = it % STAGES;
          const int fl = (flags_a[mb * nkt + kt] ? 1 : 0) |
                         (flags_b[kt * nnb + nb] ? 2 : 0);
          mbar_wait(smem_u32(&empty[s]), ((it / STAGES) & 1) ^ 1);
          stage_flags[s] = (uint8_t)fl;
          const uint32_t bar = smem_u32(&full[s]);
          const uint32_t a_dst = smem_u32(ring + s * STAGE_BYTES);
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load_2d(a_dst, &map_a, kt * BK, mb * BM, bar);
#pragma unroll
          for (int j = 0; j < BN / B_BOX; ++j)
            tma_load_2d(a_dst + A_BYTES + j * B_BOX_BYTES, &map_b,
                        nb * BN + j * B_BOX, kt * BK, bar);
        }
      }
    }
  } else {
    // ---- two consumer warpgroups: 64 rows of each 128 x 256 tile each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wgi = threadIdx.x >> 7;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int mb = t / nnb;
      const int m0 = mb * BM, n0 = (t - mb * nnb) * BN;
      float d[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.f;
      for (int kt = 0; kt < nkt; ++kt, ++it) {
        const int s = it % STAGES;
        uint8_t* a_tile = ring + s * STAGE_BYTES;
        mbar_wait(smem_u32(&full[s]), (it / STAGES) & 1);
        const int fl = stage_flags[s];
        if (fl) {
          if (fl & 1)
            repair_a(a_tile, m0, kt * BK, M, K, det_a, fill_a, bm, bk);
          if (fl & 2)
            repair_b(a_tile + A_BYTES, kt * BK, n0, K, N, det_b, fill_b, bk,
                     bn);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          asm volatile("bar.sync 1, %0;" ::"n"(CONSUMER_THREADS) : "memory");
        }
        const uint32_t a_base = smem_u32(a_tile) + wgi * 64 * 128;
        const uint32_t b_base = smem_u32(a_tile + A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_256<DT>(d, sw128_desc(a_base + kk * 32, 16, 1024),
                        sw128_desc(b_base + kk * 16 * 128, B_BOX_BYTES, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(d);
        mbar_arrive(smem_u32(&empty[s]));
      }
      // accumulator layout of m64nNk16: warp w of the warpgroup holds rows
      // 16w + lane/4 (+8); d[4j..4j+3] columns 8j + 2*(lane%4) (+1)
      const int row = m0 + wgi * 64 + warp * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + j * 8 + (lane & 3) * 2;
        if (col >= N) continue;  // N % 8 == 0: col + 1 < N too
        if (row < M)
          store_pair(C, out_dt, (long long)row * N + col, d[4 * j],
                     d[4 * j + 1]);
        if (row + 8 < M)
          store_pair(C, out_dt, (long long)(row + 8) * N + col, d[4 * j + 2],
                     d[4 * j + 3]);
      }
    }
  }
}

template <int DT>
cudaError_t launch_wgmma(const void* a, const void* b, void* c, int out_dt,
                         int M, int N, int K, int bm, int bn, int bk,
                         const int* det_a, const int* det_b,
                         repro::Fill fill_a, repro::Fill fill_b,
                         const int* flags_a, const int* flags_b,
                         cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  if (!tensor_map(&map_a, a, DT, M, K, BM, BK) ||
      !tensor_map(&map_b, b, DT, K, N, BK, B_BOX))
    return cudaErrorInvalidValue;
  static bool smem_set = false;  // the attribute is set once per kernel
  if (!smem_set) {
    const cudaError_t err =
        repro::allow_smem((const void*)repair_mm_wgmma<DT>, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int tiles = (M + BM - 1) / BM * ((N + BN - 1) / BN);
  repair_mm_wgmma<DT><<<tiles < sms ? tiles : sms, THREADS, SMEM_BYTES,
                        stream>>>(map_a, map_b, c, out_dt, M, N, K, bm, bn,
                                  bk, repro::detector_from(det_a),
                                  repro::detector_from(det_b), fill_a, fill_b,
                                  flags_a, flags_b);
  return cudaGetLastError();
}

}  // namespace wg

template <int DA, int DB>
cudaError_t launch(const void* a, const void* b, void* c, int out_dt, int M,
                   int N, int K, int bm, int bn, int bk, const int* det_a,
                   const int* det_b, repro::Fill fill_a, repro::Fill fill_b,
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
                     const int* det_a, const int* det_b, repro::Fill fill_a,
                     repro::Fill fill_b, int* tiles_a, int* tiles_b,
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
// repaired lanes' bit patterns, or with fills_a/fills_b (device uint32 per
// logical A / B tile, from repro_tile_fill; null: none) the lane's tile's
// entry; tiles_a int32[2 * ni * nk] and tiles_b int32[2 * nk * nj] zeroed
// scratch; counts int32[8] out.  Returns cudaGetLastError() after the
// launches.
extern "C" int repro_repair_matmul(const void* a, const void* b, void* c,
                                   int dt_a, int dt_b, int out_dt, int M,
                                   int N, int K, int bm, int bn, int bk,
                                   const int* det_a, const int* det_b,
                                   unsigned int fill_a_bits,
                                   unsigned int fill_b_bits,
                                   const unsigned int* fills_a,
                                   const unsigned int* fills_b, int* tiles_a,
                                   int* tiles_b, int* counts, void* stream) {
  if (bm < 1 || bn < 1 || bk < 1 || M % bm || N % bn || K % bk ||
      out_dt < 0 || out_dt > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const repro::Fill fill_a{fills_a, fill_a_bits}, fill_b{fills_b, fill_b_bits};
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

static bool wgmma_shape_ok(int dt, int out_dt, int M, int N, int K, int bm,
                           int bn, int bk) {
  return (dt == repro::DT_BF16 || dt == repro::DT_F16) && out_dt >= 0 &&
         out_dt <= 2 && M > 0 && N > 0 && K > 0 && K % 8 == 0 &&
         N % 8 == 0 && bm >= 1 && bn >= 1 && bk >= 1 && M % bm == 0 &&
         N % bn == 0 && K % bk == 0 &&
         (long long)M * K / 8 + (long long)K * N / 8 < (1ll << 32) - 4096;
}

// The wgmma route's scan: a (M, K) and b (K, N) row-major 16-bit (dtype
// dt), 16-byte aligned.  Adds [nan, inf] lane counts into tiles_a
// (ni x nk) and tiles_b (nk x nj) on the logical blocks (bm, bn, bk), and
// sets flags_a (ceil(M/128) x ceil(K/64)) and flags_b (ceil(K/64) x
// ceil(N/256)), all zeroed by the caller, for every physical operand tile
// of repair_mm_wgmma that holds a fatal lane.
extern "C" int repro_repair_mm_scan(const void* a, const void* b, int dt,
                                    int M, int N, int K, int bm, int bn,
                                    int bk, const int* det_a,
                                    const int* det_b, int* tiles_a,
                                    int* tiles_b, int* flags_a, int* flags_b,
                                    void* stream) {
  if (!wgmma_shape_ok(dt, 0, M, N, K, bm, bn, bk))
    return (int)cudaErrorInvalidValue;
  const Detector da = repro::detector_from(det_a),
                 db = repro::detector_from(det_b);
  const wg::ScanOperand sa{static_cast<const uint4*>(a),
                           (unsigned)((long long)M * K / 8), K, bm, bk, wg::BM,
                           wg::BK, da, hopper::fatal_floor(da), tiles_a, flags_a};
  const wg::ScanOperand sb{static_cast<const uint4*>(b),
                           (unsigned)((long long)K * N / 8), N, bk, bn, wg::BK,
                           wg::BN, db, hopper::fatal_floor(db), tiles_b, flags_b};
  const unsigned per_block = wg::SCAN_THREADS * wg::SCAN_VECS;
  const unsigned total = sa.vecs + sb.vecs;
  wg::repair_mm_scan<<<(total + per_block - 1) / per_block, wg::SCAN_THREADS,
                       0, static_cast<cudaStream_t>(stream)>>>(sa, sb);
  return (int)cudaGetLastError();
}

// The wgmma route: repro_repair_mm_scan, the product and the counts.  c
// (M, N) in out_dt, counts int32[8] out; tiles and flags as for the scan,
// zeroed by the caller.  Arguments as in repro_repair_matmul, both operands
// in dtype dt.
extern "C" int repro_repair_mm_wgmma(const void* a, const void* b, void* c,
                                     int dt, int out_dt, int M, int N, int K,
                                     int bm, int bn, int bk, const int* det_a,
                                     const int* det_b, unsigned int fill_a_bits,
                                     unsigned int fill_b_bits,
                                     const unsigned int* fills_a,
                                     const unsigned int* fills_b, int* tiles_a,
                                     int* tiles_b, int* flags_a, int* flags_b,
                                     int* counts, void* stream) {
  const repro::Fill fill_a{fills_a, fill_a_bits}, fill_b{fills_b, fill_b_bits};
  if (!wgmma_shape_ok(dt, out_dt, M, N, K, bm, bn, bk))
    return (int)cudaErrorInvalidValue;
  const int scan =
      repro_repair_mm_scan(a, b, dt, M, N, K, bm, bn, bk, det_a, det_b,
                           tiles_a, tiles_b, flags_a, flags_b, stream);
  if (scan != 0) return scan;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dt == repro::DT_BF16
          ? wg::launch_wgmma<repro::DT_BF16>(a, b, c, out_dt, M, N, K, bm, bn,
                                             bk, det_a, det_b, fill_a, fill_b,
                                             flags_a, flags_b, s)
          : wg::launch_wgmma<repro::DT_F16>(a, b, c, out_dt, M, N, K, bm, bn,
                                            bk, det_a, det_b, fill_a, fill_b,
                                            flags_a, flags_b, s);
  if (err != cudaSuccess) return (int)err;
  repair_mm_counts<<<1, 256, 0, s>>>(tiles_a, tiles_b, M / bm, N / bn, K / bk,
                                     counts);
  return (int)cudaGetLastError();
}
