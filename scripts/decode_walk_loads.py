#!/usr/bin/env python3
"""How much of the walk decode kernel's time its serialised tile loads take.

    python3 scripts/decode_walk_loads.py        # on an H100, from the repo root

The walk route's ``decode_partials`` (``src/repro_torch/csrc/paged_decode.cu``)
repairs each K and V tile with ``repro::repair_tile``: one 2-byte load per
lane per loop step, each followed by a shared-memory store, so a thread's
loads go out one after another.  This script builds a variant of the same
source whose tile repair issues 16 loads per thread before it classifies
and stores any of them (``nvcc`` into ``build/decode_walk_loads/``), then
times ``decode_partials`` and ``lse_merge`` of both builds with the
profiler, in turns (shipped, variant, variant, shipped), at the engine's
decode shapes (Qwen2-1.5B pool, B = 4, M = 8, bf16, q 2 bytes off 16-byte
alignment so that the call takes the walk route, NaN and -Inf planted), at
splits 4 and 1.  Both builds' counts must equal the plain version's.
Prints the card's name and power limit, then one line per (build, splits,
turn).  The difference between splits 1 (8 slots a block) and 4 (2 slots)
over 6 gives the time per slot walked.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

BATCHED = r'''
namespace {
// repro::repair_tile with each thread's U loads issued before any is used.
template <int DT>
__device__ __forceinline__ void repair_tile_batched(
    const typename repro::Storage<DT>::bits_t* src, int rows, int dh, int stride,
    const repro::Detector& det, const repro::Fill& fill, long long page,
    float* dst, int* cnt) {
  constexpr int U = 16;
  int n_nan = 0, n_inf = 0;
  const int n = rows * dh;
  for (int e0 = threadIdx.x; e0 < n; e0 += blockDim.x * U) {
    uint32_t v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * blockDim.x;
      v[u] = e < n ? (uint32_t)src[e] : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < n) {
        uint32_t b = v[u];
        const int c = repro::classify(b, det);
        n_nan += c & 1;
        n_inf += c >> 1;
        if (c) b = fill.at(page);
        dst[(e / dh) * stride + (e % dh)] = repro::Storage<DT>::to_float(b);
      }
    }
  }
  repro::block_add(&cnt[0], n_nan);
  repro::block_add(&cnt[1], n_inf);
}
}  // namespace
'''


def build_variant(native) -> ctypes.CDLL:
    src = (native.CSRC / "paged_decode.cu").read_text()
    anchor = "namespace {\n\nusing repro::Detector;"
    if anchor not in src or src.count("repro::repair_tile<DT>(") != 2:
        raise RuntimeError("paged_decode.cu no longer has the walk kernel's shape")
    src = src.replace(anchor, BATCHED + anchor, 1)
    src = src.replace("repro::repair_tile<DT>(", "repair_tile_batched<DT>(")
    out_dir = native.BUILD_DIR.parent / "decode_walk_loads"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib = out_dir / "paged_decode_batched.cu", out_dir / "libbatched.so"
    cu.write_text(src)
    subprocess.run([native._nvcc(), *native._FLAGS, "-I", str(native.CSRC), "-o",
                    str(lib), str(cu)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_walk_loads: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _native, paged_attention as pa

    print(cs.gpu_line(), flush=True)
    variant = build_variant(_native).repro_paged_decode
    variant.argtypes, variant.restype = pa._DECODE_SIG, _native.I
    shipped = _native.function("paged_decode", "repro_paged_decode", pa._DECODE_SIG)

    dev = torch.device("cuda")
    P, L, PG, KH, DH, H, B, M, LAYER = 65, 28, 16, 2, 128, 12, 4, 8, 5
    g = torch.Generator(device=dev).manual_seed(0)
    n_real = [8, 5, 3, 1]
    perm = torch.randperm(P - 1, generator=g, device=dev).tolist()
    rows, cursor = [], 0
    for n in n_real:
        rows.append(perm[cursor:cursor + n] + [P - 1] * (M - n))
        cursor += n
    bt = torch.tensor(rows, dtype=torch.int32, device=dev)
    pos = torch.tensor([n * PG - 3 for n in n_real], dtype=torch.int32, device=dev)
    kp = torch.randn((P, L, PG, KH, DH), generator=g, device=dev).bfloat16()
    vp = torch.randn((P, L, PG, KH, DH), generator=g, device=dev).bfloat16()
    kp[rows[0][1], LAYER, 3, 0, 10] = float("nan")
    vp[rows[2][2], LAYER, 7, 1, 5] = float("-inf")
    q = cs._at_offset(torch.randn((B, H, DH), generator=g, device=dev).bfloat16(), 1)
    if pa.decode_route(q, kp, vp) != "walk":
        raise AssertionError("the operands do not take the walk route")
    key = ("paged_decode", "repro_paged_decode")
    names = ("decode_partials", "lse_merge")
    try:
        for turn, label in enumerate(("shipped", "batched", "batched", "shipped")):
            _native._entries[key] = shipped if label == "shipped" else variant
            for splits in (4, 1):
                def call(splits=splits):
                    return pa.paged_attention_splitk_raw(q, kp, vp, bt, pos, LAYER,
                                                         splits=splits)

                got = call()
                want = pa.paged_decode_plain(q, kp, vp, bt, pos, LAYER, splits=splits)
                if not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])):
                    raise AssertionError(f"{label} splits={splits}: counts differ")
                parts = cs.kernel_breakdown(call, names)
                print(f"{label} splits={splits} turn={turn}: device "
                      f"{sum(parts.values()):.4f} ms = decode_partials "
                      f"{parts['decode_partials']:.4f} + lse_merge "
                      f"{parts['lse_merge']:.4f}", flush=True)
    finally:
        _native._entries[key] = shipped
    return 0


if __name__ == "__main__":
    sys.exit(main())
