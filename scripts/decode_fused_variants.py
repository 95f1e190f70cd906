#!/usr/bin/env python3
"""The fused decode kernel as shipped against two variants of its design,
and optionally against another checkout's kernel, at the serving pools.

    python3 scripts/decode_fused_variants.py [--parent-csrc DIR]
                                              # on an H100, from the repo root

``decode_fused`` (``src/repro_torch/csrc/paged_decode.cu``) runs one warp
per query head, at most 16 a block, and merges the cluster's partials by
pushing each block's slices into their owners' shared memory before one
cluster barrier.  This script builds (``nvcc`` into
``build/decode_fused_variants/``):

  warps24  the same source with ``MAX_HEAD_WARPS`` 24 instead of 16: two
           heads a warp at StarCoder2-15B's 48 heads instead of three,
           under a launch bound of 800 threads;
  pull     the merge as pulls: every block keeps its partial, and after a
           cluster barrier each block reads its share of every block's
           partial through distributed shared memory, then waits on a
           second barrier before it leaves;
  parent   with ``--parent-csrc DIR``, that directory's ``paged_decode.cu``
           (its entry point must take the same arguments; a pool its fused
           route refuses is skipped);

then times ``decode_fused`` of each build with the profiler, in turns (the
order of builds, then reversed), at the bf16 pools of Qwen2-1.5B (H 12, Kh
2, Dh 128), StableLM-1.6B (H 32, Kh 32, Dh 64) and StarCoder2-15B (H 48,
Kh 4, Dh 128), B = 4, M = 8, planted as in ``chip_smoke.py``.  Every
build's counts must equal the plain version's and its outputs the fused
route's plain twin's within the bf16 tolerance.  Prints the card's name and
power limit, one line per (build, pool, turn), then each build's readings
per pool.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PULL = r'''  cluster_arrive();
  cluster_wait();
  const int items = H * (D / 4), share = (items + nb - 1) / nb;
  const int i1 = min(items, (rank + 1) * share);
  for (int item = rank * share + tid; item < i1; item += nthreads) {
    const int h = item / (D / 4), c4 = item - h * (D / 4);
    float mr[MAX_CLUSTER], lr[MAX_CLUSTER];
    float4 ar[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      if (r < nb) {
        mr[r] = *cluster.map_shared_rank(m_s + h, r);
        lr[r] = *cluster.map_shared_rank(l_s + h, r);
        ar[r] = *cluster.map_shared_rank(
            reinterpret_cast<float4*>(acc + h * D) + c4, r);
      }
    }
    float m_star = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < nb) m_star = nan_max(m_star, mr[r]);
    float lt = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      if (r < nb) {
        const float w = mr[r] > NEG_INF * 0.5f ? expf(mr[r] - m_star) : 0.f;
        lt += w * lr[r];
        o.x += w * ar[r].x;
        o.y += w * ar[r].y;
        o.z += w * ar[r].z;
        o.w += w * ar[r].w;
      }
    }
    const float den = fmaxf(lt, 1e-30f);
    store4<DT>(p.out + (((long long)b * H + h) * D + 4 * c4) * ES,
               make_float4(o.x / den, o.y / den, o.z / den, o.w / den));
  }
  cluster_arrive();
  cluster_wait();
}

'''


WARPS = "constexpr int MAX_HEAD_WARPS = 16;"


def warps24_source(src: str) -> str:
    """The shipped source with up to 24 head warps a block."""
    if src.count(WARPS) != 1:
        raise RuntimeError("paged_decode.cu no longer sets MAX_HEAD_WARPS to 16")
    return src.replace(WARPS, "constexpr int MAX_HEAD_WARPS = 24;")


def pull_source(src: str) -> str:
    """The shipped source with its merge rewritten as pulls."""
    entry = "  cluster_arrive_relaxed();\n"
    merge = "  const int items = H * (D / 4), share = (items + nb - 1) / nb;\n"
    end = "// Slots a block and blocks a request:"
    if src.count(entry) != 1 or src.count(merge) != 1 or src.count(end) != 1:
        raise RuntimeError("paged_decode.cu no longer has the fused merge's shape")
    src = src.replace(entry, "")
    a, b = src.index(merge), src.index(end)
    return src[:a] + PULL + src[b:]


def build(native, out_dir: Path, tag: str, src: Path, include: Path) -> ctypes.CDLL:
    lib = out_dir / f"libpaged_decode_{tag}.so"
    subprocess.run([native._nvcc(), *native._FLAGS, "-I", str(include),
                    "-o", str(lib), str(src)], check=True, capture_output=True,
                   text=True)
    return ctypes.CDLL(str(lib))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-csrc", type=Path, default=None,
                    help="a checkout's src/repro_torch/csrc to time beside")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("decode_fused_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _native, paged_attention as pa

    print(cs.gpu_line(), flush=True)
    key = ("paged_decode", "repro_paged_decode_fused")
    entries = {"shipped": _native.function(*key, pa._DECODE_FUSED_SIG)}
    out_dir = _native.BUILD_DIR.parent / "decode_fused_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    shipped = (_native.CSRC / "paged_decode.cu").read_text()
    builds = {}
    for tag, rewrite in (("warps24", warps24_source), ("pull", pull_source)):
        builds[tag] = (out_dir / f"paged_decode_{tag}.cu", _native.CSRC)
        builds[tag][0].write_text(rewrite(shipped))
    if args.parent_csrc is not None:
        builds["parent"] = (args.parent_csrc / "paged_decode.cu", args.parent_csrc)
    for tag, (src, include) in builds.items():
        fn = build(_native, out_dir, tag, src, include).repro_paged_decode_fused
        fn.argtypes, fn.restype = pa._DECODE_FUSED_SIG, _native.I
        entries[tag] = fn

    pools = {"qwen2-1.5b": cs.QWEN2_POOL, "stablelm-1.6b": cs.STABLELM_POOL,
             "starcoder2-15b": cs.STARCODER2_POOL}
    operands = {}
    for name, shape in pools.items():
        pc = cs.PagedCheck(shape)
        kp, vp, q, _ = pc.fresh(torch.bfloat16)
        if pa.decode_route(q, kp, vp) != "fused":
            raise AssertionError(f"{name}: the operands do not take the fused route")
        operands[name] = (pc, kp, vp, q)
    order = list(entries) + list(entries)[::-1]
    readings: dict = {}
    try:
        for turn, tag in enumerate(order):
            _native._entries[key] = entries[tag]
            for name, (pc, kp, vp, q) in operands.items():
                def call(pc=pc, kp=kp, vp=vp, q=q):
                    return pa.paged_attention_raw(q, kp, vp, pc.bt, pc.pos, cs.LAYER)

                try:
                    got = call()
                except RuntimeError as exc:
                    if tag != "parent":
                        raise
                    print(f"{tag} {name}: refused ({exc})", flush=True)
                    continue
                want = pa.paged_decode_plain(q, kp, vp, pc.bt, pc.pos, cs.LAYER)
                twin = pa.paged_decode_fused_plain(q, kp, vp, pc.bt, pc.pos, cs.LAYER)
                if not (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])):
                    raise AssertionError(f"{tag} {name}: counts differ")
                cs._close_nonfinite(got[0], twin[0], cs.TOL["bfloat16"],
                                    f"{tag} {name}")
                ms = cs.kernel_breakdown(call, ("decode_fused",))["decode_fused"]
                readings.setdefault((name, tag), []).append(ms)
                print(f"{tag} {name} turn={turn}: decode_fused {ms:.5f} ms",
                      flush=True)
    finally:
        _native._entries[key] = entries["shipped"]
    for (name, tag), ms in readings.items():
        print(f"summary {name} {tag}: decode_fused "
              f"{' '.join(f'{x:.5f}' for x in ms)} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
