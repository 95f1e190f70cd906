#!/usr/bin/env python3
"""Time the paged routes kernel by kernel at the three pools of
``chip_smoke.py`` (StableLM-1.6B, StarCoder2-15B, Qwen2-1.5B; B 4, M 8,
pages of 16, planted), f32 and bf16, on one card:

    python3 scripts/paged_f32_routes.py [--parent-csrc DIR]

Every call is first held against its plain version (integer outputs equal,
the largest output difference printed).  Decode at splits 4 on its route
(``decode_route``), prefill of request 0 at C 64 and 100 on its route
(``route``); device ms per call by kernel from the profiler.  On the heads
route the decode runs in turns with its shipped partition
(``heads_partition``) and with one block a KV head (no slot split), each
against the plain twin of its own partition.  With ``--parent-csrc DIR``
(another checkout's ``src/repro_torch/csrc``), that checkout's fused decode
and wgmma prefill entry points are built beside and timed against the
shipped ones on the same bf16 operands, in turns (shipped, parent, parent,
shipped).  Prints one line per reading and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def parent_entries(native, pa, csrc: Path) -> dict:
    """The fused decode's and the wgmma prefill's entry points built from
    another checkout's sources, keyed as ``_native`` caches them."""
    out_dir = native.BUILD_DIR.parent / "paged_parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    entries = {}
    for name, fn, sig in (("paged_decode", "repro_paged_decode_fused",
                           pa._DECODE_FUSED_SIG),
                          ("paged_prefill", "repro_paged_prefill_wgmma",
                           pa._PREFILL_WGMMA_SIG)):
        lib = out_dir / f"lib{name}.so"
        subprocess.run([native._nvcc(), *native._FLAGS, "-I", str(csrc), "-o",
                        str(lib), str(csrc / f"{name}.cu")], check=True,
                       capture_output=True, text=True)
        entry = getattr(ctypes.CDLL(str(lib)), fn)
        entry.argtypes, entry.restype = sig, native.I
        entries[(name, fn)] = entry
    return entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-csrc", type=Path, default=None,
                    help="a checkout's src/repro_torch/csrc to time beside")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("paged_f32_routes: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _native
    from repro_torch.kernels import paged_attention as pa

    print(cs.gpu_line())
    _native.build(["paged_decode", "paged_prefill"])
    kw = dict(detector_k="default", detector_v="default", policy="zero")
    if args.parent_csrc is not None:
        compare_parent(cs, _native, pa, args.parent_csrc, kw)
    shipped = pa.HEADS_MIN_BLOCKS
    for name, pool in (("stablelm-1.6b", cs.STABLELM_POOL),
                       ("starcoder2-15b", cs.STARCODER2_POOL),
                       ("qwen2-1.5b", cs.QWEN2_POOL)):
        pc = cs.PagedCheck(pool)
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).split(".")[-1]
            kp, vp, q, qcs = pc.fresh(dtype)
            route = pa.decode_route(q, kp, vp)

            def dcall():
                return pa.paged_attention_splitk_raw(q, kp, vp, pc.bt, pc.pos,
                                                     cs.LAYER, splits=4, **kw)

            # the heads route in turns: shipped, one block a KV head, and back
            arms = ((shipped, 1, 1, shipped) if route == "heads" else (shipped,))
            for arm in arms:
                pa.HEADS_MIN_BLOCKS = arm
                got = dcall()
                twin = (pa.paged_decode_heads_plain if route == "heads"
                        else pa.paged_decode_fused_plain)(
                    q, kp, vp, pc.bt, pc.pos, cs.LAYER, **kw)
                for a, b in zip(got[1:], twin[1:]):
                    cs._same(a, b, f"{name} {dt} decode")
                parts = cs.kernel_breakdown(dcall, cs.DECODE_KERNELS[route])
                part = (f" partition {pa.heads_partition(pool.M, pool.KH)}"
                        if route == "heads" else "")
                print(f"{name} {dt} decode splits=4 ({route}{part}): device "
                      f"{sum(parts.values()):.5f} ms = "
                      + " + ".join(f"{k} {v:.5f}" for k, v in parts.items())
                      + f"; max_abs_err {cs._errs(got[0], twin[0]):.3g}")
            pa.HEADS_MIN_BLOCKS = shipped
            for c, qc in qcs.items():
                qc1, qs1 = qc[:1], pc.q_starts[c][:1]

                def pcall(qc1=qc1, qs1=qs1):
                    return pa.paged_prefill_raw(qc1, kp, vp, pc.bt[:1], qs1,
                                                cs.LAYER, **kw)

                p_route = pa.route(qc1, kp, vp)
                got = pcall()
                want = pa.paged_prefill_plain(qc1, kp, vp, pc.bt[:1], qs1,
                                              cs.LAYER, **kw)
                for a, b in zip(got[1:], want[1:]):
                    cs._same(a, b, f"{name} {dt} prefill")
                parts = cs.kernel_breakdown(pcall, cs.PREFILL_ROUTE_KERNELS[p_route])
                print(f"{name} {dt} prefill C={c} ({p_route}): device "
                      f"{sum(parts.values()):.5f} ms = "
                      + " + ".join(f"{k} {v:.5f}" for k, v in parts.items())
                      + f"; max_abs_err {cs._errs(got[0], want[0]):.3g}")
    print(cs.gpu_line())
    return 0


def compare_parent(cs, native, pa, csrc: Path, kw) -> None:
    """The shipped and the parent's bf16 fused decode (splits 4) and wgmma
    prefill (C 64) at the three pools, in turns, device ms by kernel."""
    import torch

    parent = parent_entries(native, pa, csrc)
    shipped = {key: native.function(*key, parent[key].argtypes) for key in parent}
    for name, pool in (("qwen2-1.5b", cs.QWEN2_POOL),
                       ("stablelm-1.6b", cs.STABLELM_POOL),
                       ("starcoder2-15b", cs.STARCODER2_POOL)):
        pc = cs.PagedCheck(pool)
        kp, vp, q, qcs = pc.fresh(torch.bfloat16)
        qc1, qs1 = qcs[cs.C][:1], pc.q_starts[cs.C][:1]
        calls = {
            "decode": (lambda: pa.paged_attention_splitk_raw(
                q, kp, vp, pc.bt, pc.pos, cs.LAYER, splits=4, **kw),
                cs.DECODE_KERNELS["fused"]),
            f"prefill C={cs.C}": (lambda: pa.paged_prefill_raw(
                qc1, kp, vp, pc.bt[:1], qs1, cs.LAYER, **kw),
                cs.PREFILL_KERNELS),
        }
        try:
            for turn, arm in enumerate(("shipped", "parent", "parent", "shipped")):
                native._entries.update(shipped if arm == "shipped" else parent)
                for what, (call, names) in calls.items():
                    if arm == "parent":   # its scan is named prefill_scan
                        names = tuple("prefill_scan" if n == "page_scan" else n
                                      for n in names)
                    call()
                    parts = cs.kernel_breakdown(call, names)
                    print(f"{name} bfloat16 {what} {arm} turn={turn}: device "
                          f"{sum(parts.values()):.5f} ms = "
                          + " + ".join(f"{k} {v:.5f}" for k, v in parts.items()),
                          flush=True)
        finally:
            native._entries.update(shipped)


if __name__ == "__main__":
    sys.exit(main())
