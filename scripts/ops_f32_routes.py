#!/usr/bin/env python3
"""Time the exact-f32 routes of ``repair_matmul`` and ``flash_attention``
kernel by kernel at ``chip_smoke.py``'s ops shapes (the gate/up product
(2048, 1536) @ (1536, 8960), causal attention at B 1, H 12, Kh 2,
S = T = 2048, D 128), planted and clean, on one card:

    python3 scripts/ops_f32_routes.py [--parent-csrc DIR] [--rounds N]

Every call is first held against its plain version (counts equal, the
largest output difference printed).  Device ms per call by kernel from the
profiler, TFLOP/s and the share of the FP32 bound; beside them the FFMA
route on the same values 4 bytes off alignment and the f32 library calls
(``torch.matmul``; SDPA's memory-efficient kernel over K/V expanded to H
heads), TF32 off; the f32 product's split of its last wave over k
against every tile over all of K, in turns.  With ``--parent-csrc DIR``
(another checkout's ``src/repro_torch/csrc``), that checkout's wgmma
entry points of both ops
are built beside the shipped ones and timed on the same bf16 operands in
turns (shipped, parent, parent, shipped), ``--rounds`` times.  Prints one
line per reading and the card's name and power limit.
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


def _line(what, parts, flops=None, bound_ms=None, extra=""):
    dev = sum(parts.values())
    rate = (f"; {flops / dev / 1e9:.1f} TFLOP/s, {bound_ms / dev:.3f} of the "
            f"FP32 bound {bound_ms:.4f} ms" if flops else "")
    print(f"{what}: device {dev:.5f} ms = "
          + " + ".join(f"{k} {v:.5f}" for k, v in parts.items()) + rate + extra,
          flush=True)


def parent_entries(native, rm, ra, csrc: Path) -> dict:
    """Both ops' wgmma entry points built from another checkout's sources
    (two ``nvcc`` at once), keyed as ``_native`` caches them."""
    out_dir = native.BUILD_DIR.parent / "ops_parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    wanted = (("repair_matmul", "repro_repair_mm_wgmma", rm._WGMMA_SIGNATURE),
              ("flash_attention", "repro_flash_attention_wgmma",
               ra._WGMMA_SIGNATURE))
    procs = [(name, fn, sig, out_dir / f"lib{name}.so",
              subprocess.Popen([native._nvcc(), *native._FLAGS, "-I", str(csrc),
                                "-o", str(out_dir / f"lib{name}.so"),
                                str(csrc / f"{name}.cu")],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               text=True))
             for name, fn, sig in wanted]
    entries = {}
    for name, fn, sig, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"parent {name}: nvcc exited {proc.returncode}\n{out}")
        entry = getattr(ctypes.CDLL(str(lib)), fn)
        entry.argtypes, entry.restype = sig, native.I
        entries[(name, fn)] = entry
    return entries


def f32_routes(cs, rm, ra, ops, gen) -> None:
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    f32 = torch.float32
    dev = torch.device("cuda")
    M, K, N = cs.MM_SHAPES["gate_up"]
    flops = 2.0 * M * N * K
    bound_ms = cs.bound(4 * (M * K + K * N + M * N), flops, "float32")[0]
    ca = torch.randn((M, K), generator=gen, device=dev)
    cb = torch.randn((K, N), generator=gen, device=dev)
    a, b = cs._plant_lanes(ca.clone(), gen, f32), cs._plant_lanes(cb.clone(), gen, f32)
    assert rm.route(a, b) == "f32"
    got, want = rm.repair_matmul_raw(a, b), rm.repair_matmul_plain(a, b)
    assert torch.equal(got[1].cpu(), want[1].cpu()), (got[1], want[1])
    print(f"repair_matmul gate/up f32 ok: counts {got[1].tolist()}, max_abs_err "
          f"{cs._errs(got[0], want[0]):.3g}", flush=True)
    names = cs.KERNEL_NAMES["repair_matmul"]
    flagged = [int(x.sum()) for x in rm.scan_plain(a, b, tile=rm.F32_TILE)[2:]]
    for label, x, y in (("planted", a, b), ("clean", ca, cb)):
        parts = cs.kernel_breakdown(lambda x=x, y=y: rm.repair_matmul_raw(x, y),
                                    names, iters=5)
        _line(f"repair_matmul gate/up f32 {label} (f32 route)",
              {k: v for k, v in parts.items() if v}, flops, bound_ms,
              f"; flagged A/B tiles {flagged}" if label == "planted" else "")
    # the last wave's split (f32_plan) against every tile over all of K, in
    # turns on the clean operands
    plan = rm.f32_plan
    try:
        for turn, arm in enumerate(("split", "whole", "whole", "split")):
            rm.f32_plan = plan if arm == "split" else (
                lambda M_, N_, K_, sms: (-(-M_ // 128) * -(-N_ // 128), 1))
            parts = cs.kernel_breakdown(lambda: rm.repair_matmul_raw(ca, cb),
                                        names, iters=5)
            _line(f"repair_matmul gate/up f32 clean, last wave {arm} turn={turn}",
                  {k: v for k, v in parts.items() if v}, flops, bound_ms)
    finally:
        rm.f32_plan = plan
    ao, bo = cs._at_offset(a, 1), cs._at_offset(b, 1)
    assert rm.route(ao, bo) == "ffma"
    parts = cs.kernel_breakdown(lambda: rm.repair_matmul_raw(ao, bo), names, iters=3)
    _line("repair_matmul gate/up f32 planted (ffma route, 4 bytes off)",
          {k: v for k, v in parts.items() if v}, flops, bound_ms)
    with cs._tf32_off():
        lib = cs.library_device_ms(lambda: torch.matmul(ca, cb), iters=5)
    print(f"torch.matmul gate/up f32, TF32 off: device {lib} ms", flush=True)
    del a, b, ca, cb, ao, bo, got, want

    B, H, Kh, S, D = cs.AT_B, cs.AT_H, cs.AT_KH, cs.AT_S, cs.AT_D
    flops = 2.0 * B * H * S * S * D
    bound_ms = cs.bound(4 * (2 * B * H * S * D + 2 * B * Kh * S * D), flops,
                        "float32")[0]
    q = torch.randn((B, H, S, D), generator=gen, device=dev)
    k = cs._plant_lanes(torch.randn((B, Kh, S, D), generator=gen, device=dev), gen, f32)
    v = cs._plant_lanes(torch.randn((B, Kh, S, D), generator=gen, device=dev), gen, f32)
    fk, fv = ops.scrub(k.clone())[0], ops.scrub(v.clone())[0]
    assert ra.route(q, k, v) == "f32"
    got, want = ra.flash_attention_raw(q, k, v), ra.flash_attention_plain(q, k, v)
    assert torch.equal(got[1].cpu(), want[1].cpu()), (got[1], want[1])
    print(f"flash_attention causal f32 ok: counts {got[1].tolist()}, max_abs_err "
          f"{cs._errs(got[0], want[0]):.3g}, late-row rel norm max "
          f"{float(cs._late_rel(got[0], want[0]).max()):.3g}", flush=True)
    names = cs.KERNEL_NAMES["flash_attention"]
    flags = ra.scan_plain(k, v, S=S, causal=True, tile=ra.F32_TILE)[1]
    for label, kk, vv in (("planted", k, v), ("clean", fk, fv)):
        parts = cs.kernel_breakdown(lambda kk=kk, vv=vv: ra.flash_attention_raw(q, kk, vv),
                                    names, iters=5)
        _line(f"flash_attention causal f32 {label} (f32 route)",
              {k_: v_ for k_, v_ in parts.items() if v_}, flops, bound_ms,
              f"; flagged K/V tiles {int(flags[..., 0].sum())}/"
              f"{int(flags[..., 1].sum())}" if label == "planted" else "")
    qo, ko, vo = (cs._at_offset(x, 1) for x in (q, k, v))
    assert ra.route(qo, ko, vo) == "ffma"
    parts = cs.kernel_breakdown(lambda: ra.flash_attention_raw(qo, ko, vo), names,
                                iters=3)
    _line("flash_attention causal f32 planted (ffma route, 4 bytes off)",
          {k_: v_ for k_, v_ in parts.items() if v_}, flops, bound_ms)
    kx, vx = (x.repeat_interleave(H // Kh, dim=1) for x in (fk, fv))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def efficient():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return sdpa(q, kx, vx, is_causal=True)

    kernels: list = []
    with cs._tf32_off():
        lib = cs.library_device_ms(efficient, iters=5, kernels=kernels)
    print(f"SDPA causal f32 memory-efficient, TF32 off: device {lib} ms, "
          f"{cs.sdpa_backend(kernels)}", flush=True)


def compare_parent(cs, native, rm, ra, ops, gen, csrc: Path, rounds: int) -> None:
    """The shipped and the parent's bf16 wgmma routes of both ops at the
    ops shapes, planted and clean, in turns, device ms by kernel."""
    import torch

    bf16 = torch.bfloat16
    dev = torch.device("cuda")
    parent = parent_entries(native, rm, ra, csrc)
    shipped = {key: native.function(*key, parent[key].argtypes) for key in parent}
    M, K, N = cs.MM_SHAPES["gate_up"]
    ca = torch.randn((M, K), generator=gen, device=dev).to(bf16)
    cb = torch.randn((K, N), generator=gen, device=dev).to(bf16)
    a, b = cs._plant_lanes(ca.float(), gen, bf16), cs._plant_lanes(cb.float(), gen, bf16)
    B, H, Kh, S, D = cs.AT_B, cs.AT_H, cs.AT_KH, cs.AT_S, cs.AT_D
    q = torch.randn((B, H, S, D), generator=gen, device=dev).to(bf16)
    k = cs._plant_lanes(torch.randn((B, Kh, S, D), generator=gen, device=dev), gen, bf16)
    v = cs._plant_lanes(torch.randn((B, Kh, S, D), generator=gen, device=dev), gen, bf16)
    fk, fv = ops.scrub(k.clone())[0], ops.scrub(v.clone())[0]
    assert rm.route(a, b) == "wgmma" and ra.route(q, k, v) == "wgmma"
    mm_names = ("repair_mm_scan", "repair_mm_wgmma", "repair_mm_counts")
    at_names = ("flash_scan", "flash_repair_wgmma", "flash_counts")
    calls = {
        "repair_matmul gate/up bf16 planted": (lambda: rm.repair_matmul_raw(a, b), mm_names),
        "repair_matmul gate/up bf16 clean": (lambda: rm.repair_matmul_raw(ca, cb), mm_names),
        "flash_attention causal bf16 planted": (lambda: ra.flash_attention_raw(q, k, v), at_names),
        "flash_attention causal bf16 clean": (lambda: ra.flash_attention_raw(q, fk, fv), at_names),
    }
    try:
        for arm in ("shipped", "parent"):     # both hold against the plain version
            native._entries.update(shipped if arm == "shipped" else parent)
            for what, want in (("matmul", rm.repair_matmul_plain(a, b)),
                               ("attention", ra.flash_attention_plain(q, k, v))):
                got = (rm.repair_matmul_raw(a, b) if what == "matmul"
                       else ra.flash_attention_raw(q, k, v))
                assert torch.equal(got[1].cpu(), want[1].cpu()), (arm, what)
                print(f"{arm} bf16 {what} ok: max_abs_err "
                      f"{cs._errs(got[0], want[0]):.3g}", flush=True)
        for rnd in range(rounds):
            for turn, arm in enumerate(("shipped", "parent", "parent", "shipped")):
                native._entries.update(shipped if arm == "shipped" else parent)
                for what, (call, names) in calls.items():
                    parts = cs.kernel_breakdown(call, names, iters=20)
                    _line(f"{what} {arm} round={rnd} turn={turn}", parts)
    finally:
        native._entries.update(shipped)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-csrc", type=Path, default=None,
                    help="a checkout's src/repro_torch/csrc to time beside")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of the four turns against the parent")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ops_f32_routes: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _native, ops
    from repro_torch.kernels import repair_attention as ra
    from repro_torch.kernels import repair_matmul as rm

    print(cs.gpu_line(), flush=True)
    _native.build(["repair_matmul", "flash_attention", "scrub"])
    for name in ("repair_matmul", "flash_attention"):
        for kernel, info in cs.ptxas_summary(_native.build_log(name)).items():
            print(f"ptxas {name} {kernel}: " + ", ".join(info), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    f32_routes(cs, rm, ra, ops, gen)
    if args.parent_csrc is not None:
        compare_parent(cs, _native, rm, ra, ops, gen, args.parent_csrc, args.rounds)
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
