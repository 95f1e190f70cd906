#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; each raises on failure, so the run exits non-zero:

  1. the card's name and power limit; build the CUDA kernels (one ``nvcc``
     per source, in parallel) and print the build time
  2. kernels at the serving shapes (Qwen2-1.5B pool: P=65, L=28, pg=16,
     Kh=2, Dh=128; H=12, B=4, M=8, splits 1 and 4, prefill chunk C=64), f32
     and bf16, with NaN/±Inf/range/bit-pattern lanes planted in resident
     pages and the null page: each kernel against its plain version on the
     card (integer outputs exactly equal, floats within the stated
     tolerance), then timed (median of CUDA-event timings) beside its plain
     version, its bound and a library yardstick
  3. the engine at full width (28 layers, bf16, random weights from seed
     0): 6 requests, faults planted after step 3, repair and launch checks
  4. parity at full width with 2 layers in f32: the same engine and faults
     on the card (kernels) and on the CPU (plain versions)
  5. the injection arm: ber=1e-7 for 4 steps

Prints the kernel report as one JSON line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line.  Exits
non-zero without that line when no card is visible or the package is
missing.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense bf16 TC / f32 non-TC

# kernel-phase geometry: the Qwen2-1.5B pool of the serving config
P, L, PG, KH, DH, H, B, M, C = 65, 28, 16, 2, 128, 12, 4, 8, 64
NULL = P - 1
LAYER = 5
# float tolerances, kernel vs plain version on the same card:
#   f32  — both accumulate in f32 but sum in different orders (the kernel
#          sequentially per thread, the plain version through cuBLAS)
#   bf16 — outputs are bf16 (one ulp near 1 is 2^-8), and softmax weights
#          are rounded to bf16 before the value product, where an f32
#          difference in the last place can flip one rounding
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_profile(fn, table: str = ""):
    """Device milliseconds by kernel name for one call of ``fn`` under
    ``torch.profiler`` (empty when the profiler records no device time).
    With ``table``, host and device activity are both recorded and their
    summary tables written to ``chiprun_out/<table>``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if table else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    if table:
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        avg = prof.key_averages()
        (out / table).write_text(
            avg.table(sort_by="self_cpu_time_total", row_limit=40) + "\n"
            + avg.table(sort_by="self_device_time_total", row_limit=40)
        )
    per = {}
    for evt in prof.key_averages():
        if evt.self_cpu_time_total:      # a host op; its kernels appear on their own
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us:
            per[evt.key] = per.get(evt.key, 0.0) + us / 1e3
    return per


def kernel_device_ms(fn, names, iters: int = 20):
    """Device time per call of the named kernels (several launches of one
    wrapper summed), or None when the profiler records no device time."""
    fn()
    per = device_profile(lambda: [fn() for _ in range(iters)])
    total = sum(ms for key, ms in per.items() if any(n in key for n in names))
    return total / iters if total else None


KERNEL_NAMES = {
    "scrub": ("scrub_tiles", "scrub_finalize"),
    "paged_decode": ("decode_partials", "lse_merge"),
    "paged_prefill": ("prefill_partials",),
}


def bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 2
def kernel_phase(report: dict) -> None:
    import torch

    from repro_torch.core import detect
    from repro_torch.core.rules import Detector
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import scrub as sk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n_real = [8, 5, 3, 1]
    perm = torch.randperm(P - 1, generator=gen, device=dev).tolist()
    bt_rows, cursor = [], 0
    for n in n_real:
        bt_rows.append(perm[cursor:cursor + n] + [NULL] * (M - n))
        cursor += n
    bt = torch.tensor(bt_rows, dtype=torch.int32, device=dev)
    pos = torch.tensor([n * PG - 3 for n in n_real], dtype=torch.int32, device=dev)
    q_start = torch.tensor([max(0, n * PG - C) for n in n_real], dtype=torch.int32,
                           device=dev)
    scrub_ids = [bt_rows[0][1], bt_rows[1][0], NULL]

    def fresh(dtype):
        g = torch.Generator(device=dev).manual_seed(1)
        kp = torch.randn((P, L, PG, KH, DH), generator=g, device=dev).to(dtype)
        vp = torch.randn((P, L, PG, KH, DH), generator=g, device=dev).to(dtype)
        plant = [
            (kp, (bt_rows[0][1], LAYER, 3, 0, 10), float("nan")),
            (kp, (bt_rows[1][0], LAYER, 0, 1, 100), float("inf")),
            (vp, (bt_rows[2][2], LAYER, 7, 1, 5), float("-inf")),
            (vp, (NULL, LAYER, 0, 0, 0), float("nan")),
            (kp, (NULL, LAYER, 2, 1, 9), 3.0e4),           # range guard
            (vp, (bt_rows[0][3], LAYER, 5, 0, 1), -5.0e3),  # range guard
            (kp, (bt_rows[3][0], LAYER, 1, 0, 2), 3.0),     # bit pattern
            (vp, (bt_rows[0][1], LAYER, 4, 1, 7), 3.0),     # bit pattern
        ]
        for t, idx, val in plant:
            t[idx] = val
        q = torch.randn((B, H, DH), generator=g, device=dev).to(dtype)
        qc = torch.randn((B, C, H, DH), generator=g, device=dev).to(dtype)
        return kp, vp, q, qc

    def det2(dtype):
        lay = detect.layout_of(dtype)
        three = int(detect.bits_of(torch.tensor([3.0], dtype=dtype))[0])
        return Detector(max_magnitude=1e3, bitpatterns=(
            (None, (1 << lay.width) - 1, three & ((1 << lay.width) - 1)),
        ))

    def errs(a, b):
        return float((a.float() - b.float()).abs().nan_to_num(0.0).max())

    def same(a, b, what):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"{what}: integer outputs differ\n{a}\n{b}")

    max_err = {"scrub": 0.0, "paged_decode": 0.0, "paged_prefill": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tol = TOL[name]
        configs = [
            ("default", dict(detector_k="default", detector_v="default",
                             policy="zero")),
            ("range+bitpattern", dict(detector_k=det2(dtype), detector_v=det2(dtype),
                                      policy_k="zero", policy_v="constant",
                                      constant_v=0.5)),
        ]
        for label, kw in configs:
            kp, vp, q, qc = fresh(dtype)
            for splits in (1, 4):
                got = pa.paged_attention_splitk_raw(
                    q, kp, vp, bt, pos, LAYER, splits=splits, **kw)
                want = pa.paged_decode_plain(
                    q, kp, vp, bt, pos, LAYER, splits=splits, **kw)
                same(got[1], want[1], f"decode slot_counts {name} {label} s={splits}")
                same(got[2], want[2], f"decode counts {name} {label} s={splits}")
                torch.testing.assert_close(got[0].float(), want[0].float(),
                                           rtol=tol, atol=tol)
                max_err["paged_decode"] = max(max_err["paged_decode"],
                                              errs(got[0], want[0]))
                if int(got[2][6]) == 0:
                    raise AssertionError("decode saw none of the planted lanes")
            got = pa.paged_prefill_raw(qc, kp, vp, bt, q_start, LAYER, **kw)
            want = pa.paged_prefill_plain(qc, kp, vp, bt, q_start, LAYER, **kw)
            same(got[1], want[1], f"prefill slot_counts {name} {label}")
            same(got[2], want[2], f"prefill counts {name} {label}")
            torch.testing.assert_close(got[0].float(), want[0].float(),
                                       rtol=tol, atol=tol)
            max_err["paged_prefill"] = max(max_err["paged_prefill"],
                                           errs(got[0], want[0]))
            # page scrub: 3 ids bucketed to 4 with a padding duplicate
            det = kw["detector_k"] if label != "default" else None
            skw = dict(policy="zero", detector=det, n_valid=3)
            ids = scrub_ids + [scrub_ids[0]]
            a, b = kp.clone(), kp.clone()
            _, c_kernel = sk.scrub_pages(a, ids, **skw)
            _, c_plain = sk.scrub_pages_plain(b, ids, **skw)
            same(c_kernel, c_plain, f"scrub_pages counts {name} {label}")
            same(detect.bits_of(a), detect.bits_of(b), f"scrub_pages bits {name}")
            max_err["scrub"] = max(max_err["scrub"], errs(a, b))
            if int(c_kernel[0] + c_kernel[1]) == 0:
                raise AssertionError("scrub saw none of the planted lanes")
            log(f"kernels ok  dtype={name} detector={label} "
                f"decode_counts={got[2].tolist()} scrub_counts={c_kernel.tolist()}")
        a, b = vp.clone(), vp.clone()
        same(sk.scrub(a)[1], sk.scrub_plain(b)[1], f"scrub counts {name}")
        same(detect.bits_of(a), detect.bits_of(b), f"scrub bits {name}")

    # ---- timings at the main path's shapes (bf16 pool, layer LAYER) ----
    dtype, name = torch.bfloat16, "bfloat16"
    es = 2
    kp, vp, q, qc = fresh(dtype)
    kw = dict(detector_k="default", detector_v="default", policy="zero")
    page_bytes = PG * KH * DH * es
    visited = len({p for row in bt_rows for p in row})
    t_keys = M * PG

    decode_ms = cuda_ms(lambda: pa.paged_attention_splitk_raw(
        q, kp, vp, bt, pos, LAYER, splits=4, **kw))
    decode_plain_ms = cuda_ms(lambda: pa.paged_decode_plain(
        q, kp, vp, bt, pos, LAYER, splits=4, **kw))
    # the serial walk (splits = 1): off the main path at M = 8, timed apart
    serial = dict(
        ms=cuda_ms(lambda: pa.paged_attention_splitk_raw(
            q, kp, vp, bt, pos, LAYER, splits=1, **kw)),
        plain_ms=cuda_ms(lambda: pa.paged_decode_plain(
            q, kp, vp, bt, pos, LAYER, splits=1, **kw)),
        device_ms=kernel_device_ms(lambda: pa.paged_attention_splitk_raw(
            q, kp, vp, bt, pos, LAYER, splits=1, **kw), KERNEL_NAMES["paged_decode"]),
    )
    valid_keys = sum(min(int(p) + 1, t_keys) for p in pos.tolist())
    nbytes = (2 * B * H * DH * es + 2 * visited * page_bytes + B * M * 4 * 2
              + B * 4 + 32)
    d_bound, d_by = bound(nbytes, 4.0 * H * DH * valid_keys, name)
    # yardstick: SDPA over a gathered, head-expanded contiguous view
    kg = kp[bt.long(), LAYER].reshape(B, t_keys, KH, DH).repeat_interleave(
        H // KH, dim=2).transpose(1, 2).contiguous()
    vg = vp[bt.long(), LAYER].reshape(B, t_keys, KH, DH).repeat_interleave(
        H // KH, dim=2).transpose(1, 2).contiguous()
    kg, vg = kg.nan_to_num(0.0), vg.nan_to_num(0.0)
    mask = (torch.arange(t_keys, device=dev)[None, :] <= pos[:, None].long())
    mask = mask[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    decode_lib_ms = cuda_ms(lambda: sdpa(q[:, :, None, :], kg, vg, attn_mask=mask))

    qs1 = q_start[:1]
    prefill_ms = cuda_ms(lambda: pa.paged_prefill_raw(
        qc[:1], kp, vp, bt[:1], qs1, LAYER, **kw))
    prefill_plain_ms = cuda_ms(lambda: pa.paged_prefill_plain(
        qc[:1], kp, vp, bt[:1], qs1, LAYER, **kw))
    qs0 = int(qs1[0])
    p_valid = sum(min(qs0 + c + 1, t_keys) for c in range(C)) * H
    nbytes = (2 * C * H * DH * es + 2 * M * page_bytes + M * 4 * 2 + 4 + 32)
    p_bound, p_by = bound(nbytes, 4.0 * DH * p_valid, name)
    cmask = (torch.arange(t_keys, device=dev)[None, :]
             <= (qs0 + torch.arange(C, device=dev))[:, None])
    prefill_lib_ms = cuda_ms(lambda: sdpa(
        qc[:1].transpose(1, 2), kg[:1], vg[:1], attn_mask=cmask))

    ids2 = [bt_rows[0][1], bt_rows[1][0]]
    scr = kp.clone()
    scrub_ms = cuda_ms(lambda: sk.scrub_pages(scr, ids2, n_valid=2))
    scrub_plain_ms = cuda_ms(lambda: sk.scrub_pages_plain(scr, ids2, n_valid=2))
    row_bytes = L * page_bytes
    s_bound, s_by = bound(len(ids2) * row_bytes + 12, len(ids2) * row_bytes / es,
                          name)

    dev_ms = {
        "scrub": kernel_device_ms(lambda: sk.scrub_pages(scr, ids2, n_valid=2),
                                  KERNEL_NAMES["scrub"]),
        "paged_decode": kernel_device_ms(lambda: pa.paged_attention_splitk_raw(
            q, kp, vp, bt, pos, LAYER, splits=4, **kw), KERNEL_NAMES["paged_decode"]),
        "paged_prefill": kernel_device_ms(lambda: pa.paged_prefill_raw(
            qc[:1], kp, vp, bt[:1], qs1, LAYER, **kw), KERNEL_NAMES["paged_prefill"]),
    }
    report["kernels"] = {
        "scrub": dict(
            route="cuda", source="src/repro_torch/csrc/scrub.cu",
            replaces="src/repro/kernels/scrub.py:38 (_scrub_kernel)",
            max_abs_err=max_err["scrub"], ms=scrub_ms, plain_ms=scrub_plain_ms,
            bound_ms=s_bound, bound_by=s_by, library_ms=None,
            device_ms=dev_ms["scrub"],
        ),
        "paged_decode": dict(
            route="cuda", source="src/repro_torch/csrc/paged_decode.cu",
            replaces=("src/repro/kernels/paged_attention.py:147 (_paged_kernel) "
                      "and :633 (_paged_splitk_kernel, merge _lse_merge :131)"),
            max_abs_err=max_err["paged_decode"], ms=decode_ms,
            plain_ms=decode_plain_ms, bound_ms=d_bound, bound_by=d_by,
            library_ms=decode_lib_ms, device_ms=dev_ms["paged_decode"],
        ),
        "paged_prefill": dict(
            route="cuda", source="src/repro_torch/csrc/paged_prefill.cu",
            replaces="src/repro/kernels/paged_attention.py:362 (_paged_prefill_kernel)",
            max_abs_err=max_err["paged_prefill"], ms=prefill_ms,
            plain_ms=prefill_plain_ms, bound_ms=p_bound, bound_by=p_by,
            library_ms=prefill_lib_ms, device_ms=dev_ms["paged_prefill"],
        ),
    }
    for k, v in report["kernels"].items():
        log(f"timing {k}: call {v['ms']:.4f} ms (device {v['device_ms']}), "
            f"plain {v['plain_ms']:.4f} ms, "
            f"bound {v['bound_ms']:.5f} ms ({v['bound_by']}), library "
            f"{v['library_ms']}, max_abs_err {v['max_abs_err']}")
    log(f"timing paged_decode splits=1: call {serial['ms']:.4f} ms (device "
        f"{serial['device_ms']}), plain {serial['plain_ms']:.4f} ms, bound and "
        f"library as at splits=4")
    log("timing shapes: decode B=4 M=8 splits=4 bf16; prefill B=1 C=64 bf16; "
        "scrub_pages 2 pages bf16 (one Qwen2-1.5B layer each for attention); "
        "ms = CUDA events around one wrapper call (host work included), "
        "device = profiler kernel time per call")


# ------------------------------------------------------------ phases 3-5
def requests(vocab: int):
    import numpy as np

    rng = np.random.default_rng(0)
    lengths = rng.integers(20, 101, size=6)
    return [rng.integers(1, vocab, size=int(n)).tolist() for n in lengths]


def serving_config(ber: float = 0.0):
    from repro_torch.serving import ServingConfig

    return ServingConfig(page_size=16, n_pages=64, max_batch=4,
                         max_pages_per_request=8, repair="page", ber=ber)


def plant(engine):
    """NaN in a K page and Inf in a V page of two decoding requests, at
    positions below each request's next write slot (page 0, offset 1)."""
    running = [r for r in engine.sched.running
               if r.prefill_pos is None and r.n_context > PG + 1]
    if len(running) < 2:
        raise AssertionError("fewer than two decoding requests to plant in")
    a, b = running[0], running[1]
    tree = engine.pool.tree
    top = tree["layers/k"].shape[1] - 1          # the pool's last layer
    tree["layers/k"][a.pages[0], min(3, top), 1, 0, 7] = float("nan")
    tree["layers/k"][a.pages[0], min(9, top), 1, 1, 70] = float("nan")
    tree["layers/v"][b.pages[0], 0, 1, 1, 3] = float("inf")
    return [a.pages[0], b.pages[0]], 2, 1


def drive(engine, prompts, *, plant_after: int = 3, max_new: int = 16):
    """Serve ``prompts``; plant faults after step ``plant_after`` and check
    the next step repairs them.  Returns (results, per-step log)."""
    import torch

    rids = [engine.add_request(p, max_new=max_new) for p in prompts]
    planted, steps = None, 0
    while engine.has_work:
        before = engine.stats_dict()
        engine.step()
        if planted is not None:
            pages, n_nan, n_inf = planted
            after = engine.stats_dict()
            for p in pages:
                if engine.pool.page_events[p] < 1:
                    raise AssertionError(f"planted page {p} was not charged")
            if after["nan_found"] - before["nan_found"] < n_nan:
                raise AssertionError("planted NaN lanes not all found")
            if after["inf_found"] - before["inf_found"] < n_inf:
                raise AssertionError("planted Inf lanes not all found")
            for leaf in engine.pool.tree.values():
                if not bool(torch.isfinite(leaf).all()):
                    raise AssertionError("a fatal lane survived the reactive scrub")
            planted = None
        steps += 1
        if steps == plant_after + 1:
            planted = plant(engine)
    return [engine.results[r] for r in rids]


def engine_phase(report: dict) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.models import TransformerLM
    from repro_torch.serving import Engine

    cfg = get_config("qwen2-1.5b")
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"engine: {cfg.name} L={cfg.n_layers} {cfg.dtype_name} params={n_params} "
        f"init {time.perf_counter() - t0:.2f} s")
    engine = Engine(model, serving_config(), device="cuda")
    prompts = requests(cfg.vocab)
    common.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = drive(engine, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    for res in results:
        gen = res["generated"]
        if len(gen) != 16 or not all(0 <= t < cfg.vocab for t in gen):
            raise AssertionError(f"bad generation {gen}")
    for k in ("paged_decode", "paged_prefill", "scrub"):
        if launches.get(k, 0) < 1:
            raise AssertionError(f"kernel {k} never launched on the main path")
    m = engine.metrics()
    steps = m["steps"]
    report["launches"] = launches

    # the same workload again on a warm process: steady-state timing, then a
    # profiled pass for the device-time breakdown
    warm = Engine(model, serving_config(), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drive(warm, prompts)
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    wm = warm.metrics()
    per = device_profile(lambda: drive(
        Engine(model, serving_config(), device="cuda"), prompts),
        table="engine_profile.txt")
    groups = {"repair_kernels": 0.0, "gemm": 0.0, "copy": 0.0, "other": 0.0}
    ours = tuple(n for names in KERNEL_NAMES.values() for n in names)
    for key, ms in per.items():
        low = key.lower()
        if any(n in key for n in ours):
            groups["repair_kernels"] += ms
        elif any(n in low for n in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
            groups["gemm"] += ms
        elif "memcpy" in low or "memset" in low:
            groups["copy"] += ms
        else:
            groups["other"] += ms
    busy = sum(groups.values())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    report["engine"] = dict(
        tokens=m["tokens_emitted"], steps=steps, first_run_wall_s=wall,
        warm_wall_s=warm_wall, tokens_per_s=wm["tokens_emitted"] / warm_wall,
        ms_per_step=1e3 * warm_wall / wm["steps"],
        first_run_ms_per_step=1e3 * wall / steps,
        launches_per_step={k: v / steps for k, v in launches.items()},
        device_ms_per_step={k: v / wm["steps"] for k, v in groups.items()},
        device_idle_share=(1.0 - busy / (1e3 * warm_wall)) if busy else None,
        top_kernels_ms=[(k[:60], v) for k, v in top],
        stats=engine.stats_dict(), kernel_counts=engine.kernel_counts.tolist(),
        n_host_syncs=m["n_host_syncs"], scrubbed_bytes=m["scrubbed_bytes"],
        split_k=m["split_k"], stage_wall_s=wm["stage_wall_s"],
    )
    log("engine: " + json.dumps(report["engine"]))
    report["model"] = model


def parity_phase(report: dict) -> None:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM
    from repro_torch.serving import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2,
                              dtype_name="float32")
    gpu = TransformerLM(cfg, device="cuda", seed=0)
    cpu = TransformerLM(cfg, device="cpu", seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    prompts = requests(cfg.vocab)
    outs = []
    for model, dev in ((gpu, "cuda"), (cpu, "cpu")):
        eng = Engine(model, serving_config(), device=dev)
        res = drive(eng, prompts)
        outs.append(dict(
            tokens=[r["tokens"] for r in res],
            page_events=eng.pool.page_events.tolist(),
            stats=eng.stats_dict(), kernel_counts=eng.kernel_counts.tolist(),
        ))
    for key in ("tokens", "page_events", "stats", "kernel_counts"):
        if outs[0][key] != outs[1][key]:
            raise AssertionError(f"parity: {key} differs between card and CPU")
    log(f"parity ok: 2-layer f32, stats {outs[0]['stats']}, kernel_counts "
        f"{outs[0]['kernel_counts']}")


def injection_phase(report: dict) -> None:
    from repro_torch.serving import Engine

    model = report.pop("model")
    eng = Engine(model, serving_config(ber=1e-7), device="cuda")
    for p in requests(model.cfg.vocab):
        eng.add_request(p, max_new=16)
    for _ in range(4):
        eng.step()
    stats = eng.stats_dict()
    if stats["flips"] < 1:
        raise AssertionError(f"no flips recorded: {stats}")
    log(f"injection ok: 4 steps at ber=1e-7, stats {stats}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _native

    card = gpu_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    built = _native.build(force=True)
    log(f"build: {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for name in _native.SOURCES:
        for line in _native.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    report: dict = {}
    kernel_phase(report)
    engine_phase(report)
    parity_phase(report)
    injection_phase(report)
    kernels = []
    for name, row in report["kernels"].items():
        kernels.append(dict(name=name, **row,
                            launches=int(report["launches"].get(name, 0))))
    log(json.dumps({"kernels": kernels}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
