#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; each raises on failure, so the run exits non-zero:

  1. the card's name and power limit; build the CUDA kernels (one ``nvcc``
     per source, in parallel) and print the build time and, per kernel,
     ptxas's registers, stack frame, spills and injected warpgroup.arrive
  2. kernels at the serving shapes (Qwen2-1.5B pool: P=65, L=28, pg=16,
     Kh=2, Dh=128; H=12, B=4, M=8, splits 1 and 4, prefill chunks C=64 and
     C=100), f32, bf16 and f16, with NaN/±Inf/range/bit-pattern lanes
     planted in resident pages, in a page dead for the early prefill row
     blocks and in the null page: each kernel against its plain version on
     the card (integer outputs exactly equal, floats within the stated
     tolerance; decode on its fused route at splits 1 and 4 and a q 2 bytes
     off alignment on its walk route, ``kernels.paged_attention.decode_route``;
     16-bit prefill on its wgmma route, f32 and a 16-bit q 2 bytes off
     alignment on its FFMA route, ``kernels.paged_attention.route``; each
     ``kernels ok`` line names the routes; decode and prefill also with V
     detection off, where the planted V lanes' NaN and Inf must land where
     the plain version's do), then timed (median of CUDA-event timings)
     beside its plain version, its bound and SDPA's call and device times
     (the decode's fused route split into kernel and memset at splits 4 and
     1, planted and clean, beside its walk route; the prefill's wgmma route
     split into scan, main kernel and memset at C=64 and C=100, and its FFMA
     kernel on the same bf16 operands); the scrub at two shapes: (a) the
     engine's page scrub (2 pages of the bf16 pool), which must be one device
     operation a call, and (b) the whole-buffer scrub of the xLSTM cache's
     mLSTM C at xlstm-1.3b width, batch 4 (2.82 GB f32), held bit for bit
     and count for count against ``scrub_plain`` on the same planted input,
     then timed clean and planted beside its bound; ``neighbor_mean`` on the
     same pool (f32 and bf16, both fills and the K-only mean beside a zero
     V fill under the range detector): every decode and prefill route and
     the page scrub against their plain versions, and ``tile_fill``'s
     per-page table against the plain table (``nm ok`` lines; each page,
     and each of the scrub's tiles, carries its own offset, and each line
     ends with its controls, which must fail its comparison: the zero
     fill, and each operand's table rolled one tile)
  2b. ops: the paper's fused-repair ops at Qwen2-1.5B width — repair_matmul
     on the MLP projections of a 2,048-token prefill (f32, bf16, and A bf16
     with B f32) and flash_attention at B=1, H=12, Kh=2, S=T=2048, D=128
     (causal f32, bf16 and f16, non-causal, causal S=1024, causal bf16 2
     bytes off 16-byte alignment), planted lanes in
     both operands under two detectors: counts equal to the plain version's
     on the card, outputs within the stated tolerance (attention also by
     the late-row relative norm against a dropped-tile control), memory mode's origin
     scrub bit-equal to the plain scrub and its second call counting 0
     (bf16 x bf16 products take repair_matmul's wgmma route, the others its
     FFMA route: ``kernels.repair_matmul.route``; 16-bit attention takes
     flash_attention's wgmma route, f32 and unaligned views its FFMA route:
     ``kernels.repair_attention.route``; every ``ops ok`` line names it);
     the same checks at the quickstart's shapes and blocks (512³ matmul,
     blocks (128, 128, 256); attention 1×4×256×64 over Kh=2, blocks
     (64, 64)); then the quickstart twin (``examples/torch_quickstart.py``) on the
     card with its Table-3 asserts, and both kernels timed: repair_matmul
     at gate/up in bf16 on planted and on clean operands (the wgmma kernel
     must show in the profile; scan, main kernel and counts apart), in f32
     (the FFMA route) and at the down projection; flash_attention causal
     bf16 at S=T=2048 on planted and on clean operands (the wgmma kernel
     must show in the profile; scan, main kernel and counts apart, beside
     SDPA's call; the clean call also replayed from a CUDA graph) and in
     f32 (the FFMA route); ``neighbor_mean`` (``nm ok`` lines): the gate/up
     product and the 2,048-token attention in bf16 (wgmma routes), the
     quickstart's f32 shapes (FFMA routes), each against its plain version,
     each operand's ``tile_fill`` table against the plain one, memory
     mode's origin scrub against the plain scrub, on operands whose tiles
     carry their own offsets, with the controls as above; one ``timing tile_fill``
     line (device ms at the gate/up A operand and at the engine pool's
     layer beside their bytes bounds, and the calls with the mean against
     the zero fill's)
  3. the engine at full width (28 layers, bf16, random weights from seed
     0): 6 requests, faults planted after step 3, repair and launch checks
  3b. the fallback arms on the same model and requests, each cold (its
     checks) then warm (one ``timing engine arm=`` line: ms and host syncs,
     gathers, scatters, launches and stage wall times a step, the device's
     idle share): (a) ``paged_decode="off"`` (everything gathered, the
     probe repair), (b) ``paged_prefill="off"``, (c) ``repair="off"``
     without faults (no repair kernel may launch; (a)/(c) is the repair
     overhead on the gathered path), (d) ``drain_interval=4`` (lockstep's
     tokens, fewer host syncs; then ``drain_interval=1`` at ber=1e-7 must
     replay lockstep bit for bit), (e) register mode: the forward over 256
     tokens with a NaN weight lane, bit-equal to mode off with that lane 0,
     then the engine on the gathered path, (f) ``generate`` over the dense
     cache (the scrub kernel must find a NaN and an Inf planted before its
     2nd interval scrub) and ``generate(paged=True)``
  3c. the prefix cache and the host tier at the same width (bf16, page size
     16): two waves of six requests on one 96-token prefix (wave one with
     random suffixes of 8-40 tokens, wave two diverging from each wave-one
     prompt inside its cached partial tail page), 16 new tokens each: hits,
     saved prefill tokens and copy-on-write forks, the tokens against a
     cache-off run reported; with ``dwell_threshold=0`` a NaN planted in a
     cached full page must take back its snapshot's exact bits on the hit;
     then six requests growing by 48 tokens each over a 16-page pool with
     ``host_pages=32``: preemption must swap, every
     swapped-out page's host copy must equal its scrubbed device bits and
     every swapped-in page its host copy, the pool finite
  4. parity at full width with 2 layers in f32: the same engine and faults
     on the card (kernels) and on the CPU (plain versions), in seven arms:
     paged, (a), (b), (c), register mode, a ``neighbor_mean`` space and
     ``drain_interval=2``
  5. the injection arm: ber=1e-7 for 4 steps
  6. the mLSTM kernel at xlstm-1.3b width (B=1, H=4, S=2048: 16 chunks of
     128, head dim 1024), f32 (FFMA route) and bf16 (wgmma route, and the
     same values 2 bytes off alignment on the FFMA route,
     ``kernels.mlstm_chunk.route``), NaN/±Inf planted in q, k and v, fills
     zero and constant, include_inf on and off: counts equal to the plain
     version's on the card, outputs within MLSTM_TOL; ``neighbor_mean`` on
     both bf16 routes with one v tile fatal in every lane (tiles offset,
     the controls as above); ``nm launches``:
     the kernels the ``neighbor_mean`` calls launched, each at least once;
     then the bf16 operands timed on both routes beside the bound
  7. the xLSTM forward at full xlstm-1.3b width (48 blocks, bf16, random
     weights from seed 0), 2,048 prompt tokens: one kernel launch per mLSTM
     block (42), zero counts, finite logits; the same forward with the
     plain version beside the kernel in every mLSTM block, each block's y
     within MLSTM_TOL; the end-to-end plain forward and a one-ulp control
     measured (the bf16 stack amplifies rounding: see MLSTM_TOL's note)
  8. xLSTM generate at full width: 4 prompts of 32 tokens, 16 new, the
     cache scrubbed every 8 steps by the scrub kernel; NaN/Inf planted in
     the mLSTM C and the sLSTM c before a scrub must be found exactly and
     gone, every step's logits finite
  8b. the xLSTM forward at full width and full depth in f32 (48 blocks,
     TF32 off), 256 tokens: kernel in every mLSTM block against the plain
     version in every mLSTM block, the logits' relative difference under
     DEPTH_TOL and within DEPTH_CONTROL_X of a one-ulp control
  9. xLSTM parity at full width, 8 blocks, f32: card (kernels) against CPU
     (plain versions), the same weights and planted cache faults

Prints the kernel report as one JSON line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line.  Exits
non-zero without that line when no card is visible or the package is
missing.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,  # dense 16-bit TC
              "float32": 67e12}                        # f32 non-TC

# kernel-phase geometry: the Qwen2-1.5B pool of the serving config; prefill
# chunks of C and C_LONG rows (the engine's prompts are 20-100 tokens)
P, L, PG, KH, DH, H, B, M, C = 65, 28, 16, 2, 128, 12, 4, 8, 64
C_LONG = 100
NULL = P - 1
LAYER = 5
# float tolerances, kernel vs plain version on the same card:
#   f32  — both accumulate in f32 but sum in different orders (the kernel
#          sequentially per thread, the plain version through cuBLAS)
#   bf16 — outputs are bf16 (one ulp near 1 is 2^-8), and softmax weights
#          are rounded to bf16 before the value product, where an f32
#          difference in the last place can flip one rounding
#   f16  — f16 outputs (one ulp near 1 is 2^-10) and weights rounded to
#          f16 on flash_attention's wgmma route (tests/test_torch_cuda.py's)
TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 1e-2}
# a neighbor_mean lane, kernel (tile_fill's table) vs plain version
# (common.tile_means): the two sum a tile in different orders, so the mean
# may differ in its last place; the reference scrub tests' tolerance
NM_FILL_TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
               "bfloat16": dict(rtol=1e-2, atol=1e-6),
               "float16": dict(rtol=1e-2, atol=1e-6)}


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


def device_profile(fn, table: str = "", counts: dict | None = None):
    """Device milliseconds by kernel name for one call of ``fn`` under
    ``torch.profiler`` (empty when the profiler records no device time).
    With ``table``, host and device activity are both recorded and their
    summary tables written to ``chiprun_out/<table>``; with ``counts``, the
    number of launches recorded per name is added to it."""
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
            if counts is not None:
                counts[evt.key] = counts.get(evt.key, 0) + evt.count
    return per


def queued_ms(fn, iters: int = 10) -> float:
    """Milliseconds per call of ``fn`` launched ``iters`` times back to
    back between two CUDA events: with the queue kept full, the device
    time per call (host work per call must be shorter than the kernel)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, names, iters: int = 20):
    """Device time per call of the named kernels (several launches of one
    wrapper summed), or None when the profiler records no device time."""
    total = sum(kernel_breakdown(fn, names, iters).values())
    return total or None


def kernel_breakdown(fn, names, iters: int = 20, tries: int = 3,
                     per_launch: bool = False) -> dict:
    """Device ms per call of each named kernel (0.0 where none ran), or with
    ``per_launch`` per launch of it.  The profiler can drop a window's
    device events (it does for millisecond kernels).  Per call, a window
    counts only when it recorded some and every kernel's launches are a
    multiple of ``iters``; per launch, the average over the launches it
    recorded is unbiased, so a window counts when every named kernel
    recorded one.  Otherwise it is taken again, up to ``tries`` times."""
    fn()
    for _ in range(tries):
        counts: dict = {}
        per = device_profile(lambda: [fn() for _ in range(iters)], counts=counts)
        keys = {n: [k for k in per if n in k] for n in names}
        if per_launch:
            launches = {n: sum(counts[k] for k in keys[n]) for n in names}
            if all(launches.values()):
                return {n: sum(per[k] for k in keys[n]) / launches[n]
                        for n in names}
        elif counts and all(c % iters == 0 for c in counts.values()):
            return {n: sum(per[k] for k in keys[n]) / iters for n in names}
    raise AssertionError(f"the profiler dropped device events in {tries} "
                         f"windows of {iters} calls: {counts}")


KERNEL_NAMES = {
    "scrub": ("scrub_stream",),
    # walk route: partials + merge; fused route: one kernel (+ a memset)
    "paged_decode": ("decode_partials", "lse_merge", "decode_fused"),
    # FFMA route: partials; wgmma route: scan + wgmma
    "paged_prefill": ("prefill_partials", "prefill_scan", "prefill_repair_wgmma"),
    # FFMA route: tiles + counts; wgmma route: scan + wgmma + counts
    "repair_matmul": ("repair_mm_tiles", "repair_mm_scan", "repair_mm_wgmma",
                      "repair_mm_counts"),
    # FFMA route: count_tiles + counts + fwd; wgmma route: scan + wgmma + counts
    "flash_attention": ("flash_repair_fwd", "flash_count_tiles", "flash_scan",
                        "flash_repair_wgmma", "flash_counts"),
    # FFMA route: qk + scan; wgmma route: prep + scan_wgmma ("mlstm_scan"
    # matches both scans)
    "mlstm_chunk": ("mlstm_qk", "mlstm_prep", "mlstm_scan"),
    "tile_fill": ("tile_fill",),
}
# the mLSTM routes' kernels, named apart for their device-time split
MLSTM_KERNELS = {"ffma": ("mlstm_qk", "mlstm_scan<"),
                 "wgmma": ("mlstm_prep_wgmma", "mlstm_scan_wgmma")}
# the attention wgmma route's fault scan, timed apart (its extra K/V read)
COUNT_PASS = ("flash_scan",)


def device_ops(fn, iters: int = 20, tries: int = 3):
    """(device ms, device operations) per call of ``fn`` over every kernel,
    memset and copy the profiler records, and their names; a window counts
    only when every operation's count is a multiple of ``iters``."""
    fn()
    for _ in range(tries):
        counts: dict = {}
        per = device_profile(lambda: [fn() for _ in range(iters)], counts=counts)
        if counts and all(c % iters == 0 for c in counts.values()):
            return (sum(per.values()) / iters, sum(counts.values()) / iters,
                    sorted(per))
    raise AssertionError(f"the profiler dropped device events in {tries} "
                         f"windows of {iters} calls: {counts}")


def bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 2
def kernel_phase(report: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.core import detect
    from repro_torch.kernels import common, tile_fill
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import scrub as sk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    report["nm_launches"] = collections.Counter()
    report["nm_err"] = nm_err = dict(tile_fill=0.0, paged=0.0, scrub=0.0,
                                     repair_matmul=0.0, flash_attention=0.0,
                                     mlstm_chunk=0.0)
    n_real = [8, 5, 3, 1]
    cols = PG * KH * DH                 # one page of one layer: its nm tile
    layer_view = dict(row_stride=L * cols, offset=LAYER * cols)
    perm = torch.randperm(P - 1, generator=gen, device=dev).tolist()
    bt_rows, cursor = [], 0
    for n in n_real:
        bt_rows.append(perm[cursor:cursor + n] + [NULL] * (M - n))
        cursor += n
    bt = torch.tensor(bt_rows, dtype=torch.int32, device=dev)
    pos = torch.tensor([n * PG - 3 for n in n_real], dtype=torch.int32, device=dev)
    q_starts = {c: torch.tensor([max(0, n * PG - c) for n in n_real],
                                dtype=torch.int32, device=dev) for c in (C, C_LONG)}
    scrub_ids = [bt_rows[0][1], bt_rows[1][0], NULL]

    def fresh(dtype, nm=False):
        """The pools, decode q and prefill chunks, planted.  With ``nm``,
        the neighbor_mean operands: each page of the layer carries its own
        offset (the page is one logical tile), and request 3, whose lanes
        all sit in one page (page p3, offset NM_OFFSETS[0] > 0), gets lanes
        a wrong fill must move: V lane 5 of KV head 0 NaN in every slot
        (its output lane there is V's fill, whatever the weights), K of
        slot 1 of KV head 1 NaN in every lane, and q of that head group
        biased against p3's sign (p3's keys score alike with the right
        fill; slot 1 takes the row over with a zero or negative one)."""
        g = torch.Generator(device=dev).manual_seed(1)
        kp = torch.randn((P, L, PG, KH, DH), generator=g, device=dev)
        vp = torch.randn((P, L, PG, KH, DH), generator=g, device=dev)
        if nm:
            for t in (kp, vp):
                t[:, LAYER] += _tile_offsets(P, cols, (1, cols), dev,
                                             first=bt_rows[3][0]).view(
                    P, PG, KH, DH)
        kp, vp = kp.to(dtype), vp.to(dtype)
        plant = [
            (kp, (bt_rows[0][1], LAYER, 3, 0, 10), float("nan")),
            (kp, (bt_rows[1][0], LAYER, 0, 1, 100), float("inf")),
            (vp, (bt_rows[2][2], LAYER, 7, 1, 5), float("-inf")),
            (vp, (NULL, LAYER, 0, 0, 0), float("nan")),
            (kp, (NULL, LAYER, 2, 1, 9), 3.0e4),           # range guard
            (vp, (bt_rows[0][3], LAYER, 5, 0, 1), -5.0e3),  # range guard
            (kp, (bt_rows[3][0], LAYER, 1, 0, 2), 3.0),     # bit pattern
            (vp, (bt_rows[0][1], LAYER, 4, 1, 7), 3.0),     # bit pattern
            # the last page of request 0: dead for its first prefill row
            # blocks, live for the last
            (kp, (bt_rows[0][7], LAYER, 0, 1, 11), float("nan")),
            (vp, (bt_rows[0][7], LAYER, 1, 0, 12), float("nan")),
        ]
        for t, idx, val in plant:
            t[idx] = val
        q = torch.randn((B, H, DH), generator=g, device=dev)
        qcs = {c: torch.randn((B, c, H, DH), generator=g, device=dev)
               for c in (C, C_LONG)}
        if nm:
            p3 = bt_rows[3][0]
            vp[p3, LAYER, :, 0, 5] = float("nan")
            kp[p3, LAYER, 1, 1, :] = float("nan")
            q[3, H // KH:] -= 1.0
            for qc in qcs.values():
                qc[3, :, H // KH:] -= 1.0
        return (kp, vp, q.to(dtype),
                {c: qc.to(dtype) for c, qc in qcs.items()})

    def errs(a, b):
        return float((a.float() - b.float()).abs().nan_to_num(0.0).max())

    def same(a, b, what):
        if not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"{what}: integer outputs differ\n{a}\n{b}")

    def close_nonfinite(out, ref, tol, what):
        """Non-finite lanes exactly where the plain version's are, the
        finite ones within the tolerance, equal Inf where both are Inf;
        returns how many lanes are NaN in one and ±Inf in the other (an
        infinite V lane gives Inf where p > 0 and NaN where p rounds to 0,
        and p may be rounded against another running max than the plain
        version's)."""
        out, ref = out.float(), ref.float()
        fin = ref.isfinite()
        same(out.isfinite(), fin, f"finite lanes {what}")
        torch.testing.assert_close(out[fin], ref[fin], rtol=tol, atol=tol)
        both_inf = out.isinf() & ref.isinf()
        same(out[both_inf], ref[both_inf], f"Inf lanes {what}")
        return int((out.isnan() != ref.isnan()).sum())

    # 16-bit pools take the prefill's wgmma route, f32 its FFMA route; a
    # 16-bit q off 16-byte alignment takes the FFMA route
    want_route = {torch.float32: "ffma", torch.bfloat16: "wgmma",
                  torch.float16: "wgmma"}
    max_err = {"scrub": 0.0, "paged_decode": 0.0, "paged_prefill": 0.0,
               "decode_own_partition": 0.0}

    def check_prefill(dtype, label, kw, kp, vp, qcs):
        """Prefill against its plain version at C and C_LONG, and for
        16-bit pools with q 2 bytes off alignment at C: integer outputs
        equal, outputs within the tolerance (NaN where the plain version's
        are), on the expected route.  Returns the ``kernels ok`` parts."""
        name = str(dtype).split(".")[-1]
        cases = [(f"C={c}", qc, q_starts[c], want_route[dtype])
                 for c, qc in qcs.items()]
        if dtype != torch.float32:
            cases.append((f"C={C} q-off", _at_offset(qcs[C], 1), q_starts[C],
                          "ffma"))
        parts = []
        for what, qc, qs, want_r in cases:
            prefill_route = pa.route(qc, kp, vp)
            if prefill_route != want_r:
                raise AssertionError(f"prefill {name} {what} took the "
                                     f"{prefill_route} route")
            got = pa.paged_prefill_raw(qc, kp, vp, bt, qs, LAYER, **kw)
            want = pa.paged_prefill_plain(qc, kp, vp, bt, qs, LAYER, **kw)
            same(got[1], want[1], f"prefill slot_counts {name} {label} {what}")
            same(got[2], want[2], f"prefill counts {name} {label} {what}")
            # finite outputs unless V lanes were left non-finite
            fin = want[0].float().isfinite()
            if bool(fin.all()) == (label == "v-off"):
                raise AssertionError(f"prefill {name} {label} {what}: "
                                     f"finite outputs not as expected")
            # the wgmma route rounds p per tile, not per page
            nan_inf = close_nonfinite(got[0], want[0], TOL[name],
                                      f"prefill {name} {label} {what}")
            max_err["paged_prefill"] = max(max_err["paged_prefill"],
                                           errs(got[0], want[0]))
            part = f"{what} ({prefill_route}) {got[2].tolist()}"
            if label == "v-off":
                part += f" non-finite {int((~fin).sum())}, NaN vs Inf {nan_inf}"
            parts.append(part)
        return parts

    def check_decode(dtype, label, kw, kp, vp, q):
        """Decode against its plain version at splits 1 and 4 on the fused
        route, and with q 2 bytes off alignment (4 for f32) at splits 4 on
        the walk route: integer outputs equal, outputs within the tolerance
        (non-finite lanes where the plain version's are).  Returns the
        ``kernels ok`` parts."""
        name = str(dtype).split(".")[-1]
        parts = []
        for what, qd, splits, want_r in (("s=1", q, 1, "fused"),
                                         ("s=4", q, 4, "fused"),
                                         ("s=4 q-off", _at_offset(q, 1), 4, "walk")):
            decode_route = pa.decode_route(qd, kp, vp)
            if decode_route != want_r:
                raise AssertionError(f"decode {name} {what} took the "
                                     f"{decode_route} route")
            got = pa.paged_attention_splitk_raw(qd, kp, vp, bt, pos, LAYER,
                                                splits=splits, **kw)
            want = pa.paged_decode_plain(qd, kp, vp, bt, pos, LAYER,
                                         splits=splits, **kw)
            same(got[1], want[1], f"decode slot_counts {name} {label} {what}")
            same(got[2], want[2], f"decode counts {name} {label} {what}")
            if int(got[2][6]) == 0:
                raise AssertionError("decode saw none of the planted lanes")
            fin = want[0].float().isfinite()
            if bool(fin.all()) == (label == "v-off"):
                raise AssertionError(f"decode {name} {label} {what}: finite "
                                     f"outputs not as expected")
            nan_inf = close_nonfinite(got[0], want[0], TOL[name],
                                      f"decode {name} {label} {what}")
            max_err["paged_decode"] = max(max_err["paged_decode"],
                                          errs(got[0], want[0]))
            if decode_route == "fused":
                # the plain twin of the kernel's own partition rounds p
                # against the same running maxima
                twin = pa.paged_decode_fused_plain(qd, kp, vp, bt, pos, LAYER, **kw)
                same(got[1], twin[1], f"decode twin slot_counts {name} {label}")
                close_nonfinite(got[0], twin[0], TOL[name],
                                f"decode twin {name} {label} {what}")
                max_err["decode_own_partition"] = max(
                    max_err["decode_own_partition"], errs(got[0], twin[0]))
            part = f"{what} ({decode_route})"
            if label == "v-off":
                part += f" non-finite {int((~fin).sum())}, NaN vs Inf {nan_inf}"
            parts.append(part)
        return parts, got[2].tolist()

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        name = str(dtype).split(".")[-1]
        configs = [
            ("default", dict(detector_k="default", detector_v="default",
                             policy="zero")),
            ("range+bitpattern", dict(detector_k=_det2(dtype), detector_v=_det2(dtype),
                                      policy_k="zero", policy_v="constant",
                                      constant_v=0.5)),
        ]
        for label, kw in configs:
            kp, vp, q, qcs = fresh(dtype)
            decode_parts, decode_counts = check_decode(dtype, label, kw, kp, vp, q)
            routes = check_prefill(dtype, label, kw, kp, vp, qcs)
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
            log(f"kernels ok  dtype={name} detector={label} decode "
                f"{'; '.join(decode_parts)} {decode_counts} prefill "
                f"{'; '.join(routes)} scrub_counts={c_kernel.tolist()}")
        # V detection off: the planted V lanes stay non-finite and reach
        # every row of their KV head through 0 x NaN, rows that mask them
        # too (request 0's last page, dead for its early row blocks, among
        # them); every route must put them where the plain version does
        kp, vp, q, qcs = fresh(dtype)
        decode_parts, _ = check_decode(dtype, "v-off", dict(detector_v=None),
                                       kp, vp, q)
        routes = check_prefill(dtype, "v-off", dict(detector_v=None), kp, vp, qcs)
        log(f"kernels ok  dtype={name} detector=v-off decode "
            f"{'; '.join(decode_parts)} prefill {'; '.join(routes)}")
        a, b = vp.clone(), vp.clone()
        same(sk.scrub(a)[1], sk.scrub_plain(b)[1], f"scrub counts {name}")
        same(detect.bits_of(a), detect.bits_of(b), f"scrub bits {name}")

    # ---- neighbor_mean on the engine pool's paged calls: each page's mean
    # over both KV heads from tile_fill's per-page table, on every decode
    # and prefill route, and the page scrub's gathered tiles; kernel calls
    # counted apart, plain versions, tables and controls compared outside
    # the count
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        kp, vp, q, qcs = fresh(dtype, nm=True)
        table_err = 0.0
        for pool in (kp, vp):
            for d in (None, _det2(dtype)):
                consts = common.detector_operand(common.resolve_detector(d, True),
                                                 dtype)
                got_t = tile_fill.tile_fill(pool, P, cols, (1, cols), consts,
                                            **layer_view)
                want_t = tile_fill.tile_fill_plain(pool, P, cols, (1, cols),
                                                   consts, **layer_view)
                table_err = max(table_err, errs(tile_fill.values(got_t, dtype),
                                                tile_fill.values(want_t, dtype)))
        nm_err["tile_fill"] = max(nm_err["tile_fill"], table_err)
        for label, kw, zero_kw, tabled in (
                ("both", dict(policy="neighbor_mean"), dict(policy="zero"),
                 dict(K=kp, V=vp)),
                ("k-only range+bitpattern",
                 dict(detector_k=_det2(dtype), detector_v=_det2(dtype),
                      policy_k="neighbor_mean", policy_v="zero"),
                 dict(policy_k="zero"), dict(K=kp))):
            decode_cases = [("s=4", q, 4, "fused"), ("s=1", q, 1, "fused"),
                            ("s=4 q-off", _at_offset(q, 1), 4, "walk")]
            prefill_cases = [(f"C={c}", qc, q_starts[c], want_route[dtype])
                             for c, qc in qcs.items()]
            if dtype != torch.float32:
                prefill_cases.append((f"C={C} q-off", _at_offset(qcs[C], 1),
                                      q_starts[C], "ffma"))

            def call(case, **over):
                _, x, arg, _ = case
                if x.dim() == 3:
                    return pa.paged_attention_splitk_raw(
                        x, kp, vp, bt, pos, LAYER, splits=arg, **{**kw, **over})
                return pa.paged_prefill_raw(x, kp, vp, bt, arg, LAYER,
                                            **{**kw, **over})

            cases = decode_cases + prefill_cases
            common.reset_launches()
            got = [call(case) for case in cases]
            report["nm_launches"].update(common.LAUNCHES)
            want = [pa.paged_decode_plain(qd, kp, vp, bt, pos, LAYER,
                                          splits=s_, **kw)
                    for _, qd, s_, _ in decode_cases]
            want += [pa.paged_prefill_plain(qc, kp, vp, bt, qs, LAYER, **kw)
                     for _, qc, qs, _ in prefill_cases]
            parts, out_err, controls = [], 0.0, {}
            for case, g, w in zip(cases, got, want):
                what, x, _, want_r = case
                routed = (pa.decode_route(x, kp, vp) if x.dim() == 3
                          else pa.route(x, kp, vp))
                if routed != want_r:
                    raise AssertionError(f"nm {name} {what} took {routed}")
                same(g[1], w[1], f"nm slot_counts {name} {label} {what}")
                same(g[2], w[2], f"nm counts {name} {label} {what}")
                close_nonfinite(g[0], w[0], TOL[name], f"nm {name} {label} {what}")
                out_err = max(out_err, errs(g[0], w[0]))
                parts.append(f"{what} ({routed})")
                for k_, r_ in _nm_controls(
                        lambda case=case, **o: call(case, **o), tabled, zero_kw,
                        lambda out, w=w: _tol_ratio(out[0], w[0], TOL[name],
                                                    TOL[name])).items():
                    controls[k_] = min(controls.get(k_, float("inf")), r_)
            nm_err["paged"] = max(nm_err["paged"], out_err)
            log(f"nm ok  kernels dtype={name} fill={label} decode+prefill "
                f"{'; '.join(parts)} counts {got[0][2].tolist()} / "
                f"{got[3][2].tolist()}, max_abs_err outputs {out_err:.3g}, "
                f"page fills (table vs plain) {table_err:.3g}; controls, the "
                f"least over the routes: {_fmt_controls(controls)}")
        # the page scrub, 3 unique ids, on a copy of the K pool whose
        # gathered view's logical tiles carry their own offsets
        ids = [bt_rows[0][1], bt_rows[1][0], NULL]
        _, rpp, s_cols, _, s_block, _ = sk._pages_args(kp, ids, True, None,
                                                        None, 0)
        base = kp.clone()
        base[ids] = (base[ids].float() + _tile_offsets(
            len(ids) * rpp, s_cols, s_block, dev).view(base[ids].shape)).to(dtype)
        a, b = base.clone(), base.clone()
        fatal = torch.zeros_like(a, dtype=torch.bool)
        nan_m, inf_m = common.fatal_masks(a, common.detector_operand(
            common.resolve_detector(None, True), dtype))
        fatal[ids] = (nan_m | inf_m)[ids]
        common.reset_launches()
        _, c_kernel = sk.scrub_pages(a, ids, policy="neighbor_mean")
        report["nm_launches"].update(common.LAUNCHES)
        _, c_plain = sk.scrub_pages_plain(b, ids, policy="neighbor_mean")
        same(c_kernel, c_plain, f"nm scrub_pages counts {name}")
        same(detect.bits_of(a)[~fatal], detect.bits_of(b)[~fatal],
             f"nm scrub_pages untouched lanes {name}")
        lane_err = errs(a[fatal], b[fatal])
        torch.testing.assert_close(a[fatal].float(), b[fatal].float(),
                                   **NM_FILL_TOL[name])
        nm_err["scrub"] = max(nm_err["scrub"], lane_err)

        def scrub_call(**over):
            x = base.clone()
            with contextlib.ExitStack() as stack:
                if over.pop("rolled", False):
                    stack.enter_context(_rolled_table(x))
                sk.scrub_pages(x, ids, **{"policy": "neighbor_mean", **over})
            return x

        readings = {"zero": _tol_ratio(scrub_call(policy="zero")[fatal],
                                       b[fatal], **NM_FILL_TOL[name]),
                    "rolled": _tol_ratio(scrub_call(rolled=True)[fatal],
                                         b[fatal], **NM_FILL_TOL[name])}
        if not min(readings.values()) > 1.0:
            raise AssertionError(f"nm scrub_pages controls passed: {readings}")
        log(f"nm ok  scrub_pages dtype={name} 3 pages: counts "
            f"{c_kernel.tolist()}, repaired lanes max_abs_err {lane_err:.3g} "
            f"(rtol, atol {NM_FILL_TOL[name]}), others bit-equal; controls "
            f"{_fmt_controls(readings)}")

    # ---- timings at the main path's shapes (bf16 pool, layer LAYER) ----
    dtype, name = torch.bfloat16, "bfloat16"
    es = 2
    kp, vp, q, qcs = fresh(dtype)
    kw = dict(detector_k="default", detector_v="default", policy="zero")
    page_bytes = PG * KH * DH * es
    visited = len({p for row in bt_rows for p in row})
    t_keys = M * PG
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library_times(fn):
        """(call ms, device ms) of one PyTorch call."""
        return cuda_ms(fn), kernel_device_ms(fn, ("",))

    # decode at splits 4 (the engine's) and 1 (the serial entry point, off
    # the main path at M = 8), on the fused route: device time split into
    # the kernel and the counts' memset, on the planted pool (K of slots 1
    # of request 0 and 0 of request 1, V of slot 2 of request 2 and of the
    # null page hold NaN/Inf) and on a clean copy; the walk route on the
    # same operands (q 2 bytes off alignment)
    kc, vc = (x.nan_to_num(0.0, 0.0, 0.0) for x in (kp, vp))
    q_off = _at_offset(q, 1)
    if pa.decode_route(q, kp, vp) != "fused" or pa.decode_route(q_off, kp, vp) != "walk":
        raise AssertionError("decode bf16 timing operands are not on the "
                             "fused and walk routes")
    dnames, wnames = ("decode_fused", "Memset"), ("decode_partials", "lse_merge")
    decode = {}
    for splits in (4, 1):
        def dcall(k=kp, v=vp, qd=q, splits=splits):
            return pa.paged_attention_splitk_raw(qd, k, v, bt, pos, LAYER,
                                                 splits=splits, **kw)

        parts = kernel_breakdown(dcall, dnames)
        clean = kernel_breakdown(lambda: dcall(k=kc, v=vc), dnames)
        if not (parts["decode_fused"] > 0 and clean["decode_fused"] > 0):
            raise AssertionError(f"decode splits={splits} ran no fused kernel: "
                                 f"{parts} {clean}")
        decode[splits] = dict(
            ms=cuda_ms(dcall), device_ms=sum(parts.values()), parts=parts,
            clean=clean,
            clean_ms=cuda_ms(lambda: dcall(k=kc, v=vc)),
            walk=kernel_breakdown(lambda: dcall(qd=q_off), wnames),
            walk_ms=cuda_ms(lambda: dcall(qd=q_off)),
            plain_ms=cuda_ms(lambda splits=splits: pa.paged_decode_plain(
                q, kp, vp, bt, pos, LAYER, splits=splits, **kw)))
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
    decode_lib_ms, decode_lib_dev = library_times(
        lambda: sdpa(q[:, :, None, :], kg, vg, attn_mask=mask))

    # prefill, request 0 alone (B = 1: 8 pages, the chunk ending at its
    # context's end), at C and C_LONG: the wgmma route's device time split
    # into scan, main kernel and the counts' memset, on the planted pool
    # (3 of the 8 pages flagged: K of slots 1 and 7, V of slot 7) and on a
    # clean copy, beside SDPA's device and call times; the FFMA kernel on
    # the same bf16 operands (q 2 bytes off alignment) at C
    pnames = ("prefill_scan", "prefill_repair_wgmma", "Memset")
    prefill = {}
    for c, qc in qcs.items():
        qc1, qs1 = qc[:1], q_starts[c][:1]
        if pa.route(qc1, kp, vp) != "wgmma":
            raise AssertionError(f"prefill bf16 C={c} is not on the wgmma route")

        def call(qc1=qc1, qs1=qs1, k=kp, v=vp):
            return pa.paged_prefill_raw(qc1, k, v, bt[:1], qs1, LAYER, **kw)

        parts = kernel_breakdown(call, pnames)
        if not parts["prefill_repair_wgmma"] > 0:
            raise AssertionError(f"prefill bf16 C={c} ran no wgmma kernel: {parts}")
        clean = kernel_breakdown(lambda: call(k=kc, v=vc), pnames)
        qs0 = int(qs1[0])
        p_valid = sum(min(qs0 + r + 1, t_keys) for r in range(c)) * H
        nbytes = (2 * c * H * DH * es + 2 * M * page_bytes + M * 4 * 2 + 4 + 32)
        p_bound, p_by = bound(nbytes, 4.0 * DH * p_valid, name)
        cmask = (torch.arange(t_keys, device=dev)[None, :]
                 <= (qs0 + torch.arange(c, device=dev))[:, None])
        lib_ms, lib_dev = library_times(lambda qc1=qc1, cmask=cmask: sdpa(
            qc1.transpose(1, 2), kg[:1], vg[:1], attn_mask=cmask))
        prefill[c] = dict(
            ms=cuda_ms(call), plain_ms=cuda_ms(lambda qc1=qc1, qs1=qs1:
                                               pa.paged_prefill_plain(
                                                   qc1, kp, vp, bt[:1], qs1, LAYER,
                                                   **kw)),
            device_ms=sum(parts.values()), parts=parts, clean=clean,
            clean_ms=cuda_ms(lambda: call(k=kc, v=vc)), bound_ms=p_bound,
            bound_by=p_by, library_ms=lib_ms, library_device_ms=lib_dev)
    qc_off = _at_offset(qcs[C][:1], 1)
    if pa.route(qc_off, kp, vp) != "ffma":
        raise AssertionError("prefill bf16 q view off alignment is not on FFMA")

    def ffma_call():
        return pa.paged_prefill_raw(qc_off, kp, vp, bt[:1], q_starts[C][:1],
                                    LAYER, **kw)

    ffma = dict(ms=cuda_ms(ffma_call),
                device_ms=kernel_device_ms(ffma_call, KERNEL_NAMES["paged_prefill"]))

    # neighbor_mean at the engine pool: tile_fill over the layer (the paged
    # calls' per-page table) and the fused decode at splits 4 with the mean
    # against the zero fill, device time a call (all device operations)
    consts = common.detector_operand(common.resolve_detector(None, True), dtype)
    report["tile_fill_pool"] = dict(
        device_ms=kernel_device_ms(lambda: tile_fill.tile_fill(
            kp, P, cols, (1, cols), consts, **layer_view), ("tile_fill",)),
        bound_ms=(P * cols * es + P * 4) / HBM_BYTES_PER_S * 1e3,
        **{f"{fill}_ms": device_ops(lambda fill=fill: pa.paged_attention_splitk_raw(
            q, kp, vp, bt, pos, LAYER, splits=4, policy=fill))[0]
           for fill in ("neighbor_mean", "zero")})

    # (a) the engine's page scrub: 2 pages of the bf16 pool, n_valid 2
    ids2 = [bt_rows[0][1], bt_rows[1][0]]
    scr = kp.clone()

    def page_scrub():
        return sk.scrub_pages(scr, ids2, n_valid=2)

    scrub_ms = cuda_ms(page_scrub)
    scrub_plain_ms = cuda_ms(lambda: sk.scrub_pages_plain(scr, ids2, n_valid=2))
    row_bytes = L * page_bytes
    s_bound, s_by = bound(len(ids2) * row_bytes + 12, len(ids2) * row_bytes / es,
                          name)
    s_dev, s_ops, s_names = device_ops(page_scrub)
    if s_ops != 1 or not all("scrub_stream" in n for n in s_names):
        raise AssertionError(f"the page scrub ran {s_ops} device operations a "
                             f"call: {s_names}")
    ids_np = np.asarray(ids2 + ids2[:1] * 2, np.int64)   # bucketed to 4
    t0 = time.perf_counter()
    for _ in range(10000):
        sk.live_ids(ids_np, 2)
    check_us = (time.perf_counter() - t0) / 10000 * 1e6
    del scr
    cache = scrub_cache_timing()
    pc = prefill[C]
    report["kernels"] = {
        "scrub": dict(
            route="cuda", source="src/repro_torch/csrc/scrub.cu",
            replaces="src/repro/kernels/scrub.py:38 (_scrub_kernel)",
            max_abs_err=max_err["scrub"], ms=scrub_ms, plain_ms=scrub_plain_ms,
            bound_ms=s_bound, bound_by=s_by, library_ms=None,
            device_ms=s_dev, device_ops_per_call=s_ops, id_check_us=check_us,
            cache_device_ms=cache["clean_ms"],
            cache_planted_device_ms=cache["planted_ms"],
            cache_bound_ms=cache["bound_ms"], cache_gb_per_s=cache["gb_per_s"],
        ),
        "paged_decode": dict(
            route="cuda", source="src/repro_torch/csrc/paged_decode.cu",
            replaces=("src/repro/kernels/paged_attention.py:147 (_paged_kernel) "
                      "and :633 (_paged_splitk_kernel, merge _lse_merge :131)"),
            max_abs_err=max_err["paged_decode"], ms=decode[4]["ms"],
            plain_ms=decode[4]["plain_ms"], bound_ms=d_bound, bound_by=d_by,
            library_ms=decode_lib_ms, library_device_ms=decode_lib_dev,
            device_ms=decode[4]["device_ms"], kernel_route="fused",
            max_abs_err_own_partition=max_err["decode_own_partition"],
        ),
        "paged_prefill": dict(
            route="cuda", source="src/repro_torch/csrc/paged_prefill.cu",
            replaces="src/repro/kernels/paged_attention.py:362 (_paged_prefill_kernel)",
            max_abs_err=max_err["paged_prefill"], ms=pc["ms"],
            plain_ms=pc["plain_ms"], bound_ms=pc["bound_ms"],
            bound_by=pc["bound_by"], library_ms=pc["library_ms"],
            library_device_ms=pc["library_device_ms"], device_ms=pc["device_ms"],
            kernel_route="wgmma",
        ),
    }
    for k, v in report["kernels"].items():
        log(f"timing {k}: call {v['ms']:.4f} ms (device {v['device_ms']}), "
            f"plain {v['plain_ms']:.4f} ms, "
            f"bound {v['bound_ms']:.5f} ms ({v['bound_by']}), library call "
            f"{v['library_ms']} ms (device {v.get('library_device_ms')}), "
            f"max_abs_err {v['max_abs_err']}")
    log(f"timing scrub (a) engine page scrub, 2 pages bf16: device {s_dev:.4f} "
        f"ms in {s_ops:g} device operation(s) a call ({', '.join(s_names)}), "
        f"call {scrub_ms:.4f} ms, bound {s_bound:.6f} ms ({s_by}), id check "
        f"{check_us:.2f} us; (b) mlstm_groups/C {CACHE_C} f32 whole buffer: "
        f"device clean {cache['clean_ms']:.4f} ms (profiler "
        f"{cache['clean_profiled_ms']:.4f}), planted "
        f"{cache['planted_ms']:.4f} ms, call {cache['call_ms']:.4f} ms, bound "
        f"{cache['bound_ms']:.4f} ms (bytes), {cache['bound_ms'] / cache['clean_ms']:.3f} "
        f"of the bound, {cache['gb_per_s']:.1f} GB/s; planted counts "
        f"{cache['counts']} equal to scrub_plain's, bits equal")
    log(f"paged_decode max_abs_err against the plain version at the same "
        f"splits {max_err['paged_decode']}, against the plain twin of the fused "
        f"route's own partition {max_err['decode_own_partition']}")
    for splits, dc in decode.items():
        for label, pt, ms in (("planted", dc["parts"], dc["ms"]),
                              ("clean", dc["clean"], dc["clean_ms"])):
            log(f"timing paged_decode splits={splits} bf16 {label} (fused route): "
                f"device {sum(pt.values()):.4f} ms = decode_fused "
                f"{pt['decode_fused']:.4f} + memset {pt['Memset']:.4f}; call "
                f"{ms:.4f} ms; bound {d_bound:.6f} ms ({d_by}); SDPA device "
                f"{decode_lib_dev} ms, call {decode_lib_ms:.4f} ms; plain "
                f"{dc['plain_ms']:.4f} ms")
        wk = dc["walk"]
        log(f"timing paged_decode splits={splits} bf16 planted (walk route, q 2 "
            f"bytes off alignment): device {sum(wk.values()):.4f} ms = "
            f"decode_partials {wk['decode_partials']:.4f} + lse_merge "
            f"{wk['lse_merge']:.4f}; call {dc['walk_ms']:.4f} ms")
    for c, pr in prefill.items():
        for label, pt, ms in (("planted", pr["parts"], pr["ms"]),
                              ("clean", pr["clean"], pr["clean_ms"])):
            log(f"timing paged_prefill C={c} bf16 {label} (wgmma route): device "
                f"{sum(pt.values()):.4f} ms = scan {pt['prefill_scan']:.4f} + "
                f"wgmma {pt['prefill_repair_wgmma']:.4f} + memset "
                f"{pt['Memset']:.4f}; call {ms:.4f} ms; bound "
                f"{pr['bound_ms']:.6f} ms ({pr['bound_by']}); SDPA device "
                f"{pr['library_device_ms']} ms, call {pr['library_ms']:.4f} ms; "
                f"plain {pr['plain_ms']:.4f} ms")
    log(f"timing paged_prefill C={C} bf16 (ffma route, q 2 bytes off "
        f"alignment): device {ffma['device_ms']} ms, call {ffma['ms']:.4f} ms")
    log(f"timing shapes: decode B=4 M=8 splits=4 bf16; prefill B=1 M=8 "
        f"C={C} and C={C_LONG} bf16; scrub_pages 2 pages bf16 (one Qwen2-1.5B "
        f"layer each for attention); ms = CUDA events around one wrapper call "
        f"(host work included), device = profiler kernel time per call; "
        f"library = SDPA over the gathered, repaired view")


# the xLSTM cache's mLSTM C at xlstm-1.3b width, batch 4 (6 groups of 7
# blocks, 4 heads, head dim 1024), f32: the scrub's bandwidth-bound caller;
# lanes planted in it: the first and last lane, two in one logical tile,
# and a few more, NaN and ±Inf
CACHE_C = (6, 7, 4, 4, 1024, 1024)
CACHE_PLANTS = (0, 1, 513, 1 << 20, 123456789, 700000000, -1)


def scrub_cache_timing() -> dict:
    """Shape (b): the whole-buffer scrub of ``CACHE_C`` (2.82 GB, above L2)
    held bit for bit and count for count against ``scrub_plain`` on the
    same planted input, then timed clean (CUDA events around a queue of
    calls, and the profiler per launch) and planted (the profiler per
    launch of the kernel; each call re-plants first)."""
    import gc

    import torch

    from repro_torch.core import detect
    from repro_torch.kernels import scrub as sk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    c = torch.randn(CACHE_C, generator=gen, device=dev)
    flat = c.view(-1)
    idx = torch.tensor([i % flat.numel() for i in CACHE_PLANTS], device=dev)
    vals = torch.tensor([float("nan"), float("inf"), float("-inf")] * 3,
                        device=dev)[:idx.numel()]

    def plant():
        flat[idx] = vals

    plant()
    ref = c.clone()
    got = sk.scrub(c)[1]
    want = sk.scrub_plain(ref)[1]
    if not torch.equal(got.cpu(), want.cpu()) or int(got[0] + got[1]) != idx.numel():
        raise AssertionError(f"cache scrub counts {got.tolist()}, plain "
                             f"{want.tolist()}")
    if not torch.equal(detect.bits_of(c), detect.bits_of(ref)):
        raise AssertionError("cache scrub bits differ from scrub_plain's")
    counts = got.tolist()
    del ref, want
    gc.collect()
    torch.cuda.empty_cache()
    if sk.scrub(c)[1].tolist() != [0, 0, 0]:
        raise AssertionError("the scrubbed cache still counts fatal lanes")
    nbytes = c.numel() * c.element_size()
    names = KERNEL_NAMES["scrub"]
    clean_ms = min(queued_ms(lambda: sk.scrub(c)) for _ in range(2))
    profiled = kernel_breakdown(lambda: sk.scrub(c), names, iters=5,
                                per_launch=True)
    planted = kernel_breakdown(lambda: (plant(), sk.scrub(c)), names, iters=5,
                               per_launch=True)
    out = dict(clean_ms=clean_ms, clean_profiled_ms=profiled[names[0]],
               planted_ms=planted[names[0]], call_ms=cuda_ms(lambda: sk.scrub(c),
                                                             iters=10),
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               gb_per_s=nbytes / clean_ms / 1e6, counts=counts, bytes=nbytes)
    del c, flat
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------- phase 2b
# ops-phase geometry (Qwen2-1.5B): the MLP projections of a 2,048-token
# prefill as (M, K, N), and one layer's attention
MM_SHAPES = {"gate_up": (2048, 1536, 8960), "down": (2048, 8960, 1536)}
AT_B, AT_H, AT_KH, AT_S, AT_D = 1, 12, 2, 2048, 128
# output tolerances (rtol, atol), kernel vs plain version on the same card:
#   f32 matmul — both sum K products in f32 in different orders (the plain
#     version through cuBLAS with TF32 off); at K = 8960 and |C| ~ 100 the
#     order alone moves the last few bits
#   bf16 matmul output — one bf16 ulp is 2^-8 of |C|, and an f32 difference
#     in the last place can flip one rounding
#   attention — as the kernel phase's TOL: outputs are convex combinations
#     of V rows (|out| <= max |v|)
MM_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (1e-2, 1e-2)}
# attention, beside the elementwise check: the relative norm
# ||out - plain|| / ||plain|| of each (b, h) over the last LATE_ROWS query
# rows, whose outputs (|out| ~ 0.04 at S = 2048) sit far inside the
# elementwise atol, must stay under LATE_REL_TOL; a control, the plain
# version with the K/V keys DROP_KEYS (one 128-key tile that every late
# row sees) left out, must exceed it.  Limits 3-4x the highest reading of
# the sound kernels on the H100 (f32 1.2e-6; bf16 2.5e-3 on the wgmma
# route, from P rounded to bf16, 1.5e-4 on the FFMA route; f16 3.1e-4),
# against the control's 0.23-0.39 (PERF.md §6, PR 15).
LATE_ROWS = 128
DROP_KEYS = (128, 256)
LATE_REL_TOL = {"float32": 5e-6, "bfloat16": 1e-2, "float16": 1e-3}


def _plant_lanes(x, gen, dtype, big: bool = False):
    """NaN, ±Inf and a bit-pattern value (3.0) at random positions of ``x``
    (in place, before the cast to ``dtype``); with ``big`` also two finite
    values the range guard catches (3e4, -5e3).  Under the default detector
    those would pass into the output and swamp its absolute error."""
    import torch

    flat = x.view(-1)
    vals = [float("nan"), float("inf"), float("-inf"), 3.0, float("nan"), 3.0]
    vals += [3.0e4, -5.0e3] if big else []
    idx = torch.randperm(flat.numel(), generator=gen, device=x.device)
    for i, val in zip(idx[:len(vals)].tolist(), vals):
        flat[i] = val
    return x.to(dtype)


def _det2(dtype):
    """The range-guard + bit-pattern detector of the kernel and ops phases."""
    import torch

    from repro_torch.core import detect
    from repro_torch.core.rules import Detector

    lay = detect.layout_of(dtype)
    three = int(detect.bits_of(torch.tensor([3.0], dtype=dtype))[0])
    mask = (1 << lay.width) - 1
    return Detector(max_magnitude=1e3, bitpatterns=((None, mask, three & mask),))


def _at_offset(x, off: int):
    """A contiguous copy of ``x`` that starts ``off`` elements into its
    storage (off 16-byte alignment for a 16-bit ``x`` and odd ``off``)."""
    import torch

    buf = torch.empty(off + x.numel(), dtype=x.dtype, device=x.device)
    return buf[off:].view(x.shape).copy_(x)


# ---- neighbor_mean operands and their controls.  Every logical tile of an
# operand carries its own offset, NM_OFFSETS[t % 6] for tile t (row-major
# over the tile grid): neighbouring tiles' offsets differ by 5 or more and
# in sign, and none lies within 2 of 0.  A few fatal lanes sit where their
# fill reaches an output lane almost unmixed (a causal row that sees one
# key, a spike in the other operand of a product), so a wrong fill moves an
# output far past the line's tolerance.  Each nm line then runs controls:
# the same kernel call with the zero fill, and with one operand's table
# rolled by one tile (tile t reads tile t+1's entry: a kernel that indexes
# its neighbour).  Each must fail the line's own comparison; its reading is
# the largest |got - want| / (atol + rtol |want|), above 1 to fail.
NM_OFFSETS = (3.0, -2.0, 4.0, -3.0, 2.0, -4.0)
# the partner of a fatal product lane: finite, and below 512, where
# _det2's range guard (a bound on the exponent) starts
NM_SPIKE = 256.0
# f32 products take a quarter of the offsets: MM_TOL's f32 1e-4 / 1e-3 is
# set for summands of order 1, and two f32 sums of 512 terms of order 10
# in different orders differ by ~5e-3 (the plain versions on the CPU:
# 0.85-1.1 of the limit at full offsets, 0.19 at a quarter); a wrong fill
# still reads thousands
NM_F32_MM_SCALE = 0.25


def _tile_offsets(rows, cols, block, dev, scale=1.0, first=0):
    """(rows, cols) f32: NM_OFFSETS[(t - first) % 6] * scale on every lane
    of logical tile t of a (rows, cols) view with tiles ``block``."""
    import torch

    br, bc = block
    gr, gc = rows // br, cols // bc
    t = (torch.arange(gr * gc, device=dev) - first) % len(NM_OFFSETS)
    off = torch.tensor(NM_OFFSETS, device=dev)[t].view(gr, gc) * scale
    return off.repeat_interleave(br, 0).repeat_interleave(bc, 1)


def _tol_ratio(got, want, rtol, atol):
    """assert_close(got, want, rtol, atol) as a number: the largest
    |got - want| / (atol + rtol |want|) over want's finite lanes, inf where
    the two differ in finiteness; above 1 fails."""
    import torch

    got, want = got.float(), want.float()
    fin = want.isfinite()
    if not torch.equal(got.isfinite(), fin):
        return float("inf")
    r = (got[fin] - want[fin]).abs() / (atol + rtol * want[fin].abs())
    return float(r.max()) if r.numel() else 0.0


@contextlib.contextmanager
def _rolled_table(target):
    """Inside, the fill table a kernel wrapper builds for ``target`` (the
    tensor at its data pointer) is rolled by one tile: tile t reads tile
    t+1's entry.  Yields the list of the rolled tables' sizes."""
    import torch

    from repro_torch.kernels import tile_fill

    build = tile_fill.table_or_none
    rolled = []

    def patched(policy, x, *args, **kw):
        table = build(policy, x, *args, **kw)
        if table is not None and x.data_ptr() == target.data_ptr():
            rolled.append(table.numel())
            return torch.roll(table, -1)
        return table

    tile_fill.table_or_none = patched
    try:
        yield rolled
    finally:
        tile_fill.table_or_none = build


def _nm_controls(call, operands, zero_kw, check):
    """{control: reading} of one nm call: ``call(**zero_kw)`` (the zero
    fill) and ``call()`` with each operand's table rolled (skipped where
    the table has one tile).  ``check(out)`` gives a reading; each must
    exceed 1."""
    readings = {"zero": check(call(**zero_kw))}
    for name, x in operands.items():
        with _rolled_table(x) as rolled:
            out = call()
        if not rolled:
            raise AssertionError(f"control rolled {name}: no table was built")
        if rolled[0] > 1:
            readings[f"rolled {name}"] = check(out)
    failed = {k: v for k, v in readings.items() if not v > 1.0}
    if failed:
        raise AssertionError(f"controls passed the comparison they must fail: "
                             f"{failed}")
    return readings


def _fmt_controls(readings):
    return ", ".join(f"{k} {v:.3g}" for k, v in readings.items()) + " (> 1)"


def _nm_matmul_operands(shape, blocks, dtype, big, gen, scale=1.0):
    """A (M, K) and B (K, N) of a neighbor_mean product: randn plus each
    logical tile's offset, NaN/±Inf/bit-pattern (with ``big`` range) lanes
    at random, and one NaN lane in A's and in B's first tile, each facing
    NM_SPIKE in the other operand at its contraction index: C's lane there
    carries NM_SPIKE times that fill.  The offsets are times ``scale``."""
    import torch

    (M, K, N), (bm, bn, bk), dev = shape, blocks, gen.device
    a = torch.randn((M, K), generator=gen, device=dev) + _tile_offsets(
        M, K, (bm, bk), dev, scale)
    b = torch.randn((K, N), generator=gen, device=dev) + _tile_offsets(
        K, N, (bk, bn), dev, scale)
    a[1, 2], b[2, 6] = float("nan"), NM_SPIKE      # C[1, 6]: A's fill
    b[3, 4], a[5, 3] = float("nan"), NM_SPIKE      # C[5, 4]: B's fill
    return _plant_lanes(a, gen, dtype, big), _plant_lanes(b, gen, dtype, big)


def _nm_attention_operands(shape, bk, dtype, gen):
    """Causal q (B, H, S, D), k and v (B, Kh, T, D) of a neighbor_mean
    attention: randn plus each (bk, D) tile's offset (the (B*Kh*T, D)
    view), lanes planted at random, and in KV head 0 of batch 0: V lanes
    0-3 of key 0 NaN (row 0 sees key 0 alone, so its output there is V's
    fill) and K's key 1 NaN in every lane, with that head group's row 1 of
    q biased against the tile's sign: keys 0 and 1 then score alike with
    the right fill, and key 1 takes row 1 over with a wrong one."""
    import torch

    (B, H, Kh, S, T, D), dev = shape, gen.device
    q = torch.randn((B, H, S, D), generator=gen, device=dev)
    k, v = (torch.randn((B, Kh, T, D), generator=gen, device=dev)
            + _tile_offsets(B * Kh * T, D, (bk, D), dev).view(B, Kh, T, D)
            for _ in range(2))
    k, v = _plant_lanes(k, gen, torch.float32), _plant_lanes(v, gen, torch.float32)
    v[0, 0, 0, :4] = float("nan")
    k[0, 0, 1, :] = float("nan")
    q[0, :H // Kh, 1, :] -= NM_OFFSETS[0] / abs(NM_OFFSETS[0])
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _late_rel(out, ref):
    """||out - ref|| / ||ref|| of each (b, h) over the last LATE_ROWS query
    rows, as a flat f32 tensor."""
    d = (out[..., -LATE_ROWS:, :].float() - ref[..., -LATE_ROWS:, :].float())
    return (d.flatten(2).norm(dim=-1)
            / ref[..., -LATE_ROWS:, :].float().flatten(2).norm(dim=-1)).flatten()


def _dropped_tile_plain(q, k, v, causal, detector):
    """The late rows of the plain attention (repair as the zero fill does)
    with the keys DROP_KEYS left out of every row's softmax: what a kernel
    that skipped that K/V tile would give there."""
    import math

    import torch

    from repro_torch.kernels import common
    from repro_torch.kernels import repair_attention as ra

    (_, bk), ck, cv = ra._spec(q, k, v, True, None, detector)
    S, T, G = q.shape[2], k.shape[2], q.shape[1] // k.shape[1]
    kx, vx = (common.repair_tile(x, c, "zero", 0.0, (bk, x.shape[-1]))[0].float()
              .repeat_interleave(G, dim=1) for x, c in ((k, ck), (v, cv)))
    s = (q[..., -LATE_ROWS:, :].float() @ kx.transpose(-1, -2)
         / math.sqrt(q.shape[-1]))
    pos_q = torch.arange(S - LATE_ROWS, S, device=q.device)[:, None]
    pos_k = torch.arange(T, device=q.device)[None, :]
    keep = (pos_k < DROP_KEYS[0]) | (pos_k >= DROP_KEYS[1])
    if causal:
        keep = keep & (pos_q >= pos_k)
    s = torch.where(keep, s, ra.NEG_INF)
    return (torch.softmax(s, dim=-1) @ vx).to(q.dtype)


def _check_memory_mode(op, operands, kw, slots, what):
    """Memory mode on copies at the operands' offsets: they end bit-equal
    to the plain scrub of the same input, and a second call counts
    nothing."""
    from repro_torch.core import detect
    from repro_torch.kernels import scrub as sk

    mine = [_at_offset(x, x.storage_offset()) for x in operands[-2:]]
    plain = [x.clone() for x in operands[-2:]]
    res = op(*operands[:-2], *mine, mode="memory", **kw)
    counts = res.counts.tolist()
    for x, slot in zip(plain, slots):
        if counts[slot] > 0:
            sk.scrub_plain(x, detector=kw.get("detector"))
    for x, y in zip(mine, plain):
        if not bool((detect.bits_of(x) == detect.bits_of(y)).all()):
            raise AssertionError(f"{what}: memory-mode operand differs from "
                                 f"the plain scrub")
    again = op(*operands[:-2], *mine, mode="memory", **kw).counts.tolist()
    if again != [0] * 8:
        raise AssertionError(f"{what}: second memory-mode call counted {again}")


def ops_phase(report: dict) -> None:
    import math

    import torch

    from repro_torch.core import detect
    from repro_torch.kernels import common, ops, tile_fill
    from repro_torch.kernels import repair_attention as ra
    from repro_torch.kernels import repair_matmul as rm
    from repro_torch.kernels import scrub as sk

    sys.path.insert(0, str(ROOT / "examples"))
    import torch_quickstart

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    max_err = {"repair_matmul": 0.0, "flash_attention": 0.0}
    nm_err = report["nm_err"]

    def compare(what, got, want, tol):
        if not torch.equal(got[1].cpu(), want[1].cpu()):
            raise AssertionError(f"{what}: counts differ {got[1].tolist()} vs "
                                 f"{want[1].tolist()}")
        rtol, atol = tol
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   rtol=rtol, atol=atol, msg=what)
        return float((got[0].float() - want[0].float()).abs()
                     .nan_to_num(0.0).max())

    # ---- repair_matmul at the MLP shapes
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [(s, da, db) for s in MM_SHAPES for da, db in ((f32, f32), (bf16, bf16))]
    cases += [(s, bf16, f32) for s in MM_SHAPES]
    for shape, da, db in cases:
        M, K, N = MM_SHAPES[shape]
        base_a = torch.randn((M, K), generator=gen, device=dev)
        base_b = torch.randn((K, N), generator=gen, device=dev)
        out = str(da).split(".")[-1]
        for label, det in (("default", None), ("range+bitpattern", _det2(da))):
            a = _plant_lanes(base_a.clone(), gen, da, big=det is not None)
            b = _plant_lanes(base_b.clone(), gen, db, big=det is not None)
            what = f"repair_matmul {shape} {da}x{db} {label} ({rm.route(a, b)})"
            got = rm.repair_matmul_raw(a, b, detector=det)
            want = rm.repair_matmul_plain(a, b, detector=det)
            err = compare(what, got, want, MM_TOL[out])
            max_err["repair_matmul"] = max(max_err["repair_matmul"], err)
            if int(got[1][rm.EV_TOTAL]) == 0:
                raise AssertionError(f"{what}: saw none of the planted lanes")
            log(f"ops ok  {what}: counts={got[1].tolist()} max_abs_err={err:.3g} "
                f"(rtol, atol)={MM_TOL[out]}")
        _check_memory_mode(ops.repair_matmul, (a, b), dict(detector=_det2(da)),
                           (rm.EV_A, rm.EV_B), f"repair_matmul {shape} {da}")
        del a, b, base_a, base_b, got, want

    # ---- flash_attention at one layer's attention width
    def qkv(dtype, S=AT_S, big=False):
        q = torch.randn((AT_B, AT_H, S, AT_D), generator=gen, device=dev)
        k = torch.randn((AT_B, AT_KH, AT_S, AT_D), generator=gen, device=dev)
        v = torch.randn((AT_B, AT_KH, AT_S, AT_D), generator=gen, device=dev)
        return (q.to(dtype), _plant_lanes(k, gen, dtype, big),
                _plant_lanes(v, gen, dtype, big))

    # (dtype, causal, S, detector, offset in elements: 1 puts the 16-bit
    # q, k, v 2 bytes off 16-byte alignment, on the FFMA route)
    at_cases = [(f32, True, AT_S, "default", 0),
                (f32, True, AT_S, "range+bitpattern", 0),
                (bf16, True, AT_S, "default", 0),
                (bf16, True, AT_S, "range+bitpattern", 0),
                (bf16, False, AT_S, "default", 0),
                (bf16, True, AT_S // 2, "default", 0),
                (f16, True, AT_S, "default", 0),
                (bf16, True, AT_S, "default", 1)]
    for dtype, causal, S, label, off in at_cases:
        name = str(dtype).split(".")[-1]
        det = None if label == "default" else _det2(dtype)
        q, k, v = (_at_offset(t, off) for t in qkv(dtype, S, big=det is not None))
        kw = dict(causal=causal, detector=det)
        what = (f"flash_attention {name} causal={causal} S={S} T={AT_S} {label}"
                f"{f' offset={off * q.element_size()}B' if off else ''} "
                f"({ra.route(q, k, v)})")
        got = ra.flash_attention_raw(q, k, v, **kw)
        want = ra.flash_attention_plain(q, k, v, **kw)
        err = compare(what, got, want, (TOL[name], TOL[name]))
        max_err["flash_attention"] = max(max_err["flash_attention"], err)
        if int(got[1][ra.EV_TOTAL]) == 0:
            raise AssertionError(f"{what}: saw none of the planted lanes")
        rel = float(_late_rel(got[0], want[0]).max())
        ctl = float(_late_rel(_dropped_tile_plain(q, k, v, causal, det), want[0]).min())
        if not rel <= LATE_REL_TOL[name] < ctl:
            raise AssertionError(
                f"{what}: late-row relative norm {rel:.4g} must be <= "
                f"{LATE_REL_TOL[name]} < the dropped-tile control's {ctl:.4g}")
        log(f"ops ok  {what}: counts={got[1].tolist()} max_abs_err={err:.3g} "
            f"tol={TOL[name]}; late-row rel norm max {rel:.4g} <= "
            f"{LATE_REL_TOL[name]} < control min {ctl:.4g}")
        if S == AT_S and causal:
            _check_memory_mode(ops.flash_attention, (q, k, v), kw,
                               (ra.EV_K, ra.EV_V), what)
    del q, k, v, got, want

    # ---- both kernels at the quickstart's shapes and blocks, which the
    # main path below runs: A, B (512, 512) with blocks (128, 128, 256), and
    # head dim 64 (its own instantiation of the attention kernel)
    qn, qbm = torch_quickstart.N, torch_quickstart.BLOCKS
    for dtype in (f32, bf16):
        name = str(dtype).split(".")[-1]
        for label, det in (("default", None), ("range+bitpattern", _det2(dtype))):
            big = det is not None
            a = _plant_lanes(torch.randn((qn, qn), generator=gen, device=dev),
                             gen, dtype, big)
            b = _plant_lanes(torch.randn((qn, qn), generator=gen, device=dev),
                             gen, dtype, big)
            kw = dict(blocks=qbm, detector=det)
            what = f"repair_matmul quickstart {name} {label} ({rm.route(a, b)})"
            got = rm.repair_matmul_raw(a, b, **kw)
            want = rm.repair_matmul_plain(a, b, **kw)
            err = compare(what, got, want, MM_TOL[name])
            max_err["repair_matmul"] = max(max_err["repair_matmul"], err)
            if int(got[1][rm.EV_TOTAL]) == 0:
                raise AssertionError(f"{what}: saw none of the planted lanes")
            _check_memory_mode(ops.repair_matmul, (a, b), kw,
                               (rm.EV_A, rm.EV_B), what)
            log(f"ops ok  {what}: counts={got[1].tolist()} max_abs_err={err:.3g} "
                f"(rtol, atol)={MM_TOL[name]}")
            q = torch.randn((1, 4, 256, 64), generator=gen, device=dev).to(dtype)
            k, v = (_plant_lanes(torch.randn((1, 2, 256, 64), generator=gen,
                                             device=dev), gen, dtype, big)
                    for _ in range(2))
            for causal in (True, False):
                kw = dict(causal=causal, blocks=(64, 64), detector=det)
                what = (f"flash_attention quickstart D=64 {name} causal={causal} "
                        f"{label} ({ra.route(q, k, v)})")
                got = ra.flash_attention_raw(q, k, v, **kw)
                want = ra.flash_attention_plain(q, k, v, **kw)
                err = compare(what, got, want, (TOL[name], TOL[name]))
                max_err["flash_attention"] = max(max_err["flash_attention"], err)
                if int(got[1][ra.EV_TOTAL]) == 0:
                    raise AssertionError(f"{what}: saw none of the planted lanes")
                _check_memory_mode(ops.flash_attention, (q, k, v), kw,
                                   (ra.EV_K, ra.EV_V), what)
                log(f"ops ok  {what}: counts={got[1].tolist()} "
                    f"max_abs_err={err:.3g} tol={TOL[name]}")
    del a, b, q, k, v, got, want

    # ---- neighbor_mean: the gate/up product and the 2,048-token attention
    # in bf16 on the wgmma route, the quickstart's f32 shapes on the FFMA
    # route; each operand's table against the plain one, the call against
    # the plain version, and memory mode's origin scrub (the scrub's own
    # default tiles) against the plain scrub
    def nm_tables(pairs):
        worst = 0.0
        for x, rows, cols, block, det in pairs:
            consts = common.detector_operand(common.resolve_detector(det, True),
                                             x.dtype)
            g = tile_fill.values(tile_fill.tile_fill(x, rows, cols, block, consts),
                                 x.dtype)
            w = tile_fill.values(tile_fill.tile_fill_plain(x, rows, cols, block,
                                                           consts), x.dtype)
            worst = max(worst, float((g - w).abs().nan_to_num(0.0).max()))
        nm_err["tile_fill"] = max(nm_err["tile_fill"], worst)
        return worst

    def nm_memory(op, operands, kw, what):
        """Memory mode with the mean on copies; the repaired lanes' largest
        error against the plain scrub's, the other lanes bit-equal."""
        mine = [x.clone() for x in operands[-2:]]
        plain = [x.clone() for x in operands[-2:]]
        common.reset_launches()
        op(*operands[:-2], *mine, mode="memory", **kw)
        report["nm_launches"].update(common.LAUNCHES)
        worst = 0.0
        for x, y, x0 in zip(mine, plain, operands[-2:]):
            fatal = common.fatal_masks(x0, common.detector_operand(
                common.resolve_detector(kw.get("detector"), True), x0.dtype))
            fatal = fatal[0] | fatal[1]
            sk.scrub_plain(y, detector=kw.get("detector"), policy="neighbor_mean")
            if not torch.equal(detect.bits_of(x)[~fatal], detect.bits_of(y)[~fatal]):
                raise AssertionError(f"{what}: memory mode changed a lane "
                                     f"that was not fatal")
            name_ = str(x.dtype).split(".")[-1]
            torch.testing.assert_close(x[fatal].float(), y[fatal].float(),
                                       msg=what, **NM_FILL_TOL[name_])
            worst = max(worst, float((x[fatal].float() - y[fatal].float())
                                     .abs().max()))
        return worst

    M, K, N = MM_SHAPES["gate_up"]
    nm_cases = [
        ("repair_matmul gate/up bf16 range+bitpattern", bf16, _det2(bf16),
         (M, K, N), None),
        ("repair_matmul quickstart f32 default", f32, None, (qn, qn, qn), qbm),
    ]
    for what, dtype, det, (M_, K_, N_), blocks in nm_cases:
        bm, bn, bk = blocks or rm._default_blocks(M_, N_, K_)
        a, b = _nm_matmul_operands(
            (M_, K_, N_), (bm, bn, bk), dtype, det is not None, gen,
            NM_F32_MM_SCALE if dtype == f32 else 1.0)
        kw = dict(blocks=blocks, detector=det, policy="neighbor_mean")
        what = f"{what} ({rm.route(a, b)})"
        common.reset_launches()
        got = rm.repair_matmul_raw(a, b, **kw)
        report["nm_launches"].update(common.LAUNCHES)
        want = rm.repair_matmul_plain(a, b, **kw)
        name = str(dtype).split(".")[-1]
        err = compare(f"nm {what}", got, want, MM_TOL[name])
        controls = _nm_controls(
            lambda **o: rm.repair_matmul_raw(a, b, **{**kw, **o}), dict(A=a, B=b),
            dict(policy="zero"),
            lambda out: _tol_ratio(out[0], want[0], *MM_TOL[name]))
        t_err = nm_tables([(a, M_, K_, (bm, bk), det), (b, K_, N_, (bk, bn), det)])
        l_err = nm_memory(ops.repair_matmul, (a, b), kw, f"nm {what}")
        nm_err["repair_matmul"] = max(nm_err["repair_matmul"], err)
        nm_err["scrub"] = max(nm_err["scrub"], l_err)
        log(f"nm ok  {what}: counts={got[1].tolist()} max_abs_err c {err:.3g}, "
            f"A/B fills (table vs plain) {t_err:.3g}, memory-mode repaired "
            f"lanes {l_err:.3g}; controls {_fmt_controls(controls)}")
    at_nm = [("flash_attention causal S=T=2048 bf16 default", bf16,
              (AT_B, AT_H, AT_KH, AT_S, AT_S, AT_D), None),
             ("flash_attention quickstart D=64 f32 default", f32,
              (1, 4, 2, 256, 256, 64), (64, 64))]
    for what, dtype, shape, blocks in at_nm:
        bk = (blocks or ra._default_blocks(shape[3], shape[4]))[1]
        q, k, v = _nm_attention_operands(shape, bk, dtype, gen)
        kw = dict(causal=True, blocks=blocks, detector=None,
                  policy="neighbor_mean")
        what = f"{what} ({ra.route(q, k, v)})"
        common.reset_launches()
        got = ra.flash_attention_raw(q, k, v, **kw)
        report["nm_launches"].update(common.LAUNCHES)
        want = ra.flash_attention_plain(q, k, v, **kw)
        name = str(q.dtype).split(".")[-1]
        err = compare(f"nm {what}", got, want, (TOL[name], TOL[name]))
        controls = _nm_controls(
            lambda **o: ra.flash_attention_raw(q, k, v, **{**kw, **o}),
            dict(K=k, V=v), dict(policy="zero"),
            lambda out: _tol_ratio(out[0], want[0], TOL[name], TOL[name]))
        B_, Kh_, T_, D_ = k.shape
        t_err = nm_tables([(x, B_ * Kh_ * T_, D_, (bk, D_), None) for x in (k, v)])
        l_err = nm_memory(ops.flash_attention, (q, k, v), kw, f"nm {what}")
        nm_err["flash_attention"] = max(nm_err["flash_attention"], err)
        nm_err["scrub"] = max(nm_err["scrub"], l_err)
        log(f"nm ok  {what}: counts={got[1].tolist()} max_abs_err out {err:.3g}, "
            f"K/V fills (table vs plain) {t_err:.3g}, memory-mode repaired "
            f"lanes {l_err:.3g}; controls {_fmt_controls(controls)}")
    del a, b, q, k, v, got, want

    # ---- the quickstart twin on the card: the slice's main path
    common.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qs = torch_quickstart.main(device="cuda")
    torch.cuda.synchronize()
    qs_wall = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    for k_name in ("repair_matmul", "flash_attention", "scrub"):
        if launches.get(k_name, 0) < 1:
            raise AssertionError(f"kernel {k_name} never launched by the quickstart")
    log(f"quickstart ok: register {qs['register']}, memory {qs['memory']}, "
        f"attention register {qs['attention_register']}, memory "
        f"{qs['attention_memory']}, stats {qs['stats']}, launches {launches}, "
        f"{qs_wall:.2f} s")

    # ---- timings, bf16: the gate/up projection and causal S = T = 2048
    M, K, N = MM_SHAPES["gate_up"]
    names = KERNEL_NAMES["repair_matmul"]
    flops = 2.0 * M * N * K
    clean_a = torch.randn((M, K), generator=gen, device=dev)
    clean_b = torch.randn((K, N), generator=gen, device=dev)
    a = _plant_lanes(clean_a.clone(), gen, bf16)
    b = _plant_lanes(clean_b.clone(), gen, bf16)
    if rm.route(a, b) != "wgmma":
        raise AssertionError("gate/up bf16 is not on the wgmma route")
    fa, fb = ops.scrub(a.clone())[0], ops.scrub(b.clone())[0]
    parts = kernel_breakdown(lambda: rm.repair_matmul_raw(a, b), names, iters=10)
    if not parts["repair_mm_wgmma"] > 0:
        raise AssertionError(f"gate/up bf16 ran no wgmma kernel: {parts}")
    mm = dict(
        ms=cuda_ms(lambda: rm.repair_matmul_raw(a, b)),
        plain_ms=cuda_ms(lambda: rm.repair_matmul_plain(a, b)),
        library_ms=cuda_ms(lambda: torch.matmul(fa, fb)),
        device_ms=sum(parts.values()),
    )
    mm["bound_ms"], mm["bound_by"] = bound(
        2 * (M * K + K * N + M * N) + 32, flops, "bfloat16")
    scan_bound = 2 * (M * K + K * N) / HBM_BYTES_PER_S * 1e3
    ca, cb = clean_a.to(bf16), clean_b.to(bf16)
    clean = kernel_breakdown(lambda: rm.repair_matmul_raw(ca, cb), names, iters=10)
    clean_call = cuda_ms(lambda: rm.repair_matmul_raw(ca, cb))
    clean_lib = cuda_ms(lambda: torch.matmul(ca, cb))
    lib_dev = kernel_device_ms(lambda: torch.matmul(ca, cb), ("",), iters=10)
    for label, pr in (("planted", parts), ("clean", clean)):
        dev_ms = sum(pr.values())
        log(f"timing repair_matmul gate/up bf16 {label} (wgmma route): device "
            f"{dev_ms:.4f} ms = scan {pr['repair_mm_scan']:.4f} (floor "
            f"{scan_bound:.5f}) + wgmma {pr['repair_mm_wgmma']:.4f} + counts "
            f"{pr['repair_mm_counts']:.4f}; {flops / dev_ms / 1e9:.1f} TFLOP/s, "
            f"{mm['bound_ms'] / dev_ms:.3f} of the bound; main loop "
            f"{flops / pr['repair_mm_wgmma'] / 1e9:.1f} TFLOP/s")
    log(f"timing repair_matmul gate/up bf16 clean: call {clean_call:.4f} ms; "
        f"torch.matmul call {clean_lib:.4f} ms, device {lib_dev}")
    # tile_fill at the planted gate/up A operand (the product's (256, 512)
    # logical tiles), and the product with the mean against the zero fill
    bm, bn, bk = rm._default_blocks(M, N, K)
    consts = common.detector_operand(common.resolve_detector(None, True), bf16)

    def tf_call():
        return tile_fill.tile_fill(a, M, K, (bm, bk), consts)

    n_tiles = (M // bm) * (K // bk)
    tf = dict(ms=cuda_ms(tf_call), device_ms=kernel_device_ms(tf_call, ("tile_fill",)),
              plain_ms=cuda_ms(lambda: tile_fill.tile_fill_plain(
                  a, M, K, (bm, bk), consts), iters=10),
              bound_ms=(2 * M * K + 4 * n_tiles) / HBM_BYTES_PER_S * 1e3,
              bound_by="bytes", library_ms=None, route="cuda",
              source="src/repro_torch/csrc/tile_fill.cu",
              replaces=("src/repro/kernels/common.py:153 (repair_value, its "
                        "neighbor_mean branch, which every Pallas kernel "
                        "reaches through repair_tile)"))
    mm_nm = {fill: device_ops(lambda fill=fill: rm.repair_matmul_raw(
        a, b, policy=fill))[0] for fill in ("neighbor_mean", "zero")}
    pool = report["tile_fill_pool"]
    report["kernels"]["tile_fill"] = tf
    log(f"timing tile_fill: gate/up A ({M}, {K}) bf16 in ({bm}, {bk}) tiles "
        f"({n_tiles} tiles): device {tf['device_ms']} ms, call {tf['ms']:.4f} "
        f"ms, plain {tf['plain_ms']:.4f} ms, bound {tf['bound_ms']:.5f} ms "
        f"(bytes); engine pool layer ({P} pages of {PG}x{KH}x{DH}) bf16: device "
        f"{pool['device_ms']} ms, bound {pool['bound_ms']:.6f} ms (bytes); "
        f"device ms a call, neighbor_mean vs zero: repair_matmul gate/up "
        f"{mm_nm['neighbor_mean']:.4f} vs {mm_nm['zero']:.4f}, paged decode "
        f"splits=4 {pool['neighbor_mean_ms']:.4f} vs {pool['zero_ms']:.4f} "
        f"({gpu_line()})")
    del a, b, fa, fb, ca, cb
    # the f32 product (the FFMA route, which the quickstart takes)
    a, b = clean_a, clean_b
    if rm.route(a, b) != "ffma":
        raise AssertionError("gate/up f32 is not on the FFMA route")
    f32_parts = kernel_breakdown(lambda: rm.repair_matmul_raw(a, b), names, iters=3)
    f32_ms = cuda_ms(lambda: rm.repair_matmul_raw(a, b), iters=5)
    log(f"timing repair_matmul gate/up f32 (ffma route): call {f32_ms:.4f} ms, "
        f"device {sum(f32_parts.values()):.4f} ms "
        f"({f32_parts['repair_mm_tiles']:.4f} in repair_mm_tiles), "
        f"{flops / sum(f32_parts.values()) / 1e9:.1f} TFLOP/s")
    del a, b, clean_a, clean_b
    # the down projection, off the JSON line
    Md, Kd, Nd = MM_SHAPES["down"]
    a = _plant_lanes(torch.randn((Md, Kd), generator=gen, device=dev), gen, bf16)
    b = _plant_lanes(torch.randn((Kd, Nd), generator=gen, device=dev), gen, bf16)
    if rm.route(a, b) != "wgmma":
        raise AssertionError("down bf16 is not on the wgmma route")
    down_ms = cuda_ms(lambda: rm.repair_matmul_raw(a, b), iters=10)
    down = kernel_breakdown(lambda: rm.repair_matmul_raw(a, b), names, iters=5)
    down_dev = sum(down.values())
    fa, fb = ops.scrub(a.clone())[0], ops.scrub(b.clone())[0]
    down_lib = cuda_ms(lambda: torch.matmul(fa, fb))
    del a, b, fa, fb
    # flash_attention, causal bf16 at S = T = 2048: planted, then the same
    # K/V scrubbed clean (the operands SDPA is timed on)
    names = KERNEL_NAMES["flash_attention"]
    flops = 2.0 * AT_B * AT_H * AT_S * AT_S * AT_D     # causal QK^T and PV
    q, k, v = qkv(bf16)
    if ra.route(q, k, v) != "wgmma":
        raise AssertionError("flash_attention bf16 is not on the wgmma route")
    fk, fv = ops.scrub(k.clone())[0], ops.scrub(v.clone())[0]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(q, fk, fv, is_causal=True, enable_gqa=True)

    parts = kernel_breakdown(lambda: ra.flash_attention_raw(q, k, v), names, iters=10)
    if not parts["flash_repair_wgmma"] > 0:
        raise AssertionError(f"flash_attention bf16 ran no wgmma kernel: {parts}")
    at = dict(
        ms=cuda_ms(lambda: ra.flash_attention_raw(q, k, v)),
        plain_ms=cuda_ms(lambda: ra.flash_attention_plain(q, k, v), iters=10),
        library_ms=cuda_ms(library),
        device_ms=sum(parts.values()),
    )
    kv_bytes = 2 * AT_B * AT_KH * AT_S * AT_D * 2
    at["bound_ms"], at["bound_by"] = bound(
        2 * (2 * AT_B * AT_H * AT_S * AT_D) + kv_bytes + 32, flops, "bfloat16")
    scan_bound = kv_bytes / HBM_BYTES_PER_S * 1e3
    clean = kernel_breakdown(lambda: ra.flash_attention_raw(q, fk, fv), names, iters=10)
    clean_call = cuda_ms(lambda: ra.flash_attention_raw(q, fk, fv))
    lib_dev = kernel_device_ms(library, ("",), iters=10)
    # the same call captured once in a CUDA graph and replayed: what a
    # caller pays without the wrapper's host path (Python, ctypes, launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ra.flash_attention_raw(q, fk, fv)
    graph_ms = cuda_ms(graph.replay)
    del graph
    # host time of the eager wrapper: 20 calls issued back to back (the
    # device, at a fraction of that, never holds the host up)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        ra.flash_attention_raw(q, fk, fv)
    host_us = (time.perf_counter() - t0) / 20 * 1e6
    torch.cuda.synchronize()
    for label, pr, call in (("planted", parts, at["ms"]), ("clean", clean, clean_call)):
        dev_ms = sum(pr.values())
        log(f"timing flash_attention causal bf16 {label} (wgmma route): device "
            f"{dev_ms:.4f} ms = scan {sum(pr[n] for n in COUNT_PASS):.4f} (floor "
            f"{scan_bound:.5f}) + wgmma {pr['flash_repair_wgmma']:.4f} + counts "
            f"{pr['flash_counts']:.4f}; {flops / dev_ms / 1e9:.1f} TFLOP/s, "
            f"{at['bound_ms'] / dev_ms:.3f} of the bound; main loop "
            f"{flops / pr['flash_repair_wgmma'] / 1e9:.1f} TFLOP/s; call "
            f"{call:.4f} ms; SDPA call {at['library_ms']:.4f} ms, device {lib_dev}")
    log(f"timing flash_attention causal bf16 clean (wgmma route): one call "
        f"replayed from a CUDA graph {graph_ms:.4f} ms; the eager wrapper's "
        f"host time {host_us:.1f} us per call")
    del q, k, v, fk, fv
    # the f32 call (the FFMA route, which the quickstart takes)
    q, k, v = qkv(f32)
    if ra.route(q, k, v) != "ffma":
        raise AssertionError("flash_attention f32 is not on the FFMA route")
    f32_parts = kernel_breakdown(lambda: ra.flash_attention_raw(q, k, v), names, iters=3)
    f32_ms = cuda_ms(lambda: ra.flash_attention_raw(q, k, v), iters=5)
    log(f"timing flash_attention causal f32 (ffma route): call {f32_ms:.4f} ms, "
        f"device {sum(f32_parts.values()):.4f} ms ({f32_parts['flash_repair_fwd']:.4f} "
        f"in flash_repair_fwd, {f32_parts['flash_count_tiles']:.4f} in "
        f"flash_count_tiles), {flops / sum(f32_parts.values()) / 1e9:.1f} TFLOP/s")
    del q, k, v
    torch.cuda.empty_cache()

    rows = {
        "repair_matmul": dict(
            route="cuda", source="src/repro_torch/csrc/repair_matmul.cu",
            replaces="src/repro/kernels/repair_matmul.py:60 (_mm_kernel)",
            max_abs_err=max_err["repair_matmul"], **mm),
        "flash_attention": dict(
            route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/repair_attention.py:44 (_flash_kernel)",
            max_abs_err=max_err["flash_attention"], **at),
    }
    for name, row in rows.items():
        row["launches"] = int(launches.get(name, 0))
        report["kernels"][name] = row
        log(f"timing {name}: call {row['ms']:.4f} ms (device {row['device_ms']}), "
            f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
            f"({row['bound_by']}), library {row['library_ms']:.4f} ms, "
            f"max_abs_err {row['max_abs_err']}, launches per quickstart run "
            f"{row['launches']}")
    log(f"timing repair_matmul down ({Md}, {Kd}) @ ({Kd}, {Nd}) bf16 (wgmma "
        f"route): call {down_ms:.4f} ms, device {down_dev:.4f} ms (scan "
        f"{down['repair_mm_scan']:.4f}, wgmma {down['repair_mm_wgmma']:.4f}), "
        f"{2.0 * Md * Nd * Kd / down_dev / 1e9:.1f} TFLOP/s; torch.matmul "
        f"call {down_lib:.4f} ms")
    log(f"timing shapes: repair_matmul A ({M}, {K}) @ B ({K}, {N}) bf16; "
        f"flash_attention B={AT_B} H={AT_H} Kh={AT_KH} S=T={AT_S} D={AT_D} "
        f"causal bf16; library = torch.matmul / SDPA (enable_gqa) on the "
        f"repaired operands")


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


def _check_repaired(engine, planted, before) -> None:
    """The planted pages are charged, their lanes found, the pool finite."""
    import torch

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


def drive(engine, prompts, *, plant_after: int | None = 3, max_new: int = 16,
          deferred: bool = False):
    """Serve ``prompts``; plant faults after step ``plant_after`` (None: no
    faults) and check that the next step repairs them, or with
    ``deferred`` (the desynchronized drain) that they are repaired once the
    engine has drained at the end.  Returns the results."""
    rids = [engine.add_request(p, max_new=max_new) for p in prompts]
    planted, at_plant, steps = None, None, 0
    while engine.has_work:
        before = engine.stats_dict()
        engine.step()
        if planted is not None and not deferred:
            _check_repaired(engine, planted, before)
            planted = None
        steps += 1
        if plant_after is not None and steps == plant_after + 1:
            at_plant = engine.stats_dict()
            planted = plant(engine)
    if planted is not None:
        engine.drain()
        _check_repaired(engine, planted, at_plant)
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
    by_kernel = {k: 0.0 for k in KERNEL_NAMES}
    for key, ms in per.items():
        low = key.lower()
        if any(n in key for n in ours):
            groups["repair_kernels"] += ms
            by_kernel[next(k for k, names in KERNEL_NAMES.items()
                           if any(n in key for n in names))] += ms
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
        repair_ms_per_step={k: v / wm["steps"] for k, v in by_kernel.items() if v},
        device_idle_share=(1.0 - busy / (1e3 * warm_wall)) if busy else None,
        top_kernels_ms=[(k[:60], v) for k, v in top],
        stats=engine.stats_dict(), kernel_counts=engine.kernel_counts.tolist(),
        n_host_syncs=m["n_host_syncs"], scrubbed_bytes=m["scrubbed_bytes"],
        split_k=m["split_k"], stage_wall_s=wm["stage_wall_s"],
    )
    log("engine: " + json.dumps(report["engine"]))
    dms = report["engine"]["device_ms_per_step"]
    log(f"engine device ms a step: gemm {dms['gemm']:.4f}, elementwise "
        f"{dms['other']:.4f}, repair kernels {dms['repair_kernels']:.4f}, "
        f"copies {dms['copy']:.4f} ({gpu_line()})")
    report["model"] = model


def _engine_arm(name: str, model, cfg, prompts, **drive_kw) -> dict:
    """Serve ``prompts`` cold (launch counts from zero, the arm's checks run
    on it), then warm (timed), then once more under the profiler; print
    one ``timing engine arm=`` line.  Returns the cold engine, its results
    and launches, and the timing row."""
    import torch

    from repro_torch.kernels import common
    from repro_torch.serving import Engine

    common.reset_launches()
    cold = Engine(model, cfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = drive(cold, prompts, **drive_kw)
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    common.reset_launches()
    warm = Engine(model, cfg, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drive(warm, prompts, **drive_kw)
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    wm = warm.metrics()
    steps = wm["steps"]
    warm_launches = dict(common.LAUNCHES)
    busy = sum(device_profile(lambda: drive(
        Engine(model, cfg, device="cuda"), prompts, **drive_kw)).values())
    row = dict(
        ms_per_step=1e3 * warm_wall / steps,
        tokens_per_s=wm["tokens_emitted"] / warm_wall,
        device_idle_share=(1.0 - busy / (1e3 * warm_wall)) if busy else None,
        host_syncs_per_step=wm["n_host_syncs"] / steps,
        gathers_per_step=wm["pool_gathers"] / steps,
        scatters_per_step=wm["pool_scatters"] / steps,
        launches_per_step={k: v / steps for k, v in sorted(warm_launches.items())},
        stage_ms_per_step={k: 1e3 * v / steps for k, v in wm["stage_wall_s"].items()},
        steps=steps, first_run_ms_per_step=1e3 * cold_wall / cold.metrics()["steps"],
        paged_decode=wm["paged_decode"], paged_prefill=wm["paged_prefill"],
        drain_interval=wm["drain_interval"],
    )
    log(f"timing engine arm={name}: {json.dumps(row)} ({gpu_line()})")
    for res in results:
        gen = res["generated"]
        if not gen or not all(0 <= t < model.cfg.vocab for t in gen):
            raise AssertionError(f"arm {name}: bad generation {gen}")
    return dict(engine=cold, results=results, launches=launches, row=row)


def _launched(arm: dict, name: str, **want) -> None:
    """Hold the arm's cold-run launches: ``kernel=n`` exactly, or at least
    ``n`` with a ``_min`` suffix on the name (``scrub_min=1``)."""
    got = arm["launches"]
    for key, n in want.items():
        kernel, at_least = (key[:-4], True) if key.endswith("_min") else (key, False)
        have = got.get(kernel, 0)
        if (have < n) if at_least else (have != n):
            raise AssertionError(f"arm {name}: {kernel} launched {have} times, "
                                 f"want {'>=' if at_least else '=='} {n} ({got})")


def _register_forward(model, tokens):
    """Register mode at full width: one NaN in layer 3's ``w_up``.  The
    register-mode forward must be bit-equal to a mode-"off" forward with
    that lane 0, and finite; mode "off" with the NaN left in is not.
    Returns the register-mode model, its NaN still in place."""
    import torch

    from repro_torch.models import TransformerLM
    from repro_torch.runtime import ApproxConfig

    def twin(mode):
        cfg = dataclasses.replace(model.cfg, repair=ApproxConfig(mode=mode, policy="zero"))
        m = TransformerLM(cfg, device="cuda", seed=0)
        m.load_state_dict(model.state_dict())
        m.layers[3].mlp.w_up[7, 1000] = float("nan")
        return m

    reg, off = twin("register"), twin("off")
    t0 = time.perf_counter()
    got = reg(tokens)
    torch.cuda.synchronize()
    reg_ms = 1e3 * (time.perf_counter() - t0)
    poisoned = off(tokens)
    off.layers[3].mlp.w_up[7, 1000] = 0.0
    t0 = time.perf_counter()
    zeroed = off(tokens)
    torch.cuda.synchronize()
    off_ms = 1e3 * (time.perf_counter() - t0)
    if bool(torch.isfinite(poisoned).any()):
        raise AssertionError("mode off: a NaN weight lane left finite logits")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("register mode: logits not finite")
    if not torch.equal(got.view(torch.int32), zeroed.view(torch.int32)):
        raise AssertionError("register mode: logits differ from the zeroed lane's "
                             f"by {float((got - zeroed).abs().max())}")
    log(f"register forward ok: {tuple(tokens.shape)} tokens at full width, one NaN "
        f"in layers[3].mlp.w_up: bit-equal to mode off with the lane 0, finite; "
        f"mode off with the NaN: non-finite; forward {reg_ms:.1f} ms (register, "
        f"first call) vs {off_ms:.1f} ms (off)")
    del off
    return reg


def fallback_phase(report: dict) -> None:
    """The gathered-view fallback, the no-repair arm, the desynchronized
    drain, register mode and generate, at full width on the card."""
    import numpy as np
    import torch

    from repro_torch.kernels import common
    from repro_torch.launch import serve
    from repro_torch.runtime import ApproxConfig, ApproxSpace, ScrubSchedule
    from repro_torch.serving import Engine

    model = report["model"]
    prompts = requests(model.cfg.vocab)
    base = serving_config()
    arms = {}

    # (a) everything gathered: probe + scrub, then Model.serve_step
    a = arms["a-gathered"] = _engine_arm(
        "a-gathered", model, dataclasses.replace(base, paged_decode="off"), prompts)
    _launched(a, "a", paged_decode=0, paged_prefill=0, scrub_min=1)
    if a["row"]["gathers_per_step"] <= 0:
        raise AssertionError("arm a: no pool gathers")
    # (b) gathered prefill, paged decode
    b = arms["b-gathered-prefill"] = _engine_arm(
        "b-gathered-prefill", model, dataclasses.replace(base, paged_prefill="off"),
        prompts)
    _launched(b, "b", paged_decode_min=1, paged_prefill=0, scrub_min=1)
    # (c) no repair, no faults: the paper's baseline
    c = arms["c-repair-off"] = _engine_arm(
        "c-repair-off", model, dataclasses.replace(base, repair="off"), prompts,
        plant_after=None)
    _launched(c, "c", paged_decode=0, paged_prefill=0, scrub=0)
    overhead = a["row"]["ms_per_step"] / c["row"]["ms_per_step"]
    log(f"repair overhead on the gathered path: (a) {a['row']['ms_per_step']:.2f} "
        f"/ (c) {c['row']['ms_per_step']:.2f} ms a step = {overhead:.3f} "
        f"({gpu_line()})")

    # (d) the desynchronized drain on the paged path, the same plants
    lock = Engine(model, base, device="cuda")
    lock_res = drive(lock, prompts)
    d = arms["d-drain4"] = _engine_arm(
        "d-drain4", model, dataclasses.replace(base, drain_interval=4), prompts,
        deferred=True)
    _launched(d, "d", paged_decode_min=1, paged_prefill_min=1, scrub_min=1)
    lock_syncs = lock.metrics()["n_host_syncs"]
    d_syncs = d["engine"].metrics()["n_host_syncs"]
    if [r["tokens"] for r in d["results"]] != [r["tokens"] for r in lock_res]:
        raise AssertionError("drain_interval=4: tokens differ from lockstep's")
    if not d_syncs < lock_syncs:
        raise AssertionError(f"drain_interval=4: {d_syncs} host syncs, lockstep "
                             f"{lock_syncs}")
    replay = []
    for di in (0, 1):
        eng = Engine(model, dataclasses.replace(base, ber=1e-7, seed=0,
                                                drain_interval=di), device="cuda")
        eng.add_request(prompts[0], max_new=16)
        eng.run()
        replay.append(eng)
    lk, dk = replay
    for what, x, y in (
        ("tokens", dk.results, lk.results), ("stats", dk.stats_dict(), lk.stats_dict()),
        ("page_events", dk.pool.page_events.tolist(), lk.pool.page_events.tolist()),
    ):
        if x != y:
            raise AssertionError(f"drain_interval=1 at ber=1e-7: {what} differ")
    for path, leaf in lk.pool.tree.items():
        if not torch.equal(dk.pool.tree[path].view(torch.int16), leaf.view(torch.int16)):
            raise AssertionError(f"drain_interval=1 at ber=1e-7: pool {path} bits differ")
    if not dk.n_host_syncs < lk.n_host_syncs:
        raise AssertionError("drain_interval=1: no fewer host syncs than lockstep")
    log(f"desync ok: drain_interval=4 tokens = lockstep's, host syncs {d_syncs} vs "
        f"{lock_syncs}; drain_interval=1 at ber=1e-7 (1 request) replays lockstep "
        f"bit for bit (stats {lk.stats_dict()}), host syncs {dk.n_host_syncs} vs "
        f"{lk.n_host_syncs}")

    # (e) register mode: the forward, then the engine over the gathered path
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(1, model.cfg.vocab, (1, 256), generator=gen).cuda()
    reg = _register_forward(model, tokens)
    e = arms["e-register"] = _engine_arm("e-register", reg, base, prompts)
    if e["engine"].paged_plan is not None:
        raise AssertionError("arm e: a register-mode model took the paged path")
    _launched(e, "e", paged_decode=0, paged_prefill=0, scrub_min=1)
    del reg
    for arm in arms.values():
        arm.pop("engine")

    # (f) generate over the dense cache (the scrub kernel every 8 steps, a
    # NaN and an Inf planted before the 2nd scrub), then over the engine
    rng = np.random.default_rng(3)
    gp = torch.from_numpy(rng.integers(1, model.cfg.vocab, size=(4, 64)))

    def space():
        return ApproxSpace(ApproxConfig(mode="memory", policy="zero"),
                           max_magnitude=None,
                           scrub=ScrubSchedule(boundary=False, interval=8))

    deltas, sp = [], space()
    _plant_before(sp, 2, [("layers/k", (3, 1, 10, 0, 5), float("nan")),
                          ("layers/v", (20, 2, 30, 1, 77), float("inf"))], deltas)
    common.reset_launches()
    dense, stats = serve.generate(model, gp, max_new=16, max_seq=80, space=sp)
    dense_launches = dict(common.LAUNCHES)
    if tuple(dense.shape) != (4, 80) or not bool(((dense >= 0) & (dense < model.cfg.vocab)).all()):
        raise AssertionError(f"generate: bad tokens {tuple(dense.shape)}")
    if len(deltas) != 3 or deltas[1][:2] != [1, 1] or any(
            d_[:2] != [0, 0] for i, d_ in enumerate(deltas) if i != 1):
        raise AssertionError(f"generate: scrubs found {deltas}, planted [1, 1] "
                             "before the 2nd")
    if dense_launches.get("scrub", 0) < 3:
        raise AssertionError(f"generate: the cache scrub kernel did not run "
                             f"({dense_launches})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve.generate(model, gp, max_new=16, max_seq=80, space=space())
    torch.cuda.synchronize()
    dense_ms = 1e3 * (time.perf_counter() - t0) / 16      # per new token
    common.reset_launches()
    paged, _ = serve.generate(model, gp, max_new=16, max_seq=80, paged=True)
    paged_launches = dict(common.LAUNCHES)
    for k in ("paged_decode", "paged_prefill"):
        if paged_launches.get(k, 0) < 1:
            raise AssertionError(f"generate(paged=True): {k} never launched")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve.generate(model, gp, max_new=16, max_seq=80, paged=True)
    torch.cuda.synchronize()
    paged_ms = 1e3 * (time.perf_counter() - t0) / 16
    busy = sum(device_profile(lambda: serve.generate(
        model, gp, max_new=16, max_seq=80, paged=True)).values())
    agree = float((paged.cpu() == dense.cpu())[:, 64:].float().mean())
    log(f"timing engine arm=f-generate: " + json.dumps(dict(
        dense_ms_per_new_token=dense_ms, paged_ms_per_new_token=paged_ms,
        paged_device_idle_share=1.0 - busy / (16 * paged_ms),
        dense_launches=dense_launches, paged_launches=paged_launches,
        scrub_deltas=deltas, stats=stats, new_tokens_agree=agree))
        + f" ({gpu_line()})")
    report["fallback"] = {k: v["row"] for k, v in arms.items()}
    report["fallback"]["repair_overhead_a_over_c"] = overhead


# prefix-cache phase geometry: one 96-token (6-page) prefix, block tables
# wide enough for it, a 40-token suffix and 16 new tokens
PREFIX_TOKENS = 96
PREFIX_M = 12


def prefix_requests(vocab: int):
    """Two waves of six prompts on one prefix.  Wave one's suffixes (8-40
    tokens) leave a partial tail page of at least two rows; wave two
    changes each wave-one prompt's last token, so its match ends inside
    that tail: a fragment hit and a copy-on-write fork."""
    import numpy as np

    rng = np.random.default_rng(5)
    prefix = rng.integers(1, vocab, size=PREFIX_TOKENS).tolist()
    lengths = [n for n in range(8, 41) if n % PG >= 2]
    wave1 = [prefix + rng.integers(1, vocab, size=int(rng.choice(lengths))).tolist()
             for _ in range(6)]
    wave2 = []
    for p in wave1:
        t = int(rng.integers(1, vocab - 1))
        wave2.append(p[:-1] + [t + (t >= p[-1])])
    return wave1, wave2


def _prefix_arm(engine, waves, between=None, max_new: int = 16) -> dict:
    """Serve the waves on ``engine``, each with the launch counts from 0;
    return its timing row (``between(engine)`` runs after the first wave,
    its time excluded, its launches counted with the second wave's) and
    the results."""
    import torch

    from repro_torch.kernels import common

    results, wall, by_wave = [], 0.0, []
    for i, wave in enumerate(waves):
        common.reset_launches()
        if i and between is not None:
            between(engine)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results += drive(engine, wave, plant_after=None, max_new=max_new)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        by_wave.append(dict(common.LAUNCHES))
    launches = {k: sum(w.get(k, 0) for w in by_wave) for w in by_wave for k in w}
    m = engine.metrics()
    row = dict(ms_per_step=1e3 * wall / m["steps"], steps=m["steps"],
               tokens_per_s=m["tokens_emitted"] / wall,
               launches=launches, launches_by_wave=by_wave,
               launches_per_step={k: v / m["steps"] for k, v in sorted(launches.items())},
               prefill_tokens_saved=m["prefill_tokens_saved"],
               n_preemptions=m["n_preemptions"], stats=engine.stats_dict(),
               cache=engine.cache_stats(), tiers=engine.tier_stats())
    return dict(row=row, results=results)


def prefix_tier_phase(report: dict) -> None:
    """The prefix cache and the host KV tier on the paged engine at full
    width in bf16."""
    import numpy as np
    import torch

    from repro_torch.core import detect
    from repro_torch.serving import Engine, ServingConfig

    model = report["model"]
    wave1, wave2 = prefix_requests(model.cfg.vocab)
    base = ServingConfig(page_size=PG, n_pages=96, max_batch=4,
                         max_pages_per_request=PREFIX_M, repair="page")

    # the cache arm, and the same waves with the cache off
    on = _prefix_arm(Engine(model, dataclasses.replace(base, prefix_cache=True),
                                     device="cuda"), [wave1, wave2])
    off = _prefix_arm(Engine(model, base, device="cuda"), [wave1, wave2])
    row, c = on["row"], on["row"]["cache"]
    if not (c["hits"] > 0 and c["cow_forks"] > 0 and row["prefill_tokens_saved"] > 0):
        raise AssertionError(f"prefix cache: no hits, forks or saved tokens: {c}")
    for k in ("paged_prefill", "paged_decode"):      # wave two: the suffix prefills
        if row["launches_by_wave"][1].get(k, 0) < 1:
            raise AssertionError(f"prefix cache: {k} never launched in wave two "
                                 f"({row['launches_by_wave']})")
    same = sum(a["tokens"] == b["tokens"] for a, b in zip(on["results"], off["results"]))
    agree = sum(x == y for a, b in zip(on["results"], off["results"])
                for x, y in zip(a["generated"], b["generated"]))
    log(f"timing prefix arm=cache: {json.dumps(row)} ({gpu_line()})")
    log(f"timing prefix arm=off: ms_per_step {off['row']['ms_per_step']:.2f}, "
        f"launches {off['row']['launches']} ({gpu_line()})")
    log(f"prefix cache ok: hits {c['hits']}, misses {c['misses']}, hit tokens "
        f"{c['hit_tokens']}, cow forks {c['cow_forks']}, fragment hits "
        f"{c['fragment_hits']}, prefill tokens saved {row['prefill_tokens_saved']}; "
        f"against the cache-off run (bf16, reported): {same}/12 requests "
        f"token-identical, {agree}/{16 * 12} new tokens equal")

    # dwell_threshold=0: a NaN planted in a cached full page before wave two
    planted = {}

    def plant(eng):
        e = next(e for e in eng.cache._entries.values()
                 if not e.partial and len(e.key) == PREFIX_TOKENS)
        top = eng.pool.tree["layers/k"].shape[1] - 1      # the pool's last layer
        at = (e.page, min(5, top), 3, 1, 17)
        eng.pool.tree["layers/k"][at] = float("nan")
        planted.update(entry=e, at=at, events=eng.stats_dict()["nan_found"])

    def first_step(eng):
        plant(eng)
        for p in wave2:
            eng.add_request(p, max_new=16)
        eng.step()               # admission: the hit repairs from the snapshot
        e = planted["entry"]
        got = detect.bits_of(eng.pool.tree["layers/k"][e.page])
        want = detect.bits_of(e.snapshot["layers/k"][0].to(got.device))
        if not torch.equal(got, want):
            raise AssertionError("dwell_threshold=0: the hit did not restore the "
                                 "snapshot's bits")
        planted["restored"] = True

    eng0 = Engine(model, dataclasses.replace(base, prefix_cache=True,
                                             dwell_threshold=0.0), device="cuda")
    d0 = _prefix_arm(eng0, [wave1, []], between=first_step)
    c0 = d0["row"]["cache"]
    if not planted.get("restored") or c0["reuse_ref_repairs"] < 1 or c0["reuse_skips"]:
        raise AssertionError(f"dwell_threshold=0: {c0}")
    if d0["row"]["launches"].get("scrub", 0) < 1:
        raise AssertionError("dwell_threshold=0: the partial tails' reuse scrub "
                             f"did not launch the scrub kernel ({d0['row']['launches']})")
    if eng0.stats_dict()["nan_found"] != planted["events"] + 1:
        raise AssertionError(f"dwell_threshold=0: nan_found {eng0.stats_dict()}")
    log(f"timing prefix arm=dwell0: {json.dumps(d0['row'])} ({gpu_line()})")
    log(f"reuse repair ok: the NaN at {planted['at']} took back its snapshot's "
        f"bits; reference repairs {c0['reuse_ref_repairs']}, reuse scrubs "
        f"{c0['reuse_scrubs']}")

    # the tier arm: six requests of 20-60 tokens growing by 48 new tokens
    # each over a 16-page pool, so preemption swaps to the host tier
    rng = np.random.default_rng(6)
    grow = [rng.integers(1, model.cfg.vocab, size=int(n)).tolist()
            for n in rng.integers(20, 61, size=6)]
    tier = Engine(model, dataclasses.replace(base, n_pages=16, host_pages=32),
                  device="cuda")
    tiers, checked = tier.tiers, {"out": 0, "in": 0}
    swap_out, swap_in = tiers.swap_out, tiers.swap_in

    def bits_equal(a: dict, b: dict, what: str) -> None:
        for path in a:
            if not torch.equal(detect.bits_of(a[path]), detect.bits_of(b[path])):
                raise AssertionError(f"tier: {what} bits differ in {path}")

    def checked_out(pages):
        handle = swap_out(pages)
        if handle is not None:
            bits_equal(tiers.host.get(handle.slots), tier.pool.pages_view(pages),
                       "swapped-out")
            checked["out"] += 1
        return handle

    def checked_in(handle, pages):
        stored = tiers.host.get(handle.slots)
        swap_in(handle, pages)
        bits_equal(stored, tier.pool.pages_view(pages), "swapped-in")
        checked["in"] += 1

    tiers.swap_out, tiers.swap_in = checked_out, checked_in
    t = _prefix_arm(tier, [grow], max_new=48)
    ts = t["row"]["tiers"]
    if ts["n_swap_preemptions"] < 1 or checked["in"] != ts["swap_ins"] or not checked["in"]:
        raise AssertionError(f"tier: no swap round trip checked ({ts}, {checked})")
    if ts["host_used"] or tier.prefill_tokens_recomputed:
        raise AssertionError(f"tier: {ts}, recomputed {tier.prefill_tokens_recomputed}")
    for k in ("scrub", "paged_prefill", "paged_decode"):
        if t["row"]["launches"].get(k, 0) < 1:
            raise AssertionError(f"tier: {k} never launched ({t['row']['launches']})")
    for leaf in tier.pool.tree.values():
        if not bool(torch.isfinite(leaf).all()):
            raise AssertionError("tier: the pool is not finite")
    log(f"timing prefix arm=tier: {json.dumps(t['row'])} ({gpu_line()})")
    log(f"tier ok: {ts['n_swap_preemptions']} swap preemptions, {checked['out']} "
        f"swap-outs and {checked['in']} swap-ins bit-checked, boundary scrub "
        f"{ts['boundary_scrub_bytes']} bytes, pool finite")
    report["prefix_tier"] = dict(cache=row, dwell0=d0["row"], tier=t["row"])


def parity_phase(report: dict) -> None:
    """Each engine arm at full width with 2 layers in f32 (TF32 off), on the
    card (kernels) and on the CPU (plain versions): tokens, page events,
    stats, kernel counts and host syncs must be equal."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM
    from repro_torch.runtime import ApproxConfig, ApproxSpace
    from repro_torch.serving import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2,
                              dtype_name="float32")
    gpu = TransformerLM(cfg, device="cuda", seed=0)
    cpu = TransformerLM(cfg, device="cpu", seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})

    def register_twin(m):
        rcfg = dataclasses.replace(cfg, repair=ApproxConfig(mode="register",
                                                            policy="zero"))
        twin = TransformerLM(rcfg, device=m.device, seed=0)
        twin.load_state_dict(m.state_dict())
        twin.layers[1].mlp.w_up[5, 300] = float("nan")
        return twin

    # the arms after the first serve 8 new tokens a request (16 steps, the
    # plants after step 3 as before): the CPU side's full-width readout
    # holds the phase's time
    base = serving_config()
    short = dict(max_new=8)
    arms = {
        "paged": dict(cfg=base),
        "a-gathered": dict(cfg=dataclasses.replace(base, paged_decode="off"),
                           drive=short),
        "b-gathered-prefill": dict(cfg=dataclasses.replace(base, paged_prefill="off"),
                                   drive=short),
        "c-repair-off": dict(cfg=dataclasses.replace(base, repair="off"),
                             drive=dict(plant_after=None, **short)),
        "register": dict(cfg=base, model=register_twin, drive=short),
        "neighbor-mean": dict(cfg=base, space=dict(mode="memory",
                                                   policy="neighbor_mean"),
                              drive=short),
        "drain2": dict(cfg=dataclasses.replace(base, drain_interval=2),
                       drive=dict(deferred=True, **short)),
    }
    prompts = requests(cfg.vocab)
    for name, arm in arms.items():
        t0 = time.perf_counter()
        outs = []
        for model in (gpu, cpu):
            if "model" in arm:
                model = arm["model"](model)
            space = ApproxSpace(**arm["space"]) if "space" in arm else None
            eng = Engine(model, arm["cfg"], space=space, device=model.device)
            res = drive(eng, prompts, **arm.get("drive", {}))
            m = eng.metrics()
            outs.append(dict(
                tokens=[r["tokens"] for r in res],
                page_events=eng.pool.page_events.tolist(),
                stats=eng.stats_dict(), kernel_counts=eng.kernel_counts.tolist(),
                n_host_syncs=m["n_host_syncs"], gathers=m["pool_gathers"],
            ))
        for key in outs[0]:
            if outs[0][key] != outs[1][key]:
                raise AssertionError(f"parity arm {name}: {key} differs between "
                                     "card and CPU")
        log(f"parity ok arm={name}: 2-layer f32, stats {outs[0]['stats']}, "
            f"kernel_counts {outs[0]['kernel_counts']}, host syncs "
            f"{outs[0]['n_host_syncs']}, pool gathers {outs[0]['gathers']} "
            f"({time.perf_counter() - t0:.1f} s)")


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


# ------------------------------------------------------------ phases 6-9
# mLSTM kernel geometry: one xlstm-1.3b block's mLSTM over a 2,048-token
# prompt (d_inner 4096 over 4 heads)
ML_B, ML_H, ML_S, ML_Q, ML_P = 1, 4, 2048, 128, 1024
# y tolerance (rtol = atol), kernel vs plain version on the same card, for
# both input dtypes: both repair in the storage dtype and then compute in
# f32, so only the summation order differs (tests/test_mlstm_kernel.py
# holds the reference kernel to its oracle at 5e-4 in f32)
MLSTM_TOL = 5e-4
# the neighbor_mean operands' tile offsets in the mLSTM, scaled so q.k and
# the state stay in the range MLSTM_TOL was set for
NM_MLSTM_SCALE = 0.25
# The full-width bf16 forward holds the kernel against its plain version
# block by block (each mLSTM block's y on that block's own inputs,
# MLSTM_TOL), not at the logits: in bf16 one f32 ulp on one block's y flips
# roundings that the random-weight stack carries to tens of percent of the
# logits (the phase measures and prints that control).  The composed
# blocks are held at the logits in f32, at full depth (DEPTH_TOL) and at
# 8 blocks card against CPU (PARITY_TOL).
# Full depth in f32, kernel vs plain version in every mLSTM block on the
# same card, held on the relative norm of the logits' difference.  Each
# block's y differs by summation order only, but the random-weight stack
# amplifies: one f32 ulp on block 0's y alone moves the logits by ~5e-4
# of their norm (the phase's one-ulp control), so an elementwise logits
# tolerance measures the stack, not the kernel.  The kernel's divergence
# must stay under DEPTH_TOL and within DEPTH_CONTROL_X times the control
# (42 blocks, each a few ulps apart); a defect in how blocks compose
# (state, layer order, weights) moves the logits by O(1).
DEPTH_S = 256
DEPTH_TOL = 1e-2
DEPTH_CONTROL_X = 10.0
# Card vs CPU at f32, 8 blocks (rtol = atol): the two mLSTM paths differ by
# ~3e-6 of |y| per block (summation order), which the stack amplifies to a
# few 1e-3 of |logit| <= ~10
PARITY_TOL = 1e-2
XL_PROMPTS, XL_PROMPT_LEN, XL_NEW, XL_SCRUB = 4, 32, 16, 8
PROFILE_TOKENS = 256


def _mlstm_inputs(gen, dtype, nm=False):
    """q, k, v (B, H, nc, Q, P) as tests/test_mlstm_kernel.py draws them,
    NaN and ±Inf planted across chunks and heads; f32 gates.  With ``nm``,
    each (b, h, c) tile of q, k and v carries its own offset, times
    NM_MLSTM_SCALE (q's also over sqrt(P), as q is drawn)."""
    import torch

    shape = (ML_B, ML_H, ML_S // ML_Q, ML_Q, ML_P)
    dev = gen.device
    q = torch.randn(shape, generator=gen, device=dev) / ML_P ** 0.5
    k = torch.randn(shape, generator=gen, device=dev)
    v = torch.randn(shape, generator=gen, device=dev)
    li = torch.randn(shape[:4], generator=gen, device=dev) * 0.5
    lf = torch.nn.functional.logsigmoid(
        torch.randn(shape[:4], generator=gen, device=dev) + 2.0)
    if nm:
        rows = ML_B * ML_H * ML_S
        for x, scale in ((q, NM_MLSTM_SCALE / ML_P ** 0.5), (k, NM_MLSTM_SCALE),
                         (v, NM_MLSTM_SCALE)):
            x += _tile_offsets(rows, ML_P, (ML_Q, ML_P), dev, scale).view(shape)
    nan, inf = float("nan"), float("inf")
    for x, spots in ((q, [((0, 1, 3, 5, 17), nan), ((0, 2, 9, 0, 1000), inf)]),
                     (k, [((0, 0, 4, 127, 2), -inf), ((0, 3, 11, 64, 512), nan)]),
                     (v, [((0, 1, 7, 3, 900), inf), ((0, 2, 15, 100, 0), nan),
                          ((0, 3, 0, 0, 33), -inf)])):
        for idx, val in spots:
            x[tuple(i % n for i, n in zip(idx, shape))] = val
    return q.to(dtype), k.to(dtype), v.to(dtype), li, lf


def mlstm_phase(report: dict) -> None:
    import gc

    import torch

    from repro_torch.kernels import common, tile_fill
    from repro_torch.kernels import mlstm_chunk as mc

    gc.collect()
    torch.cuda.empty_cache()       # the engine's model is gone: free its pages
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)

    def off_by_one(t):
        return torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(
            t.shape).copy_(t)

    # f32 takes the FFMA route; bf16 the wgmma route, and the FFMA route on
    # the same values 2 bytes off alignment.  The bf16 operands are timed
    # below on both routes.
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        x = _mlstm_inputs(gen, dtype)
        if dtype == torch.float32:
            ops = {"ffma": x}
        else:
            ops = {"wgmma": x, "ffma": [off_by_one(t) for t in x[:3]] + list(x[3:])}
        for name, x in ops.items():
            if mc.route(*x[:3]) != name:
                raise AssertionError(f"mlstm {str(dtype)[6:]} operands take "
                                     f"{mc.route(*x[:3])}, not {name}")
            off = ", q/k/v 2 bytes off alignment" if x[0].data_ptr() % 16 else ""
            for include_inf in (True, False):
                for policy, constant in (("zero", 0.0), ("constant", 0.5)):
                    kw = dict(policy=policy, constant=constant,
                              include_inf=include_inf)
                    what = (f"mlstm_chunk {str(dtype)[6:]} {policy} "
                            f"include_inf={include_inf} ({name}{off})")
                    got = mc.mlstm_chunk_raw(*x, **kw)
                    want = mc.mlstm_chunk_plain(*x, **kw)
                    if not torch.equal(got[1].cpu(), want[1].cpu()):
                        raise AssertionError(f"{what}: counts {got[1].tolist()} vs "
                                             f"{want[1].tolist()}")
                    n_inf = int(got[1][mc.INF_Q] + got[1][mc.INF_KV])
                    if int(got[1][mc.NAN_Q] + got[1][mc.NAN_KV]) != 3 or \
                            n_inf != (4 if include_inf else 0):
                        raise AssertionError(f"{what}: planted lanes miscounted "
                                             f"{got[1].tolist()}")
                    torch.testing.assert_close(got[0], want[0], rtol=MLSTM_TOL,
                                               atol=MLSTM_TOL, equal_nan=True,
                                               msg=what)
                    fin = torch.isfinite(got[0])
                    err = float((got[0] - want[0])[fin].abs().max())
                    max_err = max(max_err, err)
                    log(f"mlstm ok  {what}: counts={got[1].tolist()} "
                        f"max_abs_err={err:.3g} finite={float(fin.float().mean()):.4f} "
                        f"tol={MLSTM_TOL}")
        del got, want

    # ---- neighbor_mean: one xlstm-1.3b mLSTM block in bf16 on both routes,
    # a table per operand ((b, h, c) tiles, each with its own offset), one v
    # tile fatal in every lane (its lanes take 0); the wgmma route splits
    # the repaired v into hi/lo
    x = _mlstm_inputs(gen, torch.bfloat16, nm=True)
    v_nm = x[2].clone()
    v_nm[0, 1, 3] = float("nan")
    nm_ops = {"wgmma": [x[0], x[1], v_nm, *x[3:]],
              "ffma": [off_by_one(t) for t in (x[0], x[1], v_nm)] + list(x[3:])}
    kw = dict(policy="neighbor_mean")
    common.reset_launches()
    got = {name: mc.mlstm_chunk_raw(*xs, **kw) for name, xs in nm_ops.items()}
    report["nm_launches"].update(common.LAUNCHES)
    want = mc.mlstm_chunk_plain(*nm_ops["wgmma"], **kw)
    B_, H_, nc_, Q_, P_ = x[0].shape
    consts = common.detector_operand(common.resolve_detector(None, True),
                                     torch.bfloat16)
    t_err = 0.0
    for t in nm_ops["wgmma"][:3]:
        g = tile_fill.tile_fill(t, B_ * H_ * nc_ * Q_, P_, (Q_, P_), consts)
        w = tile_fill.tile_fill_plain(t, B_ * H_ * nc_ * Q_, P_, (Q_, P_), consts)
        t_err = max(t_err, float((tile_fill.values(g, torch.bfloat16)
                                  - tile_fill.values(w, torch.bfloat16)).abs().max()))
    nm_err = report["nm_err"]
    nm_err["tile_fill"] = max(nm_err["tile_fill"], t_err)
    for name, g in got.items():
        what = f"mlstm_chunk bf16 neighbor_mean ({name})"
        xs = nm_ops[name]
        if mc.route(*xs[:3]) != name:
            raise AssertionError(f"{what}: took {mc.route(*xs[:3])}")
        if not torch.equal(g[1].cpu(), want[1].cpu()):
            raise AssertionError(f"{what}: counts {g[1].tolist()} vs "
                                 f"{want[1].tolist()}")
        torch.testing.assert_close(g[0], want[0], rtol=MLSTM_TOL, atol=MLSTM_TOL,
                                   equal_nan=True, msg=what)
        err = float((g[0] - want[0]).nan_to_num(0.0).abs().max())
        controls = _nm_controls(
            lambda xs=xs, **o: mc.mlstm_chunk_raw(*xs, **{**kw, **o}),
            dict(q=xs[0], k=xs[1], v=xs[2]), dict(policy="zero"),
            lambda out: _tol_ratio(out[0], want[0], MLSTM_TOL, MLSTM_TOL))
        nm_err["mlstm_chunk"] = max(nm_err["mlstm_chunk"], err)
        log(f"nm ok  {what}: counts={g[1].tolist()} max_abs_err y {err:.3g} "
            f"tol={MLSTM_TOL}, q/k/v fills (table vs plain) {t_err:.3g}; "
            f"controls {_fmt_controls(controls)}")
    del got, want, nm_ops, v_nm
    nm = report["nm_launches"]
    for k_name in ("tile_fill", "scrub", "paged_decode", "paged_prefill",
                   "repair_matmul", "flash_attention", "mlstm_chunk"):
        if nm.get(k_name, 0) < 1:
            raise AssertionError(f"no neighbor_mean call launched {k_name}")
    tf = report["kernels"]["tile_fill"]
    tf.update(launches=int(nm["tile_fill"]), max_abs_err=nm_err["tile_fill"])
    log(f"nm launches (the neighbor_mean calls, counted from 0 before each "
        f"and read after): {dict(nm)}; max_abs_err against the plain "
        f"versions: {nm_err}")

    # ---- timing, bf16, at the forward's shapes: the wgmma route (the main
    # path's) and the FFMA route, on the operands checked above
    nc = ML_S // ML_Q
    nbytes = (3 * ML_B * ML_H * ML_S * ML_P * 2 + 2 * ML_B * ML_H * ML_S * 4
              + ML_B * ML_H * ML_S * ML_P * 4 + 32)
    # W is causal (j <= t): q k^T and W v count their lower halves, as
    # flash_attention's bound does; q C and the C update are dense
    flops = nc * ML_B * ML_H * (2.0 * ML_Q * ML_Q * ML_P + 4.0 * ML_Q * ML_P * ML_P)
    bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
    timed = {}
    for name in ("wgmma", "ffma", "ffma", "wgmma"):
        x = ops[name]
        # device ms from a full queue of launches; the profiler splits it
        timed.setdefault(name, []).append(queued_ms(lambda: mc.mlstm_chunk_raw(*x)))
    for name, x in ops.items():
        # per launch: the profiler drops some of these kernels' events
        split = kernel_breakdown(lambda: mc.mlstm_chunk_raw(*x), MLSTM_KERNELS[name],
                                 iters=5, per_launch=True)
        call = cuda_ms(lambda: mc.mlstm_chunk_raw(*x), iters=10)
        off = ", q/k/v 2 bytes off alignment" if name == "ffma" else ""
        log(f"timing mlstm_chunk ({name} route{off}): "
            f"device {min(timed[name]):.4f} ms (turns "
            f"{', '.join(f'{t:.4f}' for t in timed[name])}; profiler "
            + " + ".join(f"{k.rstrip('<')} {v:.4f}" for k, v in split.items())
            + f"), call {call:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
        if name == "wgmma":
            row = dict(ms=call, device_ms=min(timed[name]),
                       split={k.rstrip("<"): v for k, v in split.items()})
    x = ops["wgmma"]
    row.update(plain_ms=cuda_ms(lambda: mc.mlstm_chunk_plain(*x), iters=5),
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
               ffma_device_ms=min(timed["ffma"]), route="cuda",
               source="src/repro_torch/csrc/mlstm_chunk.cu",
               replaces="src/repro/kernels/mlstm_chunk.py:46 (_mlstm_kernel)",
               max_abs_err=max_err)
    report["kernels"]["mlstm_chunk"] = row
    log(f"timing mlstm_chunk: call {row['ms']:.4f} ms (device {row['device_ms']:.4f}, "
        f"wgmma route; FFMA route {row['ffma_device_ms']:.4f}), plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
        f"({row['bound_by']}; {flops:.4g} flop, {nbytes} bytes), library null "
        f"(no single PyTorch call computes a chunked mLSTM), max_abs_err {max_err}")
    log(f"timing shapes: mlstm_chunk B={ML_B} H={ML_H} nc={nc} Q={ML_Q} "
        f"P={ML_P} bf16, NaN/Inf planted")


def _xlstm_cfg(**changes):
    from repro_torch.configs import get_config
    from repro_torch.runtime import ApproxConfig

    # a kernel fill, so the serving scrub runs the scrub kernel on the cache
    return dataclasses.replace(
        get_config("xlstm-1.3b"),
        repair=ApproxConfig(mode="memory", policy="zero"), **changes)


def _plain_and_control(model, tokens):
    """The forward's logits with the plain version in every mLSTM block,
    and the control: the kernel, with block 0's y moved by one f32 ulp."""
    from unittest import mock

    from repro_torch.kernels import mlstm_chunk as mc

    kernel = mc.mlstm_chunk_raw
    with mock.patch.object(mc, "mlstm_chunk_raw", mc.mlstm_chunk_plain):
        plain = model(tokens)
    calls = []

    def one_ulp(*a, **k):
        y, c = kernel(*a, **k)
        calls.append(1)
        return (y * (1 + 2.0 ** -23) if len(calls) == 1 else y), c

    with mock.patch.object(mc, "mlstm_chunk_raw", one_ulp):
        control = model(tokens)
    return plain, control


def _divergence(x, ref) -> dict:
    return dict(max_abs=float((x - ref).abs().max()),
                rel=float((x - ref).norm() / ref.norm()),
                argmax_agree=float((x.argmax(-1) == ref.argmax(-1))
                                   .float().mean()))


def xlstm_forward_phase(report: dict) -> None:
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.kernels import common
    from repro_torch.kernels import mlstm_chunk as mc
    from repro_torch.models import build_model

    cfg = _xlstm_cfg()
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"xlstm: {cfg.name} blocks={cfg.n_layers} d_model={cfg.d_model} "
        f"{cfg.dtype_name} params={n_params} init {time.perf_counter() - t0:.2f} s")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(1, ML_S))).cuda()
    n_mlstm = len(model.mlstm_layers)

    common.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, counts = model(tokens, with_counts=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    if launches.get("mlstm_chunk", 0) != n_mlstm or n_mlstm != 42:
        raise AssertionError(f"forward launched {launches}, expected "
                             f"mlstm_chunk once per mLSTM block (42)")
    if counts.tolist() != [0] * 8:
        raise AssertionError(f"clean forward counted {counts.tolist()}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("forward logits are not finite")
    report["kernels"]["mlstm_chunk"]["launches"] = launches["mlstm_chunk"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model(tokens)
    torch.cuda.synchronize()
    warm_ms = 1e3 * (time.perf_counter() - t0)
    report["xlstm_model"] = model

    # the plain version beside the kernel in every mLSTM block, on the
    # block's own inputs
    block_err = []
    kernel = mc.mlstm_chunk_raw

    def beside(*a, **k):
        got, want = kernel(*a, **k), mc.mlstm_chunk_plain(*a, **k)
        what = f"forward mLSTM block {len(block_err)}"
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"{what}: counts {got[1].tolist()} vs "
                                 f"{want[1].tolist()}")
        torch.testing.assert_close(got[0], want[0], rtol=MLSTM_TOL,
                                   atol=MLSTM_TOL,
                                   msg=lambda m: f"{what}: {m}")
        block_err.append(float((got[0] - want[0]).abs().max()))
        return got

    with mock.patch.object(mc, "mlstm_chunk_raw", beside):
        again = model(tokens)
    if len(block_err) != n_mlstm or not torch.equal(again, logits):
        raise AssertionError("forward with the plain version beside the kernel "
                             "is not the kernel's forward")
    # end to end: the plain version in every block, and the control — the
    # kernel with block 0's y moved by one f32 ulp
    plain, control = _plain_and_control(model, tokens)
    if not bool(torch.isfinite(plain).all()):
        raise AssertionError("the plain forward's logits are not finite")
    # where the device time goes: a profiled forward over the first
    # PROFILE_TOKENS tokens (every family is linear in the length; the
    # whole prompt's ~3e5 launches take minutes to profile), device only
    short = tokens[:, :PROFILE_TOKENS]
    model(short)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model(short)
    torch.cuda.synchronize()
    short_ms = 1e3 * (time.perf_counter() - t0)
    per = device_profile(lambda: model(short))
    groups = {"mlstm_chunk": 0.0, "gemm": 0.0, "other": 0.0}
    for key, ms in per.items():
        if any(n in key for n in KERNEL_NAMES["mlstm_chunk"]):
            groups["mlstm_chunk"] += ms
        elif any(n in key.lower() for n in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
            groups["gemm"] += ms
        else:
            groups["other"] += ms
    report["xlstm_forward"] = dict(
        params=n_params, tokens=ML_S, first_ms=1e3 * first_s, warm_ms=warm_ms,
        tokens_per_s=ML_S / (warm_ms / 1e3), launches=launches,
        block_max_abs_err=max(block_err),
        plain_vs_kernel=_divergence(plain, logits),
        one_ulp_control_vs_kernel=_divergence(control, logits),
        profiled_tokens=PROFILE_TOKENS, profiled_wall_ms=short_ms,
        profiled_device_ms=groups,
        profiled_idle_share=1.0 - sum(groups.values()) / short_ms,
    )
    log("xlstm forward: " + json.dumps(report["xlstm_forward"]))


def _plant_before(space, scrub_no: int, plants, log_deltas: list):
    """Wrap ``space.scrub``: before its ``scrub_no``-th call set
    ``plants`` ([(path, index, value)]) in the cache; log every call's
    [nan_found, inf_found, events] delta."""
    inner = space.scrub

    def scrub(cache, stats, *, trigger="forced"):
        if len(log_deltas) + 1 == scrub_no:
            for path, idx, val in plants:
                cache[path][idx] = val
        cache, out = inner(cache, stats, trigger=trigger)
        log_deltas.append([out[k] - stats[k]
                           for k in ("nan_found", "inf_found", "events")])
        if len(log_deltas) == scrub_no:
            for path, leaf in cache.items():
                if not bool(torch.isfinite(leaf).all()):
                    raise AssertionError(f"{path}: a fatal lane survived the scrub")
        return cache, out

    import torch

    space.scrub = scrub


def _checked_steps(model, seen: list):
    """Wrap ``model.serve_step`` so every step's logits must be finite."""
    import torch

    inner = model.serve_step

    def serve_step(cache, tokens, pos=None):
        logits, cache = inner(cache, tokens, pos)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"step {pos}: logits are not finite")
        seen.append(pos)
        return logits, cache

    model.serve_step = serve_step


# faults planted before the 2nd interval scrub (step XL_SCRUB): NaN in the
# matrix memory C of one mLSTM block, Inf in the cell state c of one sLSTM
# block
XL_PLANTS = [("mlstm_groups/C", (2, 3, 1, 0, 5, 7), float("nan")),
             ("mlstm_groups/C", (0, 6, 3, 2, 1000, 1), float("nan")),
             ("slstm_layers/c", (4, 2, 1, 100), float("inf"))]


def xlstm_generate_phase(report: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels import common
    from repro_torch.launch import serve

    model = report["xlstm_model"]
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab, size=(XL_PROMPTS, XL_PROMPT_LEN)))
    space = serve.serve_space(model, XL_SCRUB, memoize=False)
    deltas, steps = [], []
    _plant_before(space, 2, XL_PLANTS, deltas)
    _checked_steps(model, steps)
    common.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens, stats = serve.generate(model, prompts, max_new=XL_NEW,
                                   max_seq=XL_PROMPT_LEN + XL_NEW, space=space)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del model.serve_step                     # drop the checking wrapper
    launches = dict(common.LAUNCHES)
    n_steps = XL_PROMPT_LEN + XL_NEW - 1
    if tokens.shape != (XL_PROMPTS, XL_PROMPT_LEN + XL_NEW) or len(steps) != n_steps:
        raise AssertionError(f"generate: {tuple(tokens.shape)}, {len(steps)} steps")
    if deltas[1][:2] != [2, 1] or any(d[:2] != [0, 0] for i, d in enumerate(deltas) if i != 1):
        raise AssertionError(f"scrubs found {deltas}, planted [2, 1] before the 2nd")
    if launches.get("scrub", 0) < len(deltas):
        raise AssertionError(f"the cache scrub did not run the kernel: {launches}")
    # the same run again, unchecked and unplanted: the warm timing
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve.generate(model, prompts, max_new=XL_NEW, max_seq=XL_PROMPT_LEN + XL_NEW,
                   space=serve.serve_space(model, XL_SCRUB, memoize=False))
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    cache_bytes = sum(
        int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
        for shape, dt in model.cache_defs(XL_PROMPTS).values())
    report["xlstm_generate"] = dict(
        steps=n_steps, scrubs=len(deltas), scrub_deltas=deltas, stats=stats,
        launches=launches, first_wall_s=wall, warm_wall_s=warm,
        ms_per_step=1e3 * warm / n_steps,
        new_tokens_per_s=XL_PROMPTS * XL_NEW / warm,
        cache_bytes=cache_bytes,
    )
    log("xlstm generate: " + json.dumps(report["xlstm_generate"]))
    del report["xlstm_model"]


def xlstm_depth_phase(report: dict) -> None:
    import gc

    import numpy as np
    import torch

    from repro_torch.kernels import common
    from repro_torch.models import build_model

    gc.collect()
    torch.cuda.empty_cache()        # the bf16 model is gone
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _xlstm_cfg(dtype_name="float32")
    model = build_model(cfg, device="cuda", seed=0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(1, DEPTH_S))).cuda()
    common.reset_launches()
    t0 = time.perf_counter()
    logits, counts = model(tokens, with_counts=True)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    if launches.get("mlstm_chunk", 0) != 42:
        raise AssertionError(f"f32 forward launched {launches}, expected "
                             f"mlstm_chunk once per mLSTM block (42)")
    if counts.tolist() != [0] * 8 or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"f32 forward: counts {counts.tolist()}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    plain, control = _plain_and_control(model, tokens)
    div, ctl = _divergence(plain, logits), _divergence(control, logits)
    report["xlstm_depth"] = dict(
        blocks=cfg.n_layers, tokens=DEPTH_S, dtype="float32",
        kernel_forward_s=kernel_s, max_abs_logit=float(logits.abs().max()),
        plain_vs_kernel=div, one_ulp_control_vs_kernel=ctl,
        tol=DEPTH_TOL, control_x=DEPTH_CONTROL_X,
    )
    log("xlstm depth: " + json.dumps(report["xlstm_depth"]))
    if not div["rel"] <= min(DEPTH_TOL, DEPTH_CONTROL_X * ctl["rel"]):
        raise AssertionError(
            f"full-depth f32 logits, kernel vs plain: relative {div['rel']:.4g} "
            f"over min({DEPTH_TOL}, {DEPTH_CONTROL_X} x control {ctl['rel']:.4g})")
    del model, logits, plain, control
    gc.collect()
    torch.cuda.empty_cache()


def xlstm_parity_phase(report: dict) -> None:
    import gc

    import numpy as np
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import XLSTMLM

    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _xlstm_cfg(n_layers=8, dtype_name="float32")
    gpu = XLSTMLM(cfg, device="cuda", seed=0)
    cpu = XLSTMLM(cfg, device="cpu", seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, 256)))
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 16)))
    outs = []
    for model in (gpu, cpu):
        t0 = time.perf_counter()
        logits, counts = model(tokens.to(model.device), with_counts=True)
        space = serve.serve_space(model, XL_SCRUB, memoize=False)
        deltas = []
        _plant_before(space, 2, [
            ("mlstm_groups/C", (0, 3, 1, 0, 5, 7), float("nan")),
            ("slstm_layers/c", (0, 1, 0, 10), float("inf"))], deltas)
        tok, stats = serve.generate(model, prompts, max_new=8, max_seq=24,
                                    space=space)
        outs.append(dict(logits=logits.cpu(), counts=counts.tolist(),
                         tokens=tok.tolist(), stats=stats, deltas=deltas,
                         rule_stats=space.rule_stats()))
        log(f"xlstm parity: {model.device} {time.perf_counter() - t0:.2f} s")
    card, host = outs[0]["logits"], outs[1]["logits"]
    diff = float((card - host).abs().max())
    log(f"xlstm parity: 8 blocks f32, logits max |diff| {diff:.4g}, relative "
        f"{float((card - host).norm() / host.norm()):.4g}, max |logit| "
        f"{float(host.abs().max()):.4g} (tol {PARITY_TOL})")
    torch.testing.assert_close(card, host, rtol=PARITY_TOL, atol=PARITY_TOL,
                               msg="parity: forward logits card vs CPU")
    for key in ("counts", "tokens", "stats", "deltas", "rule_stats"):
        if outs[0][key] != outs[1][key]:
            raise AssertionError(f"parity: {key} differs between card and CPU: "
                                 f"{outs[0][key]} vs {outs[1][key]}")
    log(f"xlstm parity ok: counts {outs[0]['counts']}, tokens equal, scrub "
        f"deltas {outs[0]['deltas']}, stats {outs[0]['stats']}")


def _kernel_name(mangled: str) -> str:
    """A mangled kernel's own name, the last component of its (nested)
    name, with its template arguments: ``_ZN..2wg16mlstm_scan_wgmmaE..``
    gives ``mlstm_scan_wgmma``, ``_ZN..20prefill_repair_wgmmaILi2ELi64EE..``
    gives ``prefill_repair_wgmma<2,64>``."""
    nested = mangled.startswith("_ZN")
    i, name = 3 if nested else 2, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
        if not nested:
            break
    if mangled[i:i + 1] == "I":
        args, i = [], i + 1
        while i < len(mangled) and mangled[i] != "E":
            m = re.match(r"L\w(\d+)E|(\d+)|(\w)", mangled[i:])
            if m.group(2):           # a length-prefixed name
                j = i + len(m.group(2))
                args.append(mangled[j:j + int(m.group(2))])
                i = j + int(m.group(2))
            else:                    # a literal, or a builtin type's letter
                args.append(m.group(1) or m.group(3))
                i += m.end()
        name += f"<{','.join(args)}>"
    return name


def ptxas_summary(text: str) -> dict:
    """Per kernel of one ``-Xptxas -v`` build log, in build order: its
    registers, stack frame and spills, and how many ``warpgroup.arrive``
    ptxas injected between two ``wgmma`` (C7519: it serialises them)."""
    found: dict = {}
    current = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)", line)
        if m:
            current = m.group(1)
            found.setdefault(current, ([], [0]))
            continue
        m = re.search(r"\(C7519\).* in function '(\w+)'", line)
        if m:
            found.setdefault(m.group(1), ([], [0]))[1][0] += 1
        elif current and ("stack frame" in line or "Used " in line):
            found[current][0].append(line.split(" : ")[-1].strip())
    out = {}
    for mangled, (info, injected) in found.items():
        name = _kernel_name(mangled)
        while name in out:
            name += "'"
        out[name] = info + [f"{injected[0]} warpgroup.arrive injected (C7519)"]
    return out


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
        for kernel, info in ptxas_summary(_native.build_log(name)).items():
            log(f"ptxas {name} {kernel}: " + ", ".join(info))
    report: dict = {}
    for phase in (kernel_phase, ops_phase, engine_phase, fallback_phase,
                  prefix_tier_phase, parity_phase, injection_phase, mlstm_phase,
                  xlstm_forward_phase, xlstm_generate_phase, xlstm_depth_phase,
                  xlstm_parity_phase):
        t0 = time.perf_counter()
        phase(report)
        log(f"{phase.__name__}: {time.perf_counter() - t0:.2f} s")
    kernels = []
    for name, row in report["kernels"].items():
        row.setdefault("launches", int(report["launches"].get(name, 0)))
        kernels.append(dict(name=name, **row))
    log(json.dumps({"kernels": kernels}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
