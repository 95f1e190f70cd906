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
     (bf16 x bf16 products take repair_matmul's wgmma route, f32 x f32 its
     f32 route, mixed dtypes its FFMA route: ``kernels.repair_matmul.route``;
     16-bit attention takes flash_attention's wgmma route, f32 its f32 route
     (also held against the plain twin of its key partition), unaligned
     views its FFMA route: ``kernels.repair_attention.route``; every ``ops
     ok`` line names it);
     the same checks at the quickstart's shapes and blocks (512³ matmul,
     blocks (128, 128, 256); attention 1×4×256×64 over Kh=2, blocks
     (64, 64)); then the quickstart twin (``examples/torch_quickstart.py``) on the
     card with its Table-3 asserts, and both kernels timed: repair_matmul
     at gate/up in bf16 on planted and on clean operands (the wgmma kernel
     must show in the profile; scan, main kernel and counts apart), in f32
     on planted and on clean operands (the f32 route: scan, repair_mm_f32
     and counts apart, the flagged tiles, TFLOP/s and the share of the FP32
     bound; the FFMA route on the same values 4 bytes off alignment;
     torch.matmul f32 with TF32 off) and at the down projection;
     flash_attention causal bf16 at S=T=2048 on planted and on clean
     operands (the wgmma kernel must show in the profile; scan, main kernel
     and counts apart, beside SDPA's call; the clean call also replayed
     from a CUDA graph) and in f32 likewise (the f32 route, beside the FFMA
     route 4 bytes off alignment and SDPA in f32 on its math path and on
     its memory-efficient kernel); ``neighbor_mean`` (``nm ok`` lines): the
     gate/up product and the 2,048-token attention in bf16 (wgmma routes),
     the quickstart's f32 shapes (f32 routes), each against its plain version,
     each operand's ``tile_fill`` table against the plain one, memory
     mode's origin scrub against the plain scrub, on operands whose tiles
     carry their own offsets, with the controls as above; one ``timing tile_fill``
     line (device ms at the gate/up A operand and at the engine pool's
     layer beside their bytes bounds, and the calls with the mean against
     the zero fill's)
  3. the engine at full width (28 layers, bf16, random weights from seed
     0): 6 requests, faults planted after step 3, repair and launch checks
  3b. the fallback arms on the same requests, on a model of their own
     (Qwen2-1.5B width cut to FALLBACK_LAYERS = 4 layers), each cold (its
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
     on the card (kernels) and on the CPU (plain versions), in six arms:
     paged, (a), (b), (c), a ``neighbor_mean`` space and
     ``drain_interval=2``; and register mode (a NaN weight lane) on the
     card against the same model with that lane 0, both gathered
  5. the injection arm: ber=1e-7 for 4 steps
  5a. the dense variants (``dense_variants_phase``): StableLM-1.6B
     (LayerNorm, SwiGLU, 25 % rotary, 32 KV heads of 64, untied head) and
     StarCoder2-15B (LayerNorm, the GeLU MLP with biases, QKV bias, 48
     heads on 4 KV heads of 128, untied head).  The paged kernels at each
     model's pool (P=65, pg=16, B=4, M=8; StableLM L=24, Kh=32, Dh=64,
     H=32; StarCoder2 L=40, Kh=4, Dh=128, H=48) in bf16 and in f32, planted
     as in phase 2, under two detectors, against their plain versions
     (decode at splits 1 and 4 on the fused route, but on the heads route
     for StableLM's f32 pool, whose slot needs 256 KiB: one block a KV
     head after the page scan; a q off alignment on the walk route; prefill
     at C and C_LONG on the wgmma route in bf16 and the FFMA route (the
     page scan, then one block per KV head's 32 rows) in f32, and a bf16 q
     off alignment on FFMA; the engine's page scrub of three pages bucketed
     to four, bits and counts), then timed, bf16 and f32 at both pools, on
     the planted pool and a clean copy beside their bound and SDPA on the
     gathered view (its backend logged; the fused and heads decodes beside
     the walk route's times on a q off alignment);
     each model served at full width in bf16 (seed 0) through
     ``Engine.step`` with the engine cell's requests and plants, cold (its
     checks), warm (timed) and profiled: one ``timing dense <arch>:`` line
     (ms a step, tokens/s, launches and device ms a step by group, idle
     share, init s, peak memory; the profile must show the fused decode
     and the wgmma prefill and neither other route); card against CPU at 2
     layers in f32 with the biases and norm parameters drawn nonzero, both
     on the paged lanes.  Every model is freed before the phase returns
  5b. training at full qwen2-1.5b width and depth (``train_phase``): bf16
     params, f32 AdamW moments, batch 4 x 512, 5 steps in memory mode with
     a zero fill.  NaN and ±Inf planted in ``params/layers/mlp/w_down`` and
     ``opt/nu/embed/table`` before step 2: the boundary scrub (the scrub
     kernel, one launch a leaf) must count what ``scrub_plain`` counts on
     clones of those leaves, leave them bit-equal to the plain scrub's, the
     planted lanes holding the fill, and every loss finite; the same plants
     with repair off must poison the run within 2 steps; register mode (2
     layers) with a NaN weight lane keeps the loss and every gradient
     finite; the card's loss and gradients match the CPU's (2 layers, f32,
     TF32 off, 128 tokens) within TRAIN_CPU_RTOL; ``matmul_f32``'s bf16
     backward is held against the f64 products, and a control that rounds
     the cotangent first must fail.  One ``timing train:`` line: ms a warm
     step, the device idle share, device ms by group, launches a step, peak
     memory, the boundary scrub's and the AdamW update's device ms beside
     their bytes bounds, and the step's model FLOPs beside its bound
  5c. checkpointing (``checkpoint_phase``) at qwen2-1.5b width cut to 4
     layers (4.21 GB a save): after 2 steps, NaN and ±Inf planted in a
     weight and a moment of the live state, then an async save: the save
     scrub (the scrub kernel on a copy, one launch a float leaf) must
     count what ``scrub_plain`` counts on the same leaves, leave the live
     state's bits as they were, and write a finite file bit-equal to
     ``scrub_plain`` of the copy; ``restore(repair=True)`` bit-equal to
     the file; lanes planted after the restore take the checkpoint's bits
     back through ``reference_repair``; ``train_loop`` with a checkpoint
     every 2 of 4 steps, restored at step 2 and resumed, within
     CKPT_RESUME_RTOL of the uninterrupted run (bit-equality reported).
     One ``timing checkpoint:`` line: the save's blocking and write ms
     with GB/s, the restore's ms, the save scrub's device ms beside its
     bytes bound and its launches
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
  10. xLSTM training at full xlstm-1.3b width, XT_LAYERS = 16 of its 48 blocks
     (``xlstm_train_phase``): bf16 params, f32 moments, batch 4 x 128, 3
     steps in memory mode with a zero fill (the mLSTM in chunks of 32: at
     128 the reference's gradient is NaN, ROADMAP §3), NaN and ±Inf planted in a
     weight and a moment before step 2: the boundary scrub over the ~12 GB
     state (the scrub kernel, one launch a leaf: 20 params + 40 moments)
     must count what ``scrub_plain`` counts and leave the planted leaves
     bit-equal to it; no mLSTM kernel launches (training runs the plain
     chunked mLSTM under autograd); the same plants with repair off poison
     the run; the card's loss and gradients against the CPU's at one group
     (8 blocks, f32, 64 tokens) within XT_CPU_RTOL.  One ``timing xlstm train:`` line, as train_phase's
  11. the autopilot (``autopilot_phase``): (a) the campaign's serve
     episodes on the engine cell's Qwen2-1.5B (28 layers, bf16) over the
     transformer preset's groups (``ffn_weights``: range-guarded
     ``neighbor_mean``, the tensor-level repair; ``kv_cache``: zero fill,
     the scrub kernel) at its four refresh points, 8 steps, batch 2, prompt
     8: one line per cell (quality, flips beside their Poisson mean, held
     within AP_SIGMAS, faults a step, approximate bytes, energy saving,
     the episode's seconds and scrub launches a step); the first two
     windows of every cell change no leaf outside the group; the first two
     cells run again identical; (b) ``solve_frontier`` at AP_BUDGET (each
     point the longest within the budget, or collapsed), the profile's and
     frontier's JSON round-tripping; (c) the engine cell with the
     frontier's rules: with its guard at BER 0 (0 trips; tokens, launches
     and scrubbed bytes as without it; ms a step in turns), then the
     ``kv_cache`` rule under a zero-expectation guard with NaN/±Inf planted
     in live K/V pages after every step from AP_PLANT_FROM while the label
     is not exact: trips stricter then exact, every request finished with
     finite logits, each trip's decision, lanes and launches printed;
     (d) ``train_loop`` at qwen2-1.5b width cut to AP_TRAIN_LAYERS layers,
     ber=AP_TRAIN_BER, one ``resident`` rule under the same guard: a trip,
     a stricter or exact rule deployed, every loss finite, the scrub
     kernel's launches a step as each step's rule implies.  One ``timing
     autopilot:`` line
  12. LLaVA-NeXT-Mistral-7B (``llava_phase``): the paged kernels and the
     page scrub at its bf16 pool (H 32, Kh 8, Dh 128) against their plain
     versions under two detectors, then timed beside SDPA as in phase 5;
     the model served at full width and depth in bf16 (14.48 GB) through
     ``Engine.step`` with the engine cell's requests and plants (tokens
     only, as the reference serves it; ``timing dense
     llava-next-mistral-7b:``); on the served model a forward of 256
     patch rows before 1,792 tokens (2,048 positions, the chunked
     attention): finite logits of the tokens alone, timed; card against
     CPU at 2 layers in f32 (TF32 off) on a patch batch: the loss and
     every gradient within TRAIN_CPU_RTOL
  13. Zamba2-7B (``zamba_phase``) at full width and depth in bf16 (81
     Mamba2 layers, two shared attention blocks of head dim 224; 15.59
     GB) through ``generate``: 4 prompts of 32 tokens, 16 new, the cache
     scrubbed every 8 steps by the scrub kernel (one launch a leaf), a NaN
     planted in the SSM state before the first scrub after the warmup,
     which must find it and leave every leaf finite before step 32 reads
     it, each leaf bit for bit and count for count as ``scrub_plain``
     leaves a copy of it, every step's logits finite; a warm and a profiled run; the
     forward over 2,048 tokens; card against CPU at 13 layers in f32 (both
     shared sets and a tail): tokens, stats, each scrub's counts and the
     scrubbed bytes equal.  One ``timing zamba:`` line: ms a step, idle
     share, device ms by group, scrub launches and bytes, the forward's
     ms, peak memory

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
import math
import os
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
LAYER = 5


@dataclasses.dataclass(frozen=True)
class PoolShape:
    """One paged pool's geometry for the kernel checks: pages (the last the
    null page), layers, page size, KV heads, head dim, query heads,
    requests and block-table slots."""
    P: int
    L: int
    PG: int
    KH: int
    DH: int
    H: int
    B: int = 4
    M: int = 8


QWEN2_POOL = PoolShape(P, L, PG, KH, DH, H, B, M)
# the dense variants' pools at the serving config: StableLM-1.6B (MHA,
# head dim 64: the fused decode route in bf16, the heads route in f32, whose
# slot needs 256 KiB) and StarCoder2-15B (48 query heads on 4 KV heads: the
# fused route, 101 KB a block in bf16)
STABLELM_POOL = PoolShape(65, 24, 16, 32, 64, 32)
STARCODER2_POOL = PoolShape(65, 40, 16, 4, 128, 48)
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


# idle host time on each side of a profiled call: the profiler keeps only
# the device events that it places inside its window, so a skew between
# the device's and the host's clocks drops the events at the window's ends
# (a whole short window's, late in a long run); a reading taken again
# doubles it on each try
PROFILE_PAD_S = 0.25


class ProfilerDropped(AssertionError):
    """Every profiler window of a reading lost device events."""


def device_profile(fn, table: str = "", counts: dict | None = None,
                   pad: float = PROFILE_PAD_S):
    """Device milliseconds by kernel name for one call of ``fn`` under
    ``torch.profiler`` (empty when the profiler records no device time),
    the window padded by ``pad`` seconds on each side.  With ``table``,
    host and device activity are both recorded and their summary tables
    written to ``chiprun_out/<table>``; with ``counts``, the number of
    launches recorded per name is added to it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if table else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        time.sleep(pad)
        fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    # device events summed by name straight from the trace: the sums of
    # ``key_averages()`` without building its event tree (15–21 s for the
    # ~95 k kernels of one engine run)
    per = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.duration_ns() / 1e6
        if ms:
            per[evt.name()] = per.get(evt.name(), 0.0) + ms
            if counts is not None:
                counts[evt.name()] = counts.get(evt.name(), 0) + 1
    if table:
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        avg = prof.key_averages()
        (out / table).write_text(
            avg.table(sort_by="self_cpu_time_total", row_limit=40) + "\n"
            + avg.table(sort_by="self_device_time_total", row_limit=40)
        )
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


def library_device_ms(fn, iters: int = 20, kernels: list | None = None):
    """Device time per call of a PyTorch library call (the yardstick beside
    a kernel; its call time is what the kernels line reports), or the text
    "not measured" when every profiler window dropped some of its events.
    With ``kernels``, the names of the device operations the counted window
    recorded are appended to it."""
    try:
        return sum(kernel_breakdown(fn, ("",), iters, names_out=kernels).values()) or None
    except ProfilerDropped as exc:
        log(f"library device time not measured: {exc}")
        return "not measured"


def sdpa_backend(names) -> str:
    """Which SDPA backend served a call, read from the names of the device
    operations its timing window recorded (``library_device_ms``'s
    ``kernels``): flash, memory-efficient, cuDNN, or the math path's
    kernels named."""
    for tag, word in (("flash", "flash"), ("memory-efficient", "fmha"),
                      ("memory-efficient", "efficient"), ("cudnn", "cudnn")):
        if any(word in n.lower() for n in names):
            return f"{tag} ({', '.join(n[:48] for n in names)})"
    return f"math ({', '.join(n[:48] for n in names)})" if names else "not measured"


def kernel_breakdown(fn, names, iters: int = 20, tries: int = 5,
                     per_launch: bool = False, names_out: list | None = None) -> dict:
    """Device ms per call of each named kernel (0.0 where none ran), or with
    ``per_launch`` per launch of it.  The profiler can drop a window's
    device events (it does for millisecond kernels).  Per call, a window
    counts only when it recorded some and every kernel's launches are a
    multiple of ``iters``; per launch, the average over the launches it
    recorded is unbiased, so a window counts when every named kernel
    recorded one.  Otherwise it is taken again with twice the pad, up to
    ``tries`` times, and then ``ProfilerDropped`` lists what each window
    recorded.  ``names_out`` (a list) gets the names of every operation the
    counted window recorded."""
    fn()
    recorded = []
    for i in range(tries):
        counts: dict = {}
        per = device_profile(lambda: [fn() for _ in range(iters)], counts=counts,
                             pad=PROFILE_PAD_S * 2 ** i)
        keys = {n: [k for k in per if n in k] for n in names}
        if per_launch:
            launches = {n: sum(counts[k] for k in keys[n]) for n in names}
            if all(launches.values()):
                return {n: sum(per[k] for k in keys[n]) / launches[n]
                        for n in names}
        elif counts and all(c % iters == 0 for c in counts.values()):
            if names_out is not None:
                names_out.extend(sorted(per))
            return {n: sum(per[k] for k in keys[n]) / iters for n in names}
        recorded.append(counts)
    raise ProfilerDropped(f"the profiler dropped device events in {tries} "
                          f"windows of {iters} calls: {recorded}")


KERNEL_NAMES = {
    "scrub": ("scrub_stream",),
    # walk route: partials + merge; fused route: one kernel (+ a memset);
    # heads route: page_scan (named under the prefill) + decode_heads
    "paged_decode": ("decode_partials", "lse_merge", "decode_fused", "decode_heads"),
    # both routes: page_scan (+ a memset), then FFMA or wgmma
    "paged_prefill": ("prefill_repair_ffma", "page_scan", "prefill_repair_wgmma"),
    # FFMA route: tiles + counts; wgmma and f32 routes: scan + main + counts
    "repair_matmul": ("repair_mm_tiles", "repair_mm_scan", "repair_mm_wgmma",
                      "repair_mm_f32", "repair_mm_counts"),
    # FFMA route: count_tiles + counts + fwd; wgmma and f32 routes: scan +
    # main + counts
    "flash_attention": ("flash_repair_fwd", "flash_count_tiles", "flash_scan",
                        "flash_repair_wgmma", "flash_repair_f32", "flash_counts"),
    # FFMA route: qk + scan; wgmma route: prep + scan_wgmma ("mlstm_scan"
    # matches both scans)
    "mlstm_chunk": ("mlstm_qk", "mlstm_prep", "mlstm_scan"),
    "tile_fill": ("tile_fill",),
}
# the paged routes' device operations, named apart for their device-time
# split (the fused decode's and the wgmma prefill's counts memset included)
DECODE_KERNELS = {"fused": ("decode_fused", "Memset"),
                  "heads": ("page_scan", "decode_heads", "Memset"),
                  "walk": ("decode_partials", "lse_merge")}
PREFILL_KERNELS = ("page_scan", "prefill_repair_wgmma", "Memset")
PREFILL_ROUTE_KERNELS = {"wgmma": PREFILL_KERNELS,
                         "ffma": ("page_scan", "prefill_repair_ffma", "Memset")}
# each route's main kernel, which a timed call must show
ROUTE_MAIN = {"fused": "decode_fused", "heads": "decode_heads",
              "walk": "decode_partials", "wgmma": "prefill_repair_wgmma",
              "ffma": "prefill_repair_ffma"}
# the mLSTM routes' kernels, named apart for their device-time split
MLSTM_KERNELS = {"ffma": ("mlstm_qk", "mlstm_scan<"),
                 "wgmma": ("mlstm_prep_wgmma", "mlstm_scan_wgmma")}
# the attention wgmma route's fault scan, timed apart (its extra K/V read)
COUNT_PASS = ("flash_scan",)


def device_ops(fn, iters: int = 20, tries: int = 5):
    """(device ms, device operations) per call of ``fn`` over every kernel,
    memset and copy the profiler records, and their names; a window counts
    only when every operation's count is a multiple of ``iters`` (else it
    is taken again with twice the pad, as in ``kernel_breakdown``)."""
    fn()
    recorded = []
    for i in range(tries):
        counts: dict = {}
        per = device_profile(lambda: [fn() for _ in range(iters)], counts=counts,
                             pad=PROFILE_PAD_S * 2 ** i)
        if counts and all(c % iters == 0 for c in counts.values()):
            return (sum(per.values()) / iters, sum(counts.values()) / iters,
                    sorted(per))
        recorded.append(counts)
    raise ProfilerDropped(f"the profiler dropped device events in {tries} "
                          f"windows of {iters} calls: {recorded}")


def bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def _tf32_off():
    """TF32 off for matmuls and cuDNN inside (an f32 yardstick is exact
    f32, as the FFMA routes are), restored after."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _errs(a, b) -> float:
    return float((a.float() - b.float()).abs().nan_to_num(0.0).max())


def _same(a, b, what) -> None:
    import torch

    if not torch.equal(a.cpu(), b.cpu()):
        raise AssertionError(f"{what}: integer outputs differ\n{a}\n{b}")


def _close_nonfinite(out, ref, tol, what) -> int:
    """Non-finite lanes exactly where the plain version's are, the finite
    ones within the tolerance, equal Inf where both are Inf; returns how
    many lanes are NaN in one and ±Inf in the other (an infinite V lane
    gives Inf where p > 0 and NaN where p rounds to 0, and p may be rounded
    against another running max than the plain version's)."""
    import torch

    out, ref = out.float(), ref.float()
    fin = ref.isfinite()
    _same(out.isfinite(), fin, f"finite lanes {what}")
    torch.testing.assert_close(out[fin], ref[fin], rtol=tol, atol=tol)
    both_inf = out.isinf() & ref.isinf()
    _same(out[both_inf], ref[both_inf], f"Inf lanes {what}")
    return int((out.isnan() != ref.isnan()).sum())


class PagedCheck:
    """The paged kernels against their plain versions on one pool shape:
    the block tables (request b holds 8, 5, 3 and 1 real pages, the rest
    null-padded, pages drawn from a seeded permutation), decode positions
    and prefill starts, planted pools and queries (``fresh``), and the
    decode and prefill checks, which keep the largest output error in
    ``max_err``."""

    def __init__(self, shape: PoolShape):
        import torch

        self.shape, sh = shape, shape
        self.dev = dev = torch.device("cuda")
        self.null = sh.P - 1
        gen = torch.Generator(device=dev).manual_seed(0)
        n_real = [8, 5, 3, 1][:sh.B]
        perm = torch.randperm(sh.P - 1, generator=gen, device=dev).tolist()
        self.bt_rows, cursor = [], 0
        for n in n_real:
            self.bt_rows.append(perm[cursor:cursor + n] + [self.null] * (sh.M - n))
            cursor += n
        self.bt = torch.tensor(self.bt_rows, dtype=torch.int32, device=dev)
        self.pos = torch.tensor([n * sh.PG - 3 for n in n_real],
                                dtype=torch.int32, device=dev)
        self.q_starts = {c: torch.tensor([max(0, n * sh.PG - c) for n in n_real],
                                         dtype=torch.int32, device=dev)
                         for c in (C, C_LONG)}
        self.cols = sh.PG * sh.KH * sh.DH     # one page of one layer: its nm tile
        # the page scrub's pages: two planted resident pages and the null page
        self.scrub_ids = [self.bt_rows[0][1], self.bt_rows[1][0], self.null]
        self.max_err = {"paged_decode": 0.0, "paged_prefill": 0.0,
                        "decode_own_partition": 0.0, "scrub": 0.0}

    def fresh(self, dtype, nm=False):
        """The pools, decode q and prefill chunks, planted (lanes and KV
        heads clamped to the pool's).  With ``nm``, the neighbor_mean
        operands: each page of the layer carries its own offset (the page
        is one logical tile), and request 3, whose lanes all sit in one
        page (page p3, offset NM_OFFSETS[0] > 0), gets lanes a wrong fill
        must move: V lane 5 of KV head 0 NaN in every slot (its output lane
        there is V's fill, whatever the weights), K of slot 1 of KV head 1
        NaN in every lane, and q of that head group biased against p3's
        sign (p3's keys score alike with the right fill; slot 1 takes the
        row over with a zero or negative one)."""
        import torch

        sh, dev, bt_rows, null = self.shape, self.dev, self.bt_rows, self.null
        g = torch.Generator(device=dev).manual_seed(1)
        kp = torch.randn((sh.P, sh.L, sh.PG, sh.KH, sh.DH), generator=g, device=dev)
        vp = torch.randn((sh.P, sh.L, sh.PG, sh.KH, sh.DH), generator=g, device=dev)
        if nm:
            for t in (kp, vp):
                t[:, LAYER] += _tile_offsets(sh.P, self.cols, (1, self.cols), dev,
                                             first=bt_rows[3][0]).view(
                    sh.P, sh.PG, sh.KH, sh.DH)
        kp, vp = kp.to(dtype), vp.to(dtype)

        def at(page, slot, head, lane):
            return (page, LAYER, slot, min(head, sh.KH - 1), min(lane, sh.DH - 1))

        plant = [
            (kp, at(bt_rows[0][1], 3, 0, 10), float("nan")),
            (kp, at(bt_rows[1][0], 0, 1, 100), float("inf")),
            (vp, at(bt_rows[2][2], 7, 1, 5), float("-inf")),
            (vp, at(null, 0, 0, 0), float("nan")),
            (kp, at(null, 2, 1, 9), 3.0e4),           # range guard
            (vp, at(bt_rows[0][3], 5, 0, 1), -5.0e3),  # range guard
            (kp, at(bt_rows[3][0], 1, 0, 2), 3.0),     # bit pattern
            (vp, at(bt_rows[0][1], 4, 1, 7), 3.0),     # bit pattern
            # the last page of request 0: dead for its first prefill row
            # blocks, live for the last
            (kp, at(bt_rows[0][7], 0, 1, 11), float("nan")),
            (vp, at(bt_rows[0][7], 1, 0, 12), float("nan")),
        ]
        for t, idx, val in plant:
            t[idx] = val
        q = torch.randn((sh.B, sh.H, sh.DH), generator=g, device=dev)
        qcs = {c: torch.randn((sh.B, c, sh.H, sh.DH), generator=g, device=dev)
               for c in (C, C_LONG)}
        if nm:
            G = sh.H // sh.KH
            p3 = bt_rows[3][0]
            vp[p3, LAYER, :, 0, 5] = float("nan")
            kp[p3, LAYER, 1, 1, :] = float("nan")
            q[3, G:2 * G] -= 1.0
            for qc in qcs.values():
                qc[3, :, G:2 * G] -= 1.0
        return (kp, vp, q.to(dtype),
                {c: qc.to(dtype) for c, qc in qcs.items()})

    def prefill_cases(self, dtype, qcs, q_off=True):
        """``(label, chunk, q_start, route)`` at C and C_LONG, and (with
        ``q_off``) for a 16-bit pool q 2 bytes off alignment at C: 16-bit
        pools take the wgmma route, f32 and the offset view the FFMA one."""
        import torch

        want = "ffma" if dtype == torch.float32 else "wgmma"
        cases = [(f"C={c}", qc, self.q_starts[c], want) for c, qc in qcs.items()]
        if q_off and dtype != torch.float32:
            cases.append((f"C={C} q-off", _at_offset(qcs[C], 1), self.q_starts[C],
                          "ffma"))
        return cases

    def decode_cases(self, q, route="fused", q_off=True):
        """``(label, q, splits, route)`` at splits 1 and 4 on ``route``, and
        (with ``q_off``) q 2 bytes off alignment (4 for f32) at splits 4 on
        the walk route."""
        cases = [("s=1", q, 1, route), ("s=4", q, 4, route)]
        if q_off:
            cases.append(("s=4 q-off", _at_offset(q, 1), 4, "walk"))
        return cases

    def check_prefill(self, dtype, label, kw, kp, vp, qcs, q_off=True):
        """Prefill against its plain version at C and C_LONG, and (with
        ``q_off``) for 16-bit pools with q 2 bytes off alignment at C:
        integer outputs equal, outputs within the tolerance (NaN where the
        plain version's are), on the expected route (16-bit pools wgmma, f32
        and the offset view FFMA).  Returns the ``kernels ok`` parts."""
        import torch

        from repro_torch.kernels import paged_attention as pa

        name = str(dtype).split(".")[-1]
        parts = []
        for what, qc, qs, want_r in self.prefill_cases(dtype, qcs, q_off):
            prefill_route = pa.route(qc, kp, vp)
            if prefill_route != want_r:
                raise AssertionError(f"prefill {name} {what} took the "
                                     f"{prefill_route} route")
            got = pa.paged_prefill_raw(qc, kp, vp, self.bt, qs, LAYER, **kw)
            want = pa.paged_prefill_plain(qc, kp, vp, self.bt, qs, LAYER, **kw)
            _same(got[1], want[1], f"prefill slot_counts {name} {label} {what}")
            _same(got[2], want[2], f"prefill counts {name} {label} {what}")
            # finite outputs unless V lanes were left non-finite
            fin = want[0].float().isfinite()
            if bool(fin.all()) == (label == "v-off"):
                raise AssertionError(f"prefill {name} {label} {what}: "
                                     f"finite outputs not as expected")
            # the wgmma route rounds p per tile, not per page
            nan_inf = _close_nonfinite(got[0], want[0], TOL[name],
                                       f"prefill {name} {label} {what}")
            self.max_err["paged_prefill"] = max(self.max_err["paged_prefill"],
                                                _errs(got[0], want[0]))
            part = f"{what} ({prefill_route}) {got[2].tolist()}"
            if label == "v-off":
                part += f" non-finite {int((~fin).sum())}, NaN vs Inf {nan_inf}"
            parts.append(part)
        return parts

    def check_decode(self, dtype, label, kw, kp, vp, q, route="fused",
                     q_off=True):
        """Decode against its plain version at splits 1 and 4 on ``route``,
        and (with ``q_off``) with q 2 bytes off alignment (4 for f32) at
        splits 4 on the walk route: integer outputs equal, outputs within
        the tolerance (non-finite lanes where the plain version's are).
        Returns the ``kernels ok`` parts and the last call's counts."""
        from repro_torch.kernels import paged_attention as pa

        name = str(dtype).split(".")[-1]
        bt, pos = self.bt, self.pos
        parts = []
        for what, qd, splits, want_r in self.decode_cases(q, route, q_off):
            decode_route = pa.decode_route(qd, kp, vp)
            if decode_route != want_r:
                raise AssertionError(f"decode {name} {what} took the "
                                     f"{decode_route} route")
            got = pa.paged_attention_splitk_raw(qd, kp, vp, bt, pos, LAYER,
                                                splits=splits, **kw)
            want = pa.paged_decode_plain(qd, kp, vp, bt, pos, LAYER,
                                         splits=splits, **kw)
            _same(got[1], want[1], f"decode slot_counts {name} {label} {what}")
            _same(got[2], want[2], f"decode counts {name} {label} {what}")
            if int(got[2][6]) == 0:
                raise AssertionError("decode saw none of the planted lanes")
            fin = want[0].float().isfinite()
            if bool(fin.all()) == (label == "v-off"):
                raise AssertionError(f"decode {name} {label} {what}: finite "
                                     f"outputs not as expected")
            nan_inf = _close_nonfinite(got[0], want[0], TOL[name],
                                       f"decode {name} {label} {what}")
            self.max_err["paged_decode"] = max(self.max_err["paged_decode"],
                                               _errs(got[0], want[0]))
            if decode_route != "walk":
                # the plain twin of the kernel's own partition rounds p
                # against the same running maxima
                twin = {"fused": pa.paged_decode_fused_plain,
                        "heads": pa.paged_decode_heads_plain}[decode_route](
                    qd, kp, vp, bt, pos, LAYER, **kw)
                _same(got[1], twin[1], f"decode twin slot_counts {name} {label}")
                _close_nonfinite(got[0], twin[0], TOL[name],
                                 f"decode twin {name} {label} {what}")
                self.max_err["decode_own_partition"] = max(
                    self.max_err["decode_own_partition"], _errs(got[0], twin[0]))
            part = f"{what} ({decode_route})"
            if label == "v-off":
                part += f" non-finite {int((~fin).sum())}, NaN vs Inf {nan_inf}"
            parts.append(part)
        return parts, got[2].tolist()

    def check_scrub(self, dtype, label, kw, kp):
        """The engine's page scrub of ``scrub_ids`` bucketed to 4 (a padding
        duplicate, n_valid 3) on a copy of the K pool against
        ``scrub_pages_plain`` on another, under ``kw``'s K detector (the
        default one for "default"): counts and bits equal, a planted lane
        found.  Returns the counts."""
        from repro_torch.core import detect
        from repro_torch.kernels import scrub as sk

        name = str(dtype).split(".")[-1]
        det = kw["detector_k"] if label != "default" else None
        skw = dict(policy="zero", detector=det, n_valid=3)
        ids = self.scrub_ids + [self.scrub_ids[0]]
        a, b = kp.clone(), kp.clone()
        _, c_kernel = sk.scrub_pages(a, ids, **skw)
        _, c_plain = sk.scrub_pages_plain(b, ids, **skw)
        _same(c_kernel, c_plain, f"scrub_pages counts {name} {label}")
        _same(detect.bits_of(a), detect.bits_of(b), f"scrub_pages bits {name}")
        self.max_err["scrub"] = max(self.max_err["scrub"], _errs(a, b))
        if int(c_kernel[0] + c_kernel[1]) == 0:
            raise AssertionError("scrub saw none of the planted lanes")
        return c_kernel.tolist()

    def decode_bound(self, dtype_name: str, es: int):
        """(ms, "bytes" or "operations") of a decode call: q and out, every
        visited page's K and V tile at the layer, the tables and counts
        once; QK and PV over each request's valid keys."""
        sh = self.shape
        visited = len({p for row in self.bt_rows for p in row})
        valid_keys = sum(min(int(p) + 1, sh.M * sh.PG) for p in self.pos.tolist())
        page = sh.PG * sh.KH * sh.DH * es
        nbytes = (2 * sh.B * sh.H * sh.DH * es + 2 * visited * page
                  + sh.B * sh.M * 4 * 2 + sh.B * 4 + 32)
        return bound(nbytes, 4.0 * sh.H * sh.DH * valid_keys, dtype_name)

    def prefill_bound(self, c: int, q_start: int, dtype_name: str, es: int):
        """(ms, "bytes" or "operations") of a one-request prefill call of
        ``c`` rows from ``q_start``: the chunk and its output, the
        request's M pages' K and V tiles, once; QK and PV over each row's
        causal keys."""
        sh = self.shape
        p_valid = sum(min(q_start + r + 1, sh.M * sh.PG) for r in range(c)) * sh.H
        nbytes = (2 * c * sh.H * sh.DH * es + 2 * sh.M * sh.PG * sh.KH * sh.DH * es
                  + sh.M * 4 * 2 + 4 + 32)
        return bound(nbytes, 4.0 * sh.DH * p_valid, dtype_name)

    def gathered_kv(self, kp, vp):
        """SDPA's yardstick operands: the layer's pages gathered into a
        head-expanded contiguous view, non-finite lanes zeroed (the
        repaired view)."""
        sh = self.shape
        t_keys = sh.M * sh.PG

        def gather(x):
            x = x[self.bt.long(), LAYER].reshape(sh.B, t_keys, sh.KH, sh.DH)
            x = x.repeat_interleave(sh.H // sh.KH, dim=2).transpose(1, 2)
            return x.contiguous().nan_to_num(0.0)

        return gather(kp), gather(vp)


# ---------------------------------------------------------------- phase 2
def kernel_phase(report: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.core import detect
    from repro_torch.kernels import common, tile_fill
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import scrub as sk

    pc = PagedCheck(QWEN2_POOL)
    dev = pc.dev
    report["nm_launches"] = collections.Counter()
    report["nm_err"] = nm_err = dict(tile_fill=0.0, paged=0.0, scrub=0.0,
                                     repair_matmul=0.0, flash_attention=0.0,
                                     mlstm_chunk=0.0)
    bt_rows, bt, pos, q_starts = pc.bt_rows, pc.bt, pc.pos, pc.q_starts
    cols = pc.cols
    layer_view = dict(row_stride=L * cols, offset=LAYER * cols)
    max_err = pc.max_err

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
            kp, vp, q, qcs = pc.fresh(dtype)
            decode_parts, decode_counts = pc.check_decode(dtype, label, kw, kp, vp, q)
            routes = pc.check_prefill(dtype, label, kw, kp, vp, qcs)
            scrub_counts = pc.check_scrub(dtype, label, kw, kp)
            log(f"kernels ok  dtype={name} detector={label} decode "
                f"{'; '.join(decode_parts)} {decode_counts} prefill "
                f"{'; '.join(routes)} scrub_counts={scrub_counts}")
        # V detection off: the planted V lanes stay non-finite and reach
        # every row of their KV head through 0 x NaN, rows that mask them
        # too (request 0's last page, dead for its early row blocks, among
        # them); every route must put them where the plain version does
        kp, vp, q, qcs = pc.fresh(dtype)
        decode_parts, _ = pc.check_decode(dtype, "v-off", dict(detector_v=None),
                                       kp, vp, q)
        routes = pc.check_prefill(dtype, "v-off", dict(detector_v=None), kp, vp, qcs)
        log(f"kernels ok  dtype={name} detector=v-off decode "
            f"{'; '.join(decode_parts)} prefill {'; '.join(routes)}")
        a, b = vp.clone(), vp.clone()
        _same(sk.scrub(a)[1], sk.scrub_plain(b)[1], f"scrub counts {name}")
        _same(detect.bits_of(a), detect.bits_of(b), f"scrub bits {name}")

    # ---- neighbor_mean on the engine pool's paged calls: each page's mean
    # over both KV heads from tile_fill's per-page table, on every decode
    # and prefill route, and the page scrub's gathered tiles; kernel calls
    # counted apart, plain versions, tables and controls compared outside
    # the count
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        kp, vp, q, qcs = pc.fresh(dtype, nm=True)
        table_err = 0.0
        for pool in (kp, vp):
            for d in (None, _det2(dtype)):
                consts = common.detector_operand(common.resolve_detector(d, True),
                                                 dtype)
                got_t = tile_fill.tile_fill(pool, P, cols, (1, cols), consts,
                                            **layer_view)
                want_t = tile_fill.tile_fill_plain(pool, P, cols, (1, cols),
                                                   consts, **layer_view)
                table_err = max(table_err, _errs(tile_fill.values(got_t, dtype),
                                                tile_fill.values(want_t, dtype)))
        nm_err["tile_fill"] = max(nm_err["tile_fill"], table_err)
        for label, kw, zero_kw, tabled in (
                ("both", dict(policy="neighbor_mean"), dict(policy="zero"),
                 dict(K=kp, V=vp)),
                ("k-only range+bitpattern",
                 dict(detector_k=_det2(dtype), detector_v=_det2(dtype),
                      policy_k="neighbor_mean", policy_v="zero"),
                 dict(policy_k="zero"), dict(K=kp))):
            decode_cases = pc.decode_cases(q)
            prefill_cases = pc.prefill_cases(dtype, qcs)

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
                _same(g[1], w[1], f"nm slot_counts {name} {label} {what}")
                _same(g[2], w[2], f"nm counts {name} {label} {what}")
                _close_nonfinite(g[0], w[0], TOL[name], f"nm {name} {label} {what}")
                out_err = max(out_err, _errs(g[0], w[0]))
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
        ids = pc.scrub_ids
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
        _same(c_kernel, c_plain, f"nm scrub_pages counts {name}")
        _same(detect.bits_of(a)[~fatal], detect.bits_of(b)[~fatal],
             f"nm scrub_pages untouched lanes {name}")
        lane_err = _errs(a[fatal], b[fatal])
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
    kp, vp, q, qcs = pc.fresh(dtype)
    kw = dict(detector_k="default", detector_v="default", policy="zero")
    page_bytes = PG * KH * DH * es
    t_keys = M * PG
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library_times(fn):
        """(call ms, device ms) of one PyTorch call."""
        return cuda_ms(fn), library_device_ms(fn)

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
    dnames, wnames = DECODE_KERNELS["fused"], DECODE_KERNELS["walk"]
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
    d_bound, d_by = pc.decode_bound(name, es)
    # yardstick: SDPA over a gathered, head-expanded contiguous view
    kg, vg = pc.gathered_kv(kp, vp)
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
    pnames = PREFILL_KERNELS
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
        p_bound, p_by = pc.prefill_bound(c, qs0, name, es)
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
                device_ms=kernel_device_ms(ffma_call, PREFILL_ROUTE_KERNELS["ffma"]))

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
                f"{sum(pt.values()):.4f} ms = scan {pt['page_scan']:.4f} + "
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
    max_err = {"repair_matmul": 0.0, "flash_attention": 0.0,
               "repair_mm_f32": 0.0, "flash_repair_f32": 0.0}
    f32_row = {"repair_matmul": "repair_mm_f32", "flash_attention": "flash_repair_f32"}

    def note_err(kernel, route, err):
        max_err[kernel] = max(max_err[kernel], err)
        if route == "f32":
            max_err[f32_row[kernel]] = max(max_err[f32_row[kernel]], err)
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
            note_err("repair_matmul", rm.route(a, b), err)
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
        note_err("flash_attention", ra.route(q, k, v), err)
        if int(got[1][ra.EV_TOTAL]) == 0:
            raise AssertionError(f"{what}: saw none of the planted lanes")
        if ra.route(q, k, v) == "f32":    # and the twin of its key partition
            twin = ra.flash_attention_f32_plain(q, k, v, **kw)
            compare(f"{what} vs the f32 partition's twin", got, twin,
                    (TOL[name], TOL[name]))
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
            note_err("repair_matmul", rm.route(a, b), err)
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
                note_err("flash_attention", ra.route(q, k, v), err)
                if int(got[1][ra.EV_TOTAL]) == 0:
                    raise AssertionError(f"{what}: saw none of the planted lanes")
                _check_memory_mode(ops.flash_attention, (q, k, v), kw,
                                   (ra.EV_K, ra.EV_V), what)
                log(f"ops ok  {what}: counts={got[1].tolist()} "
                    f"max_abs_err={err:.3g} tol={TOL[name]}")
    del a, b, q, k, v, got, want

    # ---- neighbor_mean: the gate/up product and the 2,048-token attention
    # in bf16 on the wgmma route, the quickstart's f32 shapes on the f32
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
    route_launches = dict(common.ROUTE_LAUNCHES)
    for k_name in ("repair_matmul", "flash_attention", "scrub"):
        if launches.get(k_name, 0) < 1:
            raise AssertionError(f"kernel {k_name} never launched by the quickstart")
    for key in (("repair_matmul", "f32"), ("flash_attention", "f32")):
        if route_launches.get(key, 0) != launches[key[0]]:
            raise AssertionError(f"the quickstart's f32 calls left the f32 "
                                 f"route: {route_launches}")
    log(f"quickstart ok: register {qs['register']}, memory {qs['memory']}, "
        f"attention register {qs['attention_register']}, memory "
        f"{qs['attention_memory']}, stats {qs['stats']}, launches {launches} "
        f"(by route {route_launches}), "
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
    lib_dev = library_device_ms(lambda: torch.matmul(ca, cb), iters=10)
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
    # the f32 product (the f32 route, which the quickstart takes), planted
    # and clean, beside the FFMA route on the same values 4 bytes off
    # alignment and torch.matmul in f32 with TF32 off (exact f32, as both)
    ca, cb = clean_a, clean_b
    a, b = _plant_lanes(ca.clone(), gen, f32), _plant_lanes(cb.clone(), gen, f32)
    if rm.route(a, b) != "f32" or rm.route(ca, cb) != "f32":
        raise AssertionError("gate/up f32 is not on the f32 route")
    mm32_bound, mm32_by = bound(4 * (M * K + K * N + M * N) + 32, flops, "float32")
    flagged = [int(x.sum()) for x in rm.scan_plain(a, b, tile=rm.F32_TILE)[2:]]
    mm32_tiles = [r * c for r, c in rm._flag_shapes(M, N, K, rm.F32_TILE)]
    fa, fb = ops.scrub(a.clone())[0], ops.scrub(b.clone())[0]
    mm32 = dict(ms=cuda_ms(lambda: rm.repair_matmul_raw(a, b), iters=5),
                plain_ms=cuda_ms(lambda: rm.repair_matmul_plain(a, b), iters=3),
                bound_ms=mm32_bound, bound_by=mm32_by)
    mm32_parts = {}
    for label, x, y in (("planted", a, b), ("clean", ca, cb)):
        pr = kernel_breakdown(lambda x=x, y=y: rm.repair_matmul_raw(x, y), names,
                              iters=3)
        if not pr["repair_mm_f32"] > 0:
            raise AssertionError(f"gate/up f32 ran no repair_mm_f32: {pr}")
        mm32_parts[label] = pr
        dev_ms = sum(pr.values())
        call = mm32["ms"] if label == "planted" else cuda_ms(
            lambda: rm.repair_matmul_raw(ca, cb), iters=5)
        log(f"timing repair_matmul gate/up f32 {label} (f32 route): device "
            f"{dev_ms:.4f} ms = scan {pr['repair_mm_scan']:.4f} + repair_mm_f32 "
            f"{pr['repair_mm_f32']:.4f} + counts {pr['repair_mm_counts']:.4f}; "
            f"{flops / dev_ms / 1e9:.1f} TFLOP/s, {mm32_bound / dev_ms:.3f} of the "
            f"FP32 bound {mm32_bound:.4f} ms; main loop "
            f"{flops / pr['repair_mm_f32'] / 1e9:.1f} TFLOP/s; call {call:.4f} ms"
            + (f"; flagged tiles A {flagged[0]} of {mm32_tiles[0]}, B "
               f"{flagged[1]} of {mm32_tiles[1]}" if label == "planted" else ""))
    mm32["device_ms"] = sum(mm32_parts["planted"].values())
    mm32["clean_device_ms"] = sum(mm32_parts["clean"].values())
    a_off, b_off = _at_offset(a, 1), _at_offset(b, 1)
    if rm.route(a_off, b_off) != "ffma":
        raise AssertionError("gate/up f32 4 bytes off is not on the FFMA route")
    ffma_parts = kernel_breakdown(lambda: rm.repair_matmul_raw(a_off, b_off),
                                  names, iters=3)
    del a_off, b_off
    with _tf32_off():
        mm32["library_ms"] = cuda_ms(lambda: torch.matmul(fa, fb), iters=5)
        mm_lib_dev = library_device_ms(lambda: torch.matmul(fa, fb), iters=3)
    log(f"timing repair_matmul gate/up f32 planted (ffma route, 4 bytes off "
        f"alignment): device {sum(ffma_parts.values()):.4f} ms "
        f"({ffma_parts['repair_mm_tiles']:.4f} in repair_mm_tiles), "
        f"{flops / sum(ffma_parts.values()) / 1e9:.1f} TFLOP/s; torch.matmul "
        f"f32, TF32 off: device {mm_lib_dev} ms, call {mm32['library_ms']:.4f} "
        f"ms; plain {mm32['plain_ms']:.4f} ms ({gpu_line()})")
    del a, b, fa, fb, ca, cb, clean_a, clean_b
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
    lib_dev = library_device_ms(library, iters=10)
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
    # the f32 call (the f32 route, which the quickstart takes), planted and
    # clean, beside the FFMA route on the same values 4 bytes off alignment
    # and SDPA in f32 with TF32 off: on its math path with enable_gqa, and
    # on its memory-efficient kernel over K/V expanded to H heads outside
    # the timed region
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v = qkv(f32)
    fk, fv = ops.scrub(k.clone())[0], ops.scrub(v.clone())[0]
    if ra.route(q, k, v) != "f32" or ra.route(q, fk, fv) != "f32":
        raise AssertionError("flash_attention f32 is not on the f32 route")
    at32_bound, at32_by = bound(4 * (2 * AT_B * AT_H * AT_S * AT_D)
                                + 2 * kv_bytes + 32, flops, "float32")
    flags32 = ra.scan_plain(k, v, S=AT_S, causal=True, tile=ra.F32_TILE)[1]
    at32 = dict(ms=cuda_ms(lambda: ra.flash_attention_raw(q, k, v), iters=10),
                plain_ms=cuda_ms(lambda: ra.flash_attention_plain(q, k, v), iters=5),
                bound_ms=at32_bound, bound_by=at32_by)
    at32_parts = {}
    for label, kk, vv in (("planted", k, v), ("clean", fk, fv)):
        pr = kernel_breakdown(lambda kk=kk, vv=vv: ra.flash_attention_raw(q, kk, vv),
                              names, iters=5)
        if not pr["flash_repair_f32"] > 0:
            raise AssertionError(f"flash_attention f32 ran no flash_repair_f32: {pr}")
        at32_parts[label] = pr
        dev_ms = sum(pr.values())
        call = at32["ms"] if label == "planted" else cuda_ms(
            lambda: ra.flash_attention_raw(q, fk, fv), iters=10)
        log(f"timing flash_attention causal f32 {label} (f32 route): device "
            f"{dev_ms:.4f} ms = scan {pr['flash_scan']:.4f} + flash_repair_f32 "
            f"{pr['flash_repair_f32']:.4f} + counts {pr['flash_counts']:.4f}; "
            f"{flops / dev_ms / 1e9:.1f} TFLOP/s, {at32_bound / dev_ms:.3f} of the "
            f"FP32 bound {at32_bound:.4f} ms; main loop "
            f"{flops / pr['flash_repair_f32'] / 1e9:.1f} TFLOP/s; call {call:.4f} ms"
            + (f"; flagged K/V tiles {int(flags32[..., 0].sum())} / "
               f"{int(flags32[..., 1].sum())} of {flags32[..., 0].numel()}"
               if label == "planted" else ""))
    at32["device_ms"] = sum(at32_parts["planted"].values())
    at32["clean_device_ms"] = sum(at32_parts["clean"].values())
    qo, ko, vo = (_at_offset(x, 1) for x in (q, k, v))
    if ra.route(qo, ko, vo) != "ffma":
        raise AssertionError("flash_attention f32 4 bytes off is not on the FFMA route")
    ffma_parts = kernel_breakdown(lambda: ra.flash_attention_raw(qo, ko, vo),
                                  names, iters=3)
    del qo, ko, vo
    G = AT_H // AT_KH
    kx, vx = (x.repeat_interleave(G, dim=1) for x in (fk, fv))

    def library32():
        return sdpa(q, fk, fv, is_causal=True, enable_gqa=True)

    def efficient32():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return sdpa(q, kx, vx, is_causal=True)

    at_kernels: list = []
    eff_kernels: list = []
    with _tf32_off():
        at_lib_ms = cuda_ms(library32, iters=5)
        at_lib_dev = library_device_ms(library32, iters=3, kernels=at_kernels)
        at32["library_ms"] = cuda_ms(efficient32, iters=10)
        eff_dev = library_device_ms(efficient32, iters=5, kernels=eff_kernels)
        eff_err = float((efficient32().float()
                         - ra.flash_attention_plain(q, fk, fv)[0]).abs().max())
    log(f"timing flash_attention causal f32 planted (ffma route, 4 bytes off "
        f"alignment): device {sum(ffma_parts.values()):.4f} ms "
        f"({ffma_parts['flash_repair_fwd']:.4f} in flash_repair_fwd, "
        f"{ffma_parts['flash_count_tiles']:.4f} in flash_count_tiles), "
        f"{flops / sum(ffma_parts.values()) / 1e9:.1f} TFLOP/s; SDPA f32, TF32 "
        f"off, enable_gqa: device {at_lib_dev} ms, call {at_lib_ms:.4f} ms, "
        f"{sdpa_backend(at_kernels)}; SDPA f32 memory-efficient (K/V expanded "
        f"to {AT_H} heads): device {eff_dev} ms, call {at32['library_ms']:.4f} "
        f"ms, {sdpa_backend(eff_kernels)}, max |diff| to the plain version "
        f"{eff_err:.3g}; plain {at32['plain_ms']:.4f} ms ({gpu_line()})")
    del q, k, v, fk, fv, kx, vx
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
        # the f32 routes' main kernels (with their scan and counts), at
        # gate/up and causal S = T = 2048 in f32; library: torch.matmul f32
        # and SDPA's memory-efficient f32 kernel, TF32 off
        "repair_mm_f32": dict(
            route="cuda", source="src/repro_torch/csrc/repair_matmul.cu",
            replaces="src/repro/kernels/repair_matmul.py:60 (_mm_kernel, f32)",
            max_abs_err=max_err["repair_mm_f32"], **mm32),
        "flash_repair_f32": dict(
            route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/repair_attention.py:44 (_flash_kernel, f32)",
            max_abs_err=max_err["flash_repair_f32"], **at32),
    }
    wrapper = {"repair_mm_f32": ("repair_matmul", "f32"),
               "flash_repair_f32": ("flash_attention", "f32")}
    for name, row in rows.items():
        row["launches"] = int(route_launches.get(wrapper[name], 0)
                              if name in wrapper else launches.get(name, 0))
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
        f"causal bf16 (repair_mm_f32 and flash_repair_f32: the same shapes in "
        f"f32); library = torch.matmul / SDPA (enable_gqa; the f32 rows: SDPA's "
        f"memory-efficient kernel) on the repaired operands")


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
    positions below each request's next write slot (page 0, offset 1);
    KV heads and lanes clamped to the pool's."""
    running = [r for r in engine.sched.running
               if r.prefill_pos is None and r.n_context > PG + 1]
    if len(running) < 2:
        raise AssertionError("fewer than two decoding requests to plant in")
    a, b = running[0], running[1]
    tree = engine.pool.tree
    _, n_layers, _, kh, dh = tree["layers/k"].shape
    top = n_layers - 1                            # the pool's last layer
    tree["layers/k"][a.pages[0], min(3, top), 1, 0, 7] = float("nan")
    tree["layers/k"][a.pages[0], min(9, top), 1, min(1, kh - 1),
                     min(70, dh - 1)] = float("nan")
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


def device_groups(per: dict):
    """Device ms of a profile (``device_profile``'s ``{kernel: ms}``) by
    group — the repair kernels, GEMMs, copies and memsets, the rest
    (elementwise) — and the repair kernels' ms by wrapper."""
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
    return groups, by_kernel


# the window of the engine's host and device tables (chiprun_out/
# engine_profile.txt): the first requests of the workload, few new tokens
ENGINE_TABLE_REQUESTS, ENGINE_TABLE_NEW = 2, 4


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
    t0 = time.perf_counter()
    per = device_profile(lambda: drive(
        Engine(model, serving_config(), device="cuda"), prompts))
    profile_s = time.perf_counter() - t0
    # the host and device tables over a short window (ENGINE_TABLE_*): the
    # host trace of the whole run took ~60 s to summarise
    t0 = time.perf_counter()
    device_profile(lambda: drive(
        Engine(model, serving_config(), device="cuda"),
        prompts[:ENGINE_TABLE_REQUESTS], plant_after=None, max_new=ENGINE_TABLE_NEW),
        table="engine_profile.txt")
    table_s = time.perf_counter() - t0
    groups, by_kernel = device_groups(per)
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
        split_k=m["split_k"], stage_wall_s=wm["stage_wall_s"], profile_s=profile_s,
        table_s=table_s,
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


# the fallback arms' depth: Qwen2-1.5B width cut to this many layers (the
# arms are host-bound, their time grows with depth)
FALLBACK_LAYERS = 4


def fallback_phase(report: dict) -> None:
    """The gathered-view fallback, the no-repair arm, the desynchronized
    drain, register mode and generate, at full width on the card, on a
    model of their own cut to FALLBACK_LAYERS layers."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.launch import serve
    from repro_torch.models import TransformerLM
    from repro_torch.runtime import ApproxConfig, ApproxSpace, ScrubSchedule
    from repro_torch.serving import Engine

    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=FALLBACK_LAYERS)
    model = TransformerLM(cfg, device="cuda", seed=0)
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
                          ("layers/v", (FALLBACK_LAYERS - 1, 2, 30, 1, 77),
                           float("inf"))], deltas)
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
    stats, kernel counts and host syncs must be equal.  The register arm
    (a NaN weight lane, use-site repair, the gathered path) is held on the
    card against the same model in the default mode with that lane 0 on
    the gathered path (``paged_decode="off"``): its CPU side took two
    minutes of the phase, register mode runs no kernel, and the CPU tests
    hold it against the reference."""
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

    def twin(lane, **repair):
        tcfg = dataclasses.replace(cfg, repair=ApproxConfig(**repair)) if repair else cfg
        m = TransformerLM(tcfg, device="cuda", seed=0)
        m.load_state_dict(gpu.state_dict())
        m.layers[1].mlp.w_up[5, 300] = lane
        return m

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
        "register": dict(drive=short, sides=lambda: (
            (twin(float("nan"), mode="register", policy="zero"), base),
            (twin(0.0), dataclasses.replace(base, paged_decode="off")))),
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
        sides = (arm["sides"]() if "sides" in arm
                 else ((gpu, arm["cfg"]), (cpu, arm["cfg"])))
        for model, acfg in sides:
            space = ApproxSpace(**arm["space"]) if "space" in arm else None
            eng = Engine(model, acfg, space=space, device=model.device)
            res = drive(eng, prompts, **arm.get("drive", {}))
            m = eng.metrics()
            outs.append(dict(
                tokens=[r["tokens"] for r in res],
                page_events=eng.pool.page_events.tolist(),
                stats=eng.stats_dict(), kernel_counts=eng.kernel_counts.tolist(),
                n_host_syncs=m["n_host_syncs"], gathers=m["pool_gathers"],
            ))
        against = ("the lane 0 in the default mode, gathered, on the card"
                   if "sides" in arm else "the CPU")
        for key in outs[0]:
            if outs[0][key] != outs[1][key]:
                raise AssertionError(f"parity arm {name}: {key} differs from "
                                     f"{against}")
        log(f"parity ok arm={name} against {against}: 2-layer f32, stats {outs[0]['stats']}, "
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


# ------------------------------------------------------------ phase 5a
# the dense variants served at full width: (arch, the pool its kernels are
# checked at, the decode route of that pool in bf16 and in f32; the prefill
# takes the wgmma route in bf16 and the FFMA one in f32).  The engine runs
# each model's paged lanes in bf16 at full width and in f32 at 2 layers
DENSE_VARIANTS = (("stablelm-1.6b", STABLELM_POOL, "fused", "heads"),
                  ("starcoder2-15b", STARCODER2_POOL, "fused", "fused"))
# the leaves the init leaves at 0 or 1 (biases, norm scales), drawn nonzero
# before the card-vs-CPU parity so a dropped one shows
DRAWN_LEAVES = ("/bias", "/scale", "/b_up", "/b_down", "/bq", "/bk", "/bv")


# calls a profiler window of the dense variants' kernel timings
DENSE_ITERS = 10


def _dense_pool_kernels(arch: str, shape: PoolShape, dtype_name: str,
                        decode_route: str, timed: bool = True) -> dict:
    """The paged kernels and the page scrub at one dense variant's pool in
    ``dtype_name`` against their plain versions under two detectors
    (decode at splits 1 and 4 on ``decode_route`` and a q off alignment at
    splits 4 on the walk route; prefill at C and C_LONG, wgmma in bf16 and
    FFMA in f32, and a bf16 q off alignment at C on FFMA; the scrub of
    three pages bucketed to four), then (with ``timed``) each paged call's
    device ms (split by kernel, windows of DENSE_ITERS calls) on the planted
    pool, and call ms beside its bound and SDPA's on the gathered view (and
    the backend that served SDPA); on a clean copy too for the decode at
    splits 4 and the prefill at C (the calls at splits 1 and C_LONG run the
    same kernels); at splits 4 on the fused and heads routes, the walk
    route's times on the same operands (q off alignment) beside them.
    Returns the timing rows (none without ``timed``)."""
    import torch

    from repro_torch.kernels import paged_attention as pa

    t0 = time.perf_counter()
    pc = PagedCheck(shape)
    dtype, name = getattr(torch, dtype_name), dtype_name
    es = torch.tensor([], dtype=dtype).element_size()
    for label, kw in (
            ("default", dict(detector_k="default", detector_v="default",
                             policy="zero")),
            ("range+bitpattern", dict(detector_k=_det2(dtype), detector_v=_det2(dtype),
                                      policy_k="zero", policy_v="constant",
                                      constant_v=0.5))):
        kp, vp, q, qcs = pc.fresh(dtype)
        d_parts, d_counts = pc.check_decode(dtype, label, kw, kp, vp, q,
                                            route=decode_route)
        p_parts = pc.check_prefill(dtype, label, kw, kp, vp, qcs)
        scrub_counts = pc.check_scrub(dtype, label, kw, kp)
        log(f"kernels ok  {arch} pool {dataclasses.astuple(shape)} dtype={name} "
            f"detector={label} decode {'; '.join(d_parts)} {d_counts} prefill "
            f"{'; '.join(p_parts)} scrub_counts={scrub_counts}")
    if not timed:
        log(f"dense kernels {arch} {name}: {time.perf_counter() - t0:.1f} s")
        return {}
    kp, vp, q, qcs = pc.fresh(dtype)
    kc, vc = (x.nan_to_num(0.0, 0.0, 0.0) for x in (kp, vp))
    q_off = _at_offset(q, 1)
    kw = dict(detector_k="default", detector_v="default", policy="zero")
    kg, vg = pc.gathered_kv(kp, vp)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    keys = torch.arange(shape.M * shape.PG, device=pc.dev)
    dmask = (keys[None, :] <= pc.pos[:, None].long())[:, None, None, :]

    def dsdpa():
        return sdpa(q[:, :, None, :], kg, vg, attn_mask=dmask)

    d_bound, d_by = pc.decode_bound(name, es)
    sdpa_kernels: list = []
    sdpa_ms = cuda_ms(dsdpa)
    sdpa_dev = library_device_ms(dsdpa, DENSE_ITERS, kernels=sdpa_kernels)
    log(f"{arch} {name}: SDPA ran {sdpa_backend(sdpa_kernels)} (decode, "
        f"gathered view, a boolean mask)")
    rows = {}
    for splits in (1, 4):
        def dcall(k=kp, v=vp, qd=q, splits=splits):
            return pa.paged_attention_splitk_raw(qd, k, v, pc.bt, pc.pos, LAYER,
                                                 splits=splits, **kw)

        names = DECODE_KERNELS[decode_route]
        row = dict(
            route=decode_route, names=names, main=ROUTE_MAIN[decode_route],
            parts=kernel_breakdown(dcall, names, DENSE_ITERS), ms=cuda_ms(dcall),
            bound_ms=d_bound, bound_by=d_by,
            plain_ms=cuda_ms(lambda splits=splits: pa.paged_decode_plain(
                q, kp, vp, pc.bt, pc.pos, LAYER, splits=splits, **kw)),
            sdpa_ms=sdpa_ms, sdpa_device_ms=sdpa_dev)
        if splits == 4:
            row["clean"] = kernel_breakdown(lambda: dcall(k=kc, v=vc), names,
                                            DENSE_ITERS)
            row["clean_ms"] = cuda_ms(lambda: dcall(k=kc, v=vc))
            if decode_route != "walk":
                row["walk"] = kernel_breakdown(lambda: dcall(qd=q_off),
                                               DECODE_KERNELS["walk"], DENSE_ITERS)
                row["walk_ms"] = cuda_ms(lambda: dcall(qd=q_off))
        rows[f"decode splits={splits}"] = row
    for c, qc in qcs.items():
        qc1, qs1 = qc[:1], pc.q_starts[c][:1]
        qs0 = int(qs1[0])
        cmask = keys[None, :] <= (qs0 + torch.arange(c, device=pc.dev))[:, None]

        def pcall(qc1=qc1, qs1=qs1, k=kp, v=vp):
            return pa.paged_prefill_raw(qc1, k, v, pc.bt[:1], qs1, LAYER, **kw)

        def psdpa(qc1=qc1, cmask=cmask):
            return sdpa(qc1.transpose(1, 2), kg[:1], vg[:1], attn_mask=cmask)

        p_bound, p_by = pc.prefill_bound(c, qs0, name, es)
        p_route = pa.route(qc1, kp, vp)
        sdpa_kernels = []
        psdpa_dev = library_device_ms(psdpa, DENSE_ITERS, kernels=sdpa_kernels)
        log(f"{arch} {name}: SDPA ran {sdpa_backend(sdpa_kernels)} (prefill "
            f"C={c}, gathered view, a boolean mask)")
        names = PREFILL_ROUTE_KERNELS[p_route]
        row = rows[f"prefill C={c}"] = dict(
            route=p_route, names=names, main=ROUTE_MAIN[p_route],
            parts=kernel_breakdown(pcall, names, DENSE_ITERS), ms=cuda_ms(pcall),
            bound_ms=p_bound, bound_by=p_by,
            plain_ms=cuda_ms(lambda qc1=qc1, qs1=qs1: pa.paged_prefill_plain(
                qc1, kp, vp, pc.bt[:1], qs1, LAYER, **kw)),
            sdpa_ms=cuda_ms(psdpa), sdpa_device_ms=psdpa_dev)
        if c == C:
            row["clean"] = kernel_breakdown(lambda: pcall(k=kc, v=vc), names,
                                            DENSE_ITERS)
            row["clean_ms"] = cuda_ms(lambda: pcall(k=kc, v=vc))
    for what, r in rows.items():
        if not (r["parts"][r["main"]] > 0
                and r.get("clean", {r["main"]: 1.0})[r["main"]] > 0):
            raise AssertionError(f"{arch} {what}: {r['main']} did not run: "
                                 f"{r['parts']} {r.get('clean')}")
        r["device_ms"] = sum(r["parts"].values())
        readings = [("planted", r["parts"], r["ms"])]
        if "clean" in r:
            r["clean_device_ms"] = sum(r["clean"].values())
            readings.append(("clean", r["clean"], r["clean_ms"]))
        for label, pt, ms in readings:
            split = " + ".join(f"{k} {v:.4f}" for k, v in pt.items())
            log(f"timing {arch} paged {what} {name} {label} ({r['route']} route): "
                f"device {sum(pt.values()):.4f} ms = {split}; call {ms:.4f} ms; "
                f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}); SDPA device "
                f"{r['sdpa_device_ms']} ms, call {r['sdpa_ms']:.4f} ms; plain "
                f"{r['plain_ms']:.4f} ms ({gpu_line()})")
        if "walk" in r:
            wk = r["walk"]
            log(f"timing {arch} paged {what} {name} planted (walk route, q "
                f"{es} bytes off alignment): device {sum(wk.values()):.4f} ms = "
                f"decode_partials {wk['decode_partials']:.4f} + lse_merge "
                f"{wk['lse_merge']:.4f}; call {r['walk_ms']:.4f} ms")
    log(f"dense kernels {arch} {name}: {time.perf_counter() - t0:.1f} s")
    return {k: {f: v for f, v in r.items() if f != "names"} for k, r in rows.items()}


def _serve_dense(arch: str, decode_route: str, then=None) -> dict:
    """``arch`` at full width and depth in bf16 (seed 0) through
    ``Engine.step``: the engine cell's six requests, 16 new tokens each,
    faults planted after step 3 (``drive``); then a warm run and one
    profiled pass.  With ``then``, ``then(model, row)`` runs before the
    model is freed.  Returns the timing row; the model is freed."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.models import build_model
    from repro_torch.serving import Engine

    cfg = get_config(arch)
    label = "moe" if cfg.n_experts else "dense"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = sum(p.nbytes for p in model.param_tree().values()) / 1e9
    prompts = requests(cfg.vocab)
    common.reset_launches()
    t0 = time.perf_counter()
    cold = Engine(model, serving_config(), device="cuda")
    results = drive(cold, prompts)
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    for res in results:
        gen = res["generated"]
        if len(gen) != 16 or not all(0 <= t < cfg.vocab for t in gen):
            raise AssertionError(f"{arch}: bad generation {gen}")
    for k in ("paged_decode", "paged_prefill", "scrub"):
        if launches.get(k, 0) < 1:
            raise AssertionError(f"{arch}: kernel {k} never launched on its path")
    steps = cold.metrics()["steps"]
    warm = Engine(model, serving_config(), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drive(warm, prompts)
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    wm = warm.metrics()
    # the routes' main kernels: these two must show, the others not
    want = (ROUTE_MAIN[decode_route], ROUTE_MAIN["wgmma"])
    avoid = tuple(n for r, n in ROUTE_MAIN.items()
                  if r not in (decode_route, "wgmma"))
    # a pass whose window dropped the route's kernels is taken again with
    # twice the pad (as ``kernel_breakdown`` does), up to five times
    t0 = time.perf_counter()
    for tries in range(1, 6):
        per = device_profile(lambda: drive(
            Engine(model, serving_config(), device="cuda"), prompts),
            pad=PROFILE_PAD_S * 2 ** (tries - 1))
        if all(any(w in k for k in per) for w in want):
            break
    profile_s = time.perf_counter() - t0
    if (not all(any(w in k for k in per) for w in want)
            or any(a in k for a in avoid for k in per)):
        raise AssertionError(f"{arch}: the profile shows not all of {want} or "
                             f"one of {avoid}: {sorted(per)}")
    groups, by_kernel = device_groups(per)
    busy = sum(groups.values())
    row = dict(
        arch=arch, layers=cfg.n_layers, dtype=cfg.dtype_name,
        params=sum(p.numel() for p in model.parameters()), init_s=init_s,
        weight_gb=weight_gb,
        decode_route=decode_route, prefill_route="wgmma",
        tokens=wm["tokens_emitted"], steps=wm["steps"],
        ms_per_step=1e3 * warm_wall / wm["steps"],
        tokens_per_s=wm["tokens_emitted"] / warm_wall,
        first_run_ms_per_step=1e3 * cold_wall / steps,
        cold_s=cold_wall, warm_s=warm_wall, profile_s=profile_s,
        profile_tries=tries,
        launches_per_step={k: v / steps for k, v in sorted(launches.items())},
        device_ms_per_step={k: v / wm["steps"] for k, v in groups.items()},
        repair_ms_per_step={k: v / wm["steps"] for k, v in by_kernel.items() if v},
        device_idle_share=(1.0 - busy / (1e3 * warm_wall)) if busy else None,
        top_kernels_ms=[(k[:60], v) for k, v in
                        sorted(per.items(), key=lambda kv: -kv[1])[:8]],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        stats=cold.stats_dict(), kernel_counts=cold.kernel_counts.tolist(),
    )
    log(f"{label} serve ok {arch}: {len(results)} requests x 16 tokens at full width, "
        f"{cfg.n_layers} layers, "
        f"planted faults charged and repaired, paged_decode/paged_prefill/scrub "
        f"launched {[launches[k] for k in ('paged_decode', 'paged_prefill', 'scrub')]} "
        f"in {steps} steps, decode {decode_route}, prefill wgmma")
    log(f"timing {label} {arch}: {json.dumps(row)} ({gpu_line()}; "
        f"{time.perf_counter() - t_phase:.1f} s)")
    del cold, warm
    if then is not None:
        then(model, row)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _route_recorder(model, routes: list, gaps: list):
    """Forward hooks on every MoE router of ``model``: each call appends
    its layer's top-k expert ids (``nn.moe.top_k``) to ``routes`` and the
    smallest gap between the k-th and the (k+1)-th logit to ``gaps``."""
    from repro_torch.nn import moe

    def hook(layer, k):
        def record(_mod, _inp, logits):
            vals, idx = moe.top_k(logits, k + 1)
            routes.append((layer, idx[..., :k].tolist()))
            gaps.append(float((vals[..., k - 1] - vals[..., k]).min()))
        return record

    return [blk.mlp.router.register_forward_hook(hook(i, blk.mlp.k))
            for i, blk in enumerate(model.layers)]


def _dense_parity(arch: str) -> None:
    """``arch`` at full width with 2 layers in f32 (TF32 off), its biases
    and norm parameters drawn nonzero, on the card (kernels) and on the CPU
    (plain versions): the engine on its paged lanes (StableLM-1.6B's f32
    pool takes the heads decode and the FFMA prefill, StarCoder2-15B's and
    Qwen3-MoE's the fused decode and the FFMA prefill), 8 new tokens a
    request, the same plants; tokens, page events, stats, kernel counts and
    host syncs equal, and no gather; an MoE model's per-layer expert ids
    equal too (the smallest routing gap printed beside them)."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import Engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype_name="float32")
    label = "moe" if cfg.n_experts else "dense"
    gpu = build_model(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    drawn = []
    with torch.no_grad():
        for path, leaf in gpu.param_tree().items():
            if path.endswith(DRAWN_LEAVES):
                d = 0.3 * torch.randn(leaf.shape, generator=gen, device=leaf.device)
                leaf.copy_(1.0 + d if path.endswith("/scale") else d)
                drawn.append(path)
    cpu = build_model(cfg, device="cpu", seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    prompts = requests(cfg.vocab)
    outs, gaps = [], []
    for model in (gpu, cpu):
        eng = Engine(model, serving_config(), device=model.device)
        if eng.paged_plan is None or not eng.paged_plan.prefill:
            raise AssertionError(f"{label} parity {arch}: the paged lanes are off")
        routes: list = []
        hooks = (_route_recorder(model, routes, gaps if model is gpu else [])
                 if cfg.n_experts else [])
        res = drive(eng, prompts, max_new=8)
        for h in hooks:
            h.remove()
        outs.append(dict(
            tokens=[r["tokens"] for r in res],
            page_events=eng.pool.page_events.tolist(), stats=eng.stats_dict(),
            kernel_counts=eng.kernel_counts.tolist(),
            n_host_syncs=eng.metrics()["n_host_syncs"],
            gathers=eng.metrics()["pool_gathers"], routes=routes))
    if outs[0]["gathers"] > 0:
        raise AssertionError(f"{label} parity {arch}: not on the paged path")
    for key in outs[0]:
        if outs[0][key] != outs[1][key]:
            raise AssertionError(f"{label} parity {arch}: {key} differs between "
                                 f"card and CPU (smallest routing gap "
                                 f"{min(gaps, default=None)})")
    routed = (f", {len(outs[0]['routes'])} router calls' expert ids equal, "
              f"smallest routing gap {min(gaps)!r}" if gaps else "")
    log(f"{label} parity ok {arch} arm=paged: 2-layer f32, {len(drawn)} bias/norm "
        f"leaves drawn nonzero, stats {outs[0]['stats']}, kernel_counts "
        f"{outs[0]['kernel_counts']}, host syncs {outs[0]['n_host_syncs']}"
        f"{routed} ({time.perf_counter() - t0:.1f} s)")
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()


def dense_variants_phase(report: dict) -> None:
    """StableLM-1.6B and StarCoder2-15B: the paged kernels at their pools
    in bf16 and f32, each model served at full width with its timing, and
    card-vs-CPU parity at 2 layers on the paged lanes; every model freed
    before the phase returns."""
    # f32 is timed at both pools: the engine's f32 paged lanes (the heads
    # decode at StableLM's, the fused one at StarCoder2's, the FFMA prefill
    # at both)
    report["dense_variants"] = {
        arch: dict(kernels={
            "bfloat16": _dense_pool_kernels(arch, shape, "bfloat16", bf16_route),
            "float32": _dense_pool_kernels(arch, shape, "float32", f32_route)})
        for arch, shape, bf16_route, f32_route in DENSE_VARIANTS}
    # the f32 routes beside the kernel report's rows: StableLM's heads
    # decode at splits 4 and FFMA prefill at C, planted
    f32 = report["dense_variants"]["stablelm-1.6b"]["kernels"]["float32"]
    for name, what, key in (("paged_decode", "decode splits=4", "heads"),
                            ("paged_prefill", f"prefill C={C}", "ffma")):
        row = report.get("kernels", {}).get(name)
        if row is not None:
            row[f"stablelm_f32_{key}_device_ms"] = f32[what]["device_ms"]
            row[f"stablelm_f32_{key}_sdpa_device_ms"] = f32[what]["sdpa_device_ms"]
    for arch, _, route, _ in DENSE_VARIANTS:
        report["dense_variants"][arch]["serve"] = _serve_dense(arch, route)
    for arch, *_ in DENSE_VARIANTS:
        _dense_parity(arch)


# ------------------------------------------------------------ phase 5a (MoE)
# Qwen3-MoE-30B-A3B (48 layers, 128 experts top 8, 61.1 GB of bf16 weights)
# at full width and depth on the engine cell; one MoE layer timed alone at
# a decode step of MOE_DECODE_B tokens and a prefill chunk of C_LONG rows;
# a NaN lane planted in hidden row MOE_NAN_ROW; card vs CPU at 2 layers f32
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_DECODE_B = 6
MOE_NAN_ROW, MOE_NAN_LANE = 2, 100
MOE_ITERS = 10
# what else the card may hold when the phase starts (the engine phase's
# Qwen2-1.5B, kept for later phases, is counted apart)
MOE_START_SLACK = 1e9


def _moe_layer_checks(model, row) -> None:
    """One MoE layer of the served model alone: device ms a call (the
    profiler's sum over MOE_ITERS calls, by group) and CUDA events around
    MOE_ITERS queued calls, at a decode step and at a prefill chunk, beside
    the bound of reading its experts once; then a NaN lane in one token's
    hidden row: that token routes to experts 0…k-1 with equal gates and
    comes out NaN, the others route as the port's CPU plain path does on
    the same inputs and come out finite within the bf16 tolerance."""
    import torch

    from repro_torch.nn import moe

    cfg = model.cfg
    layer = model.layers[0].mlp
    expert_bytes = sum(getattr(layer, n).nbytes for n in ("w_gate", "w_up", "w_down"))
    bound_ms = expert_bytes / HBM_BYTES_PER_S * 1e3
    gen = torch.Generator(device="cuda").manual_seed(7)
    timings = {}
    for what, shape in ((f"decode B={MOE_DECODE_B}", (MOE_DECODE_B, 1)),
                        (f"prefill C={C_LONG}", (1, C_LONG))):
        x = torch.randn(shape + (cfg.d_model,), generator=gen,
                        device="cuda").to(cfg.dtype)
        with torch.no_grad():
            def call(x=x):
                return layer(x)

            per = device_profile(lambda: [call() for _ in range(MOE_ITERS)])
            groups, _ = device_groups(per)
            dev = {k: v / MOE_ITERS for k, v in groups.items()}
            queued = queued_ms(call, MOE_ITERS)
            call_ms = cuda_ms(call, iters=MOE_ITERS)
        total = sum(dev.values())
        timings[what] = dict(rows=layer.n_experts * shape[0] * layer.capacity(shape[1]),
                             device_ms=total, device_groups=dev,
                             queued_ms=queued, call_ms=call_ms,
                             bound_ms=bound_ms, bound_by="bytes")
        log(f"timing moe layer {what}: device {total:.4f} ms a call = "
            + ", ".join(f"{k} {v:.4f}" for k, v in dev.items())
            + f"; queued {queued:.4f} ms, call {call_ms:.4f} ms; experts "
            f"{expert_bytes / 1e9:.4f} GB, bound {bound_ms:.4f} ms (bytes), device "
            f"{total / bound_ms:.2f}x it; x {cfg.n_layers} layers: device "
            f"{cfg.n_layers * total:.2f} ms vs bound {cfg.n_layers * bound_ms:.2f} "
            f"ms ({gpu_line()})")
    row["moe_layer"] = timings

    # the planted NaN lane, card against the CPU plain path
    x = torch.randn((MOE_DECODE_B, 1, cfg.d_model), generator=gen,
                    device="cuda").to(cfg.dtype)
    x[MOE_NAN_ROW, 0, MOE_NAN_LANE] = float("nan")
    cpu = moe.MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k,
                  cfg.capacity_factor, dtype=cfg.dtype, device="cpu")
    with torch.no_grad():
        for n, t in layer.named_parameters():
            owner, leaf = n.rsplit(".", 1) if "." in n else ("", n)
            getattr(cpu.get_submodule(owner), leaf).copy_(t.cpu())
        out, _ = layer(x)
        gates, idx, _ = layer.route(x)
        want, _ = cpu(x.cpu())
        _, want_idx, _ = cpu.route(x.cpu())
        vals, _ = moe.top_k(cpu.router(x.cpu()), cfg.top_k + 1)
    k = cfg.top_k
    others = [b for b in range(MOE_DECODE_B) if b != MOE_NAN_ROW]
    gap = float((vals[others, 0, k - 1] - vals[others, 0, k]).min())
    if idx[MOE_NAN_ROW, 0].tolist() != list(range(k)):
        raise AssertionError(f"moe NaN row routed to {idx[MOE_NAN_ROW, 0].tolist()}")
    if not bool((gates[MOE_NAN_ROW, 0] == 1.0 / k).all()):
        raise AssertionError(f"moe NaN row gates {gates[MOE_NAN_ROW, 0].tolist()}")
    if not torch.equal(idx.cpu(), want_idx):
        raise AssertionError(f"moe expert ids differ from the CPU plain path "
                             f"(smallest routing gap {gap!r})")
    if not bool(torch.isnan(out[MOE_NAN_ROW]).all()):
        raise AssertionError("moe NaN row's output is not NaN")
    got = out[others].float().cpu()
    err = _errs(got, want[others].float())
    if not bool(torch.isfinite(got).all()) or err > TOL["bfloat16"] * max(
            1.0, float(want[others].float().abs().max())):
        raise AssertionError(f"moe layer vs CPU: max abs err {err}")
    row["moe_nan_row"] = dict(max_abs_err=err, routing_gap=gap)
    log(f"moe nan-row ok: hidden row {MOE_NAN_ROW} lane {MOE_NAN_LANE} NaN -> "
        f"experts {idx[MOE_NAN_ROW, 0].tolist()}, gates 1/{k}, output NaN; the "
        f"other {len(others)} rows' expert ids equal the CPU plain path's "
        f"(smallest routing gap {gap!r}), outputs finite, max abs err {err:.3e}")


def _check_start(label: str, report: dict) -> None:
    """A phase that builds a large model checks that the card holds no
    other model than the engine phase's Qwen2-1.5B (if still held) when it
    starts: an earlier phase that kept its model would show here."""
    import torch

    held = report.get("model")
    held_bytes = sum(p.nbytes for p in held.parameters()) if held is not None else 0
    start = torch.cuda.memory_allocated()
    if start - held_bytes > MOE_START_SLACK:
        raise AssertionError(f"{label} phase: {start / 1e9:.2f} GB allocated at "
                             f"its start ({held_bytes / 1e9:.2f} GB of them the "
                             "engine phase's model)")
    log(f"{label} phase: {start / 1e9:.3f} GB allocated at its start, "
        f"{held_bytes / 1e9:.3f} GB of them the engine phase's model")


def moe_phase(report: dict) -> None:
    """Qwen3-MoE-30B-A3B at full width and depth in bf16 through
    ``Engine.step`` (the fused decode and the wgmma prefill in its profile),
    one layer timed alone and the NaN-row routing checked on the served
    model, then card vs CPU at 2 layers in f32 with equal expert ids; the
    card holds no other model than the engine phase's Qwen2-1.5B when the
    phase starts, and every model is freed before it returns."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False     # the routers' f32 logits
    _check_start("moe", report)
    row = _serve_dense(MOE_ARCH, "fused", then=_moe_layer_checks)
    log(f"moe memory: weights {row['weight_gb']:.3f} GB, max_memory_allocated "
        f"{row['peak_gb']:.3f} GB ({gpu_line()})")
    report["moe"] = dict(serve=row)
    _dense_parity(MOE_ARCH)


# ------------------------------------------------------------ phase 5b
# training at full qwen2-1.5b width and depth: bf16 params, f32 moments,
# batch 4 x 512 tokens, 5 steps; faults planted before step TRAIN_PLANT_STEP
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_PLANT_STEP = 4, 512, 5, 1
TRAIN_PLANTS = (("params/layers/mlp/w_down", (3, 100, 200), float("nan")),
                ("params/layers/mlp/w_down", (17, 5000, 7), float("inf")),
                ("opt/nu/embed/table", (1234, 56), float("nan")),
                ("opt/nu/embed/table", (99999, 1000), float("-inf")))
# card vs CPU, 2 layers at full width in f32 (TF32 off): loss and every
# gradient within this share of the leaf's largest |value| (the two sum in
# different orders; the CPU tests measure ~1e-6 at reduced width)
TRAIN_CPU_RTOL = 1e-4
# matmul_f32's bf16 gradients against the f64 products: every lane within
# one bf16 ulp plus the f32 sum's own error (sqrt(K) · 2^-24 · Σ|terms|, which
# matters only where the sum cancels), and at most this share of the lanes
# not the f64 product rounded once (f32 sums over K land next to a rounding
# boundary on a few lanes; a cotangent rounded to bf16 first misses ~40 %)
MM_BWD_SHARE = 1e-2


def _bwd_bar(got, exact, mag, k: int):
    """bf16 ``got`` against the f64 ``exact`` whose terms' magnitudes sum to
    ``mag``, over ``k`` terms: (lanes beyond one ulp plus the f32 sum's
    error, share of lanes other than ``exact`` rounded once)."""
    import torch

    ax = exact.abs()
    ulp = torch.where(ax > 0, torch.exp2(torch.floor(torch.log2(ax)) - 7),
                      torch.zeros_like(ax))
    allow = ulp + k ** 0.5 * 2.0 ** -24 * mag
    beyond = int(((got.double() - exact).abs() > allow).sum())
    share = float((got != exact.to(torch.bfloat16)).float().mean())
    return beyond, share


def _train_model_flops(cfg, n_params: int, B: int, S: int) -> float:
    """Forward + backward FLOPs of one step: 6 per parameter and token, and
    the direct attention's full S x S scores and P·V, 3 x 4·B·H·S²·Dh a
    layer."""
    attn = 12.0 * B * cfg.n_heads * S * S * cfg.resolved_head_dim * cfg.n_layers
    return 6.0 * n_params * B * S + attn


def train_phase(report: dict) -> None:
    """Training at full qwen2-1.5b width on the card (ROADMAP slice 4):
    memory mode through the boundary scrub kernel, repair off, register
    mode, card against CPU, and matmul_f32's backward."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import detect
    from repro_torch.data import SyntheticStream
    from repro_torch.kernels import common, scrub as scrub_kernel
    from repro_torch.launch import train as ttrain
    from repro_torch.models import TransformerLM
    from repro_torch.nn.layers import matmul_f32
    from repro_torch.runtime import ApproxConfig, ApproxSpace

    card = gpu_line()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("qwen2-1.5b"),
                              repair=ApproxConfig(mode="memory", policy="zero"))
    model = TransformerLM(cfg, device="cuda", seed=0)
    tree = model.param_tree()
    n_params = sum(t.numel() for t in tree.values())
    data = SyntheticStream(cfg, seed=0, batch=TRAIN_B, seq=TRAIN_S, device="cuda")
    batches = [data(i) for i in range(TRAIN_STEPS)]
    opt = ttrain.make_optimizer(peak_lr=3e-4, warmup=2, total=TRAIN_STEPS)

    def plant(state):
        with torch.no_grad():
            for path, idx, value in TRAIN_PLANTS:
                state[path][idx] = value

    # -- memory mode: the boundary scrub through the scrub kernel
    space = ApproxSpace(cfg.repair)
    state = ttrain.init_train_state(model, opt, space=space)
    raw = ttrain.raw_train_step(model, opt)
    plain: dict = {}

    def checked(state, batch):
        """Between the boundary scrub and the compute: the planted leaves
        must be bit-equal to the plain scrub of their clones."""
        for path, want in plain.pop("leaves", {}).items():
            if not torch.equal(detect.bits_of(state[path]), detect.bits_of(want)):
                raise AssertionError(f"train: the boundary scrub of {path} "
                                     "differs from scrub_plain's")
            for p, idx, _ in TRAIN_PLANTS:
                if p == path and float(state[path][idx]) != 0.0:
                    raise AssertionError(f"train: {path}{idx} does not hold "
                                         "the zero fill")
        return raw(state, batch)

    step_fn = space.wrap_train_step(checked)
    losses, step_ms, scrub_deltas, want = [], [], [], []
    common.reset_launches()                  # the train path's counts from 0
    for i, batch in enumerate(batches):
        if i == TRAIN_PLANT_STEP:
            plant(state)
            counts = torch.zeros(3, dtype=torch.int64, device="cuda")
            leaves = {}
            for path in sorted({p for p, _, _ in TRAIN_PLANTS}):
                rule = space.ruleset.rule_for(path)[1]
                policy, constant = common.kernel_fill(rule.fill)
                clone = state[path].detach().clone()
                counts += scrub_kernel.scrub_plain(
                    clone, policy=policy, constant=constant,
                    detector=rule.detect)[1].to(torch.int64)
                leaves[path] = clone
            plain["leaves"] = leaves
            want = counts.tolist()
        before = dict(state["stats"])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step_fn(state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        scrub_deltas.append([state["stats"][k] - before[k]
                             for k in ("nan_found", "inf_found", "events")])
    launches = dict(common.LAUNCHES)
    if plain or not want:
        raise AssertionError("train: the checked step never ran")
    if scrub_deltas[TRAIN_PLANT_STEP][:2] != want[:2] or \
            scrub_deltas[TRAIN_PLANT_STEP][2] != 1:
        raise AssertionError(f"train: boundary scrub counted "
                             f"{scrub_deltas[TRAIN_PLANT_STEP]}, scrub_plain "
                             f"{want}")
    if any(any(d) for i, d in enumerate(scrub_deltas) if i != TRAIN_PLANT_STEP):
        raise AssertionError(f"train: scrubs of clean steps counted {scrub_deltas}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train: memory mode lost the loss: {losses}")
    n_leaves = sum(1 for p, t in ttrain.resident(state).items()
                   if t.is_floating_point())
    if launches.get("scrub", 0) != n_leaves * TRAIN_STEPS or \
            set(launches) != {"scrub"}:
        raise AssertionError(f"train: launches {launches}, want scrub "
                             f"{n_leaves} a step")
    state = ttrain._fold_rule_counts(space, state)
    rule_stats = space.rule_stats()
    log(f"train ok arm=memory: qwen2-1.5b L={cfg.n_layers} bf16 params="
        f"{n_params} batch {TRAIN_B}x{TRAIN_S}, losses "
        f"{[round(v, 4) for v in losses]}, plants before step "
        f"{TRAIN_PLANT_STEP + 1} counted [nan, inf, events] "
        f"{scrub_deltas[TRAIN_PLANT_STEP]}, scrub_plain's [nan, inf] "
        f"{want[:2]}, leaves bit-equal, planted lanes hold 0; scrub "
        f"launches {n_leaves} a step; rule stats {rule_stats} ({card})")

    # -- timing: warm steps, one profiled step, the update alone
    warm_ms = statistics.median(step_ms[2:])
    per = device_profile(lambda: step_fn(state, batches[0]),
                         table="train_profile.txt")
    groups = {"scrub": 0.0, "gemm": 0.0, "copy": 0.0, "other": 0.0}
    for key, ms in per.items():
        low = key.lower()
        if "scrub_stream" in key:
            groups["scrub"] += ms
        elif any(n in low for n in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
            groups["gemm"] += ms
        elif "memcpy" in low or "memset" in low:
            groups["copy"] += ms
        else:
            groups["other"] += ms
    busy = sum(groups.values())
    grads = model.bind_grads()
    opt_state = {k[4:]: v for k, v in state.items() if k.startswith("opt/")}
    adam_ms = sum(device_profile(lambda: opt.update(grads, opt_state, tree)).values())
    adam_call_ms = cuda_ms(lambda: opt.update(grads, opt_state, tree), iters=5,
                           warmup=1)
    p_bytes = sum(t.numel() * t.element_size() for t in tree.values())
    m_bytes = sum(t.numel() * t.element_size() for p, t in state.items()
                  if p.startswith(("opt/mu/", "opt/nu/")))
    scrub_bound = (p_bytes + m_bytes) / HBM_BYTES_PER_S * 1e3
    adam_bound = (3 * p_bytes + 2 * m_bytes) / HBM_BYTES_PER_S * 1e3
    flops = _train_model_flops(cfg, n_params, TRAIN_B, TRAIN_S)
    row = dict(
        ms_per_step=warm_ms, step_ms=step_ms,
        tokens_per_s=TRAIN_B * TRAIN_S / warm_ms * 1e3,
        device_idle_share=(1.0 - busy / warm_ms) if busy else None,
        device_ms_per_step=groups,
        launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        scrub_device_ms=groups["scrub"], scrub_bound_ms=scrub_bound,
        scrub_bytes=p_bytes + m_bytes,
        adamw_device_ms=adam_ms, adamw_call_ms=adam_call_ms,
        adamw_bound_ms=adam_bound, adamw_bytes=3 * p_bytes + 2 * m_bytes,
        model_tflop=flops / 1e12,
        flops_bound_ms=flops / PEAK_FLOPS["bfloat16"] * 1e3,
        top_kernels_ms=[(k[:60], v) for k, v in
                        sorted(per.items(), key=lambda kv: -kv[1])[:8]],
    )
    report["train"] = row
    log(f"timing train: {json.dumps(row)} ({card})")

    # -- repair off: the same plants poison the run
    del state, opt_state, step_fn, raw
    model.init_weights(0)
    off = ApproxSpace(dataclasses.replace(cfg.repair, mode="off"))
    state = ttrain.init_train_state(model, opt, space=off)
    off_step = ttrain.build_train_step(model, opt, space=off)
    off_losses = []
    for i, batch in enumerate(batches[:TRAIN_PLANT_STEP + 2]):
        if i == TRAIN_PLANT_STEP:
            plant(state)
        state, metrics = off_step(state, batch)
        off_losses.append(float(metrics["loss"]))
    finite = all(bool(torch.isfinite(t).all()) for p, t in state.items()
                 if p.startswith("params/"))
    if all(math.isfinite(v) for v in off_losses[TRAIN_PLANT_STEP:]) and finite:
        raise AssertionError(f"train: repair off survived the plants: {off_losses}")
    log(f"train ok arm=off: losses {off_losses}, params finite {finite} "
        f"(poisoned within 2 steps of the plants) ({card})")
    del state, off_step, grads, tree, model
    torch.cuda.empty_cache()

    # -- register mode, 2 layers: a NaN weight lane, finite loss and grads
    rcfg = dataclasses.replace(cfg, n_layers=2, repair=ApproxConfig(
        mode="register", policy="zero"))
    reg = TransformerLM(rcfg, device="cuda", seed=0)
    with torch.no_grad():
        reg.layers[1].mlp.w_up[7, 1000] = float("nan")
    reg_grads = reg.bind_grads()
    loss, _ = reg.loss({"tokens": batches[0]["tokens"][:, :128]})
    loss.backward()
    bad = [p for p, g in reg_grads.items() if not bool(torch.isfinite(g).all())]
    loss = float(loss.detach())
    if not math.isfinite(loss) or bad:
        raise AssertionError(f"train register: loss {loss}, non-finite "
                             f"grads {bad}")
    if not bool(torch.isnan(reg.layers[1].mlp.w_up[7, 1000])):
        raise AssertionError("train register: the stored NaN was written back")
    log(f"train ok arm=register: 2 layers at full width, one NaN in "
        f"layers[1].mlp.w_up: loss {loss:.4f}, all {len(reg_grads)} "
        f"grads finite, the lane still NaN in memory ({card})")
    del reg, reg_grads, loss

    # -- card against CPU: 2 layers, f32, TF32 off, 128 tokens
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fcfg = dataclasses.replace(cfg, n_layers=2, dtype_name="float32")
    cpu = TransformerLM(fcfg, device="cpu", seed=0)
    gpu = TransformerLM(fcfg, device="cuda", seed=1)
    cpu_tree = cpu.param_tree()
    with torch.no_grad():
        for path, t in gpu.param_tree().items():
            t.copy_(cpu_tree[path])
    tokens = SyntheticStream(fcfg, seed=1, batch=1, seq=128, device="cpu")(0)
    outs = []
    for m in (gpu, cpu):
        g = m.bind_grads()
        loss, _ = m.loss({"tokens": tokens["tokens"].to(m.device)})
        loss.backward()
        outs.append((float(loss.detach()), {p: v.cpu() for p, v in g.items()}))
    loss_rel = abs(outs[0][0] - outs[1][0]) / abs(outs[1][0])
    worst = max(
        (float((outs[0][1][p] - w).abs().max() / w.abs().max().clamp_min(1e-30)), p)
        for p, w in outs[1][1].items())
    if loss_rel > TRAIN_CPU_RTOL or worst[0] > TRAIN_CPU_RTOL:
        raise AssertionError(f"train parity: loss rel {loss_rel}, worst grad "
                             f"{worst}")
    log(f"train parity ok: card vs CPU, 2 layers at full width, f32, 128 "
        f"tokens: loss {outs[0][0]:.6f} vs {outs[1][0]:.6f} (rel "
        f"{loss_rel:.2e}), worst grad {worst[1]} {worst[0]:.2e} <= "
        f"{TRAIN_CPU_RTOL} ({card})")
    del cpu, cpu_tree, gpu, outs

    # -- matmul_f32's backward: the f32 cotangent, rounded once
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((TRAIN_B * TRAIN_S, cfg.d_model), generator=gen,
                    device="cuda").bfloat16().requires_grad_(True)
    w = (torch.randn((cfg.d_model, cfg.d_ff), generator=gen, device="cuda")
         / cfg.d_model ** 0.5).bfloat16().requires_grad_(True)
    g = torch.randn((TRAIN_B * TRAIN_S, cfg.d_ff), generator=gen, device="cuda")
    matmul_f32(a, w).backward(g)
    g64, a64, w64 = g.double(), a.detach().double(), w.detach().double()
    M, K, N = a.shape[0], cfg.d_model, cfg.d_ff
    exact_a, mag_a = g64 @ w64.t(), g64.abs() @ w64.abs().t()
    exact_w, mag_w = a64.t() @ g64, a64.abs().t() @ g64.abs()
    bars = [_bwd_bar(a.grad, exact_a, mag_a, N), _bwd_bar(w.grad, exact_w, mag_w, M)]
    ctrl = _bwd_bar(g.bfloat16() @ w.detach().t(), exact_a, mag_a, N)
    if any(beyond or share > MM_BWD_SHARE for beyond, share in bars):
        raise AssertionError(f"matmul_f32 backward: {bars}")
    if not (ctrl[0] or ctrl[1] > MM_BWD_SHARE):
        raise AssertionError(f"matmul_f32 backward: the bf16-cotangent control "
                             f"passed the bar: {ctrl}")
    log(f"train matmul_f32 backward ok: ({M}, {K}) x ({K}, {N}) bf16, f32 "
        f"cotangent: dA {100 * bars[0][1]:.3f} % of lanes off the f64 product "
        f"rounded once, dB {100 * bars[1][1]:.3f} %, none beyond one ulp plus "
        f"the f32 sum's error; the bf16-cotangent control {100 * ctrl[1]:.2f} "
        f"% ({ctrl[0]} beyond) fails the bar ({card})")


# ------------------------------------------------------------ phase 5c
# checkpointing at full qwen2-1.5b width, cut to CKPT_LAYERS layers (one
# save of the full depth would write 15.44 GB): bf16 params, f32 moments,
# batch 4 x 512, zero fill, memory mode
CKPT_LAYERS, CKPT_B, CKPT_S, CKPT_WARM = 4, 4, 512, 2
CKPT_PLANTS = (("params/layers/mlp/w_down", (1, 100, 200), float("nan")),
               ("params/layers/mlp/w_down", (3, 5000, 7), float("inf")),
               ("opt/nu/embed/table", (1234, 56), float("nan")),
               ("opt/nu/embed/table", (99999, 1000), float("-inf")))
# planted into the restored tree before the reference repair
CKPT_REPLANTS = (("params/layers/attn/wq", (2, 17, 33), float("nan")),
                 ("opt/mu/layers/mlp/w_up", (0, 9, 99), float("inf")))
# a resumed run against the uninterrupted one: the loss and each param
# leaf (relative L2) within this share (the card's backward may sum in
# another order run to run)
CKPT_RESUME_RTOL = 1e-5


def _bits_equal(a, b) -> bool:
    import torch

    from repro_torch.core import detect

    if not a.is_floating_point():
        return torch.equal(a, b)
    return torch.equal(detect.bits_of(a), detect.bits_of(b))


def checkpoint_phase(report: dict) -> None:
    """Checkpointing on the card (ROADMAP §1 item 13): the save scrub
    through the scrub kernel on a copy of the live state, the file clean
    and bit-equal to ``scrub_plain`` of that copy, restore and reference
    repair, and a restart from a ``train_loop`` checkpoint."""
    import shutil

    import torch

    from repro_torch.checkpoint import CheckpointManager, load_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticStream
    from repro_torch.kernels import common, scrub as scrub_kernel
    from repro_torch.launch import train as ttrain
    from repro_torch.models import TransformerLM
    from repro_torch.runtime import ApproxConfig, ApproxSpace

    card = gpu_line()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=CKPT_LAYERS,
                              repair=ApproxConfig(mode="memory", policy="zero"))
    model = TransformerLM(cfg, device="cuda", seed=0)
    data = SyntheticStream(cfg, seed=0, batch=CKPT_B, seq=CKPT_S, device="cuda")
    opt = ttrain.make_optimizer(peak_lr=3e-4, warmup=2, total=8)
    space = ApproxSpace(cfg.repair)
    state = ttrain.init_train_state(model, opt, space=space)
    step_fn = ttrain.build_train_step(model, opt, space=space)
    for i in range(CKPT_WARM):
        state, _ = step_fn(state, data(i))
    state = ttrain._fold_rule_counts(space, state)
    with torch.no_grad():
        for path, idx, value in CKPT_PLANTS:
            state[path][idx] = value
    tensors = {p: t for p, t in state.items() if isinstance(t, torch.Tensor)}
    floats = {p: t for p, t in tensors.items() if t.is_floating_point()}
    n_bytes = sum(t.numel() * t.element_size() for t in floats.values())
    before = {p: t.clone() for p, t in tensors.items()}
    root = ROOT / "build" / "checkpoint_phase"
    shutil.rmtree(root, ignore_errors=True)
    try:
        # -- the save: copy, scrub and device to host block; the write not
        mgr = CheckpointManager(str(root / "a"), keep=2)
        common.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(CKPT_WARM, state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = dict(common.LAUNCHES)
        for path, idx, value in CKPT_PLANTS:      # the live state, at once
            got = float(state[path][idx])
            if not (got == value or (math.isnan(value) and math.isnan(got))):
                raise AssertionError(f"ckpt: the save changed live {path}{idx}")
        mgr.wait()
        t2 = time.perf_counter()
        for p, t in tensors.items():
            if not _bits_equal(t, before[p]):
                raise AssertionError(f"ckpt: the save changed live {p}")
        if launches != {"scrub": len(floats)}:
            raise AssertionError(f"ckpt: save launches {launches}, want scrub "
                                 f"{len(floats)} (one a float leaf)")
        got_counts = mgr.space.stats_dict()

        # -- the file against scrub_plain of the copy, leaf by leaf
        rule = mgr.space.ruleset.rule_for("params/x")[1]
        policy, constant = common.kernel_fill(rule.fill)
        restored, step = load_checkpoint(str(root / "a"), like=state)
        want = torch.zeros(2, dtype=torch.int64, device="cuda")
        for p, t in before.items():
            clone = t.clone()
            if t.is_floating_point():
                want += scrub_kernel.scrub_plain(
                    clone, policy=policy, constant=constant,
                    detector=rule.detect)[1][:2].to(torch.int64)
                if not bool(torch.isfinite(restored[p]).all()):
                    raise AssertionError(f"ckpt: the file's {p} is not finite")
            if not _bits_equal(restored[p], clone):
                raise AssertionError(f"ckpt: the file's {p} is not scrub_plain's")
            del clone
        want = want.tolist()
        if [got_counts["nan_found"], got_counts["inf_found"]] != want or \
                got_counts["events"] != 1:
            raise AssertionError(f"ckpt: the save scrub counted {got_counts}, "
                                 f"scrub_plain {want}")
        if step != CKPT_WARM or restored["stats"] != state["stats"]:
            raise AssertionError("ckpt: step or stats not restored")
        del before

        # -- restore with repair: bit-equal to the file
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        repaired, _ = mgr.restore(like=state, repair=True)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t3) * 1e3
        for p in tensors:
            if not _bits_equal(repaired[p], restored[p]):
                raise AssertionError(f"ckpt: restore(repair=True) changed {p}")
        del repaired
        # -- faults after the restore: the checkpoint's exact bits come back
        stats0 = mgr.space.stats_dict()
        healed = {p: (t.clone() if isinstance(t, torch.Tensor) else t)
                  for p, t in restored.items()}
        with torch.no_grad():
            for path, idx, value in CKPT_REPLANTS:
                healed[path][idx] = value
        common.reset_launches()
        mgr.reference_repair(healed)
        for p in tensors:
            if not _bits_equal(healed[p], restored[p]):
                raise AssertionError(f"ckpt: reference repair left {p} off "
                                     "the checkpoint's bits")
        stats1 = mgr.space.stats_dict()
        delta = [stats1[k] - stats0[k] for k in ("nan_found", "inf_found", "events")]
        if delta != [1, 1, 1]:
            raise AssertionError(f"ckpt: reference repair counted {delta}")
        del healed, restored

        # -- the save scrub's device time alone (clones scrubbed, dropped);
        # a window counts when it recorded every launch (the profiler can
        # drop device events)
        probe = ApproxSpace(mode="memory", policy="zero")
        for _ in range(5):
            counts: dict = {}
            per = device_profile(
                lambda: probe.scrub_copies(floats, lambda p, t: None),
                counts=counts)
            scrub_keys = [k for k in per if "scrub_stream" in k]
            if sum(counts[k] for k in scrub_keys) == len(floats):
                scrub_ms = sum(per[k] for k in scrub_keys)
                break
        else:
            raise AssertionError(f"ckpt: the profiler dropped scrub launches "
                                 f"in 5 windows: {counts}")
        common.reset_launches()

        # -- train_loop with a checkpoint every 2 steps; restart at step 2
        del state, tensors, floats, step_fn
        torch.cuda.empty_cache()
        model.init_weights(0)
        mgr2 = CheckpointManager(str(root / "b"), keep=2)
        full, hist = ttrain.train_loop(model, opt, data, steps=4,
                                       checkpoint_manager=mgr2,
                                       checkpoint_every=2, log_every=1)
        if mgr2.latest_step() != 4 or sorted(os.listdir(root / "b")) != \
                ["step_00000002", "step_00000004"]:
            raise AssertionError(f"ckpt: train_loop saved {os.listdir(root / 'b')}")
        final = {p: t.clone() for p, t in full.items() if p.startswith("params/")}
        like = ttrain.init_train_state(model, opt)
        back, step = load_checkpoint(str(root / "b"), step=2, like=like)
        del like
        resumed, rhist = ttrain.train_loop(model, opt, data, steps=4,
                                           state=back, start_step=2,
                                           log_every=1)
        loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                       for a, b in zip(rhist, hist[2:]))
        param_rel = max(
            float((resumed[p].float() - w.float()).norm()
                  / w.float().norm().clamp_min(1e-30)) for p, w in final.items())
        bit_equal = all(_bits_equal(resumed[p], w) for p, w in final.items()) \
            and all(a["loss"] == b["loss"] for a, b in zip(rhist, hist[2:]))
        if step != 2 or loss_rel > CKPT_RESUME_RTOL or param_rel > CKPT_RESUME_RTOL:
            raise AssertionError(f"ckpt: resume from step 2: loss rel {loss_rel}, "
                                 f"param rel {param_rel}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    block_ms, write_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    row = dict(
        config=f"qwen2-1.5b L={CKPT_LAYERS}", save_bytes=n_bytes,
        save_blocking_ms=block_ms, save_blocking_gb_per_s=n_bytes / block_ms / 1e6,
        worker_write_ms=write_ms, write_gb_per_s=n_bytes / write_ms / 1e6,
        restore_ms=restore_ms, save_scrub_device_ms=scrub_ms,
        save_scrub_bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3,
        save_scrub_launches=launches.get("scrub", 0),
        save_counts=want, resume_loss_rel=loss_rel, resume_param_rel=param_rel,
        resume_bit_equal=bit_equal,
    )
    report["checkpoint"] = row
    log(f"ckpt ok: qwen2-1.5b full width, {CKPT_LAYERS} layers, "
        f"{n_bytes / 1e9:.3f} GB a save; the save scrub counted [nan, inf] "
        f"{want} and 1 event as scrub_plain, {len(CKPT_PLANTS)} plants still "
        f"in the live state, every file leaf bit-equal to scrub_plain of the "
        f"copy and finite; restore(repair=True) bit-equal to the file; "
        f"reference repair put back {len(CKPT_REPLANTS)} planted lanes "
        f"[1, 1, 1]; resumed at step 2: loss rel {loss_rel:.3e}, param rel "
        f"{param_rel:.3e} <= {CKPT_RESUME_RTOL}, bit-equal {bit_equal} ({card})")
    log(f"timing checkpoint: {json.dumps(row)} ({card})")


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
        # per launch: the profiler drops some of these kernels' events; the
        # split only apportions the device time above, so a split that every
        # window dropped is written as not measured (null)
        try:
            split = {k.rstrip("<"): v for k, v in kernel_breakdown(
                lambda: mc.mlstm_chunk_raw(*x), MLSTM_KERNELS[name], iters=5,
                per_launch=True).items()}
            split_text = " + ".join(f"{k} {v:.4f}" for k, v in split.items())
        except ProfilerDropped as exc:
            split, split_text = None, f"not measured ({exc})"
        call = cuda_ms(lambda: mc.mlstm_chunk_raw(*x), iters=10)
        off = ", q/k/v 2 bytes off alignment" if name == "ffma" else ""
        log(f"timing mlstm_chunk ({name} route{off}): "
            f"device {min(timed[name]):.4f} ms (turns "
            f"{', '.join(f'{t:.4f}' for t in timed[name])}; profiler "
            f"{split_text}), call {call:.4f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by})")
        if name == "wgmma":
            row = dict(ms=call, device_ms=min(timed[name]), split=split)
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
        # null where the profiler recorded no device time
        profiled_device_ms=groups if per else None,
        profiled_idle_share=1.0 - sum(groups.values()) / short_ms if per else None,
    )
    log("xlstm forward: " + json.dumps(report["xlstm_forward"]))


def _plant_before(space, scrub_no: int, plants, log_deltas: list,
                  against_plain: bool = False):
    """Wrap ``space.scrub``: before its ``scrub_no``-th call set
    ``plants`` ([(path, index, value)]) in the cache; log every call's
    [nan_found, inf_found, events] delta.  With ``against_plain`` every
    leaf of that call must go through the scrub kernel and come out bit
    for bit as ``scrub_plain`` leaves a copy of it, with its counts."""
    import torch

    from repro_torch.core import detect
    from repro_torch.kernels import common
    from repro_torch.kernels import scrub as scrub_kernel

    inner = space.scrub

    def scrub(cache, stats, *, trigger="forced"):
        plain, want = {}, None
        if len(log_deltas) + 1 == scrub_no:
            for path, idx, val in plants:
                cache[path][idx] = val
            if against_plain:
                plan = space.plan_for(cache, scope="tree", trigger=trigger)
                if set(cache) - plan.kernel_paths:
                    raise AssertionError(f"leaves off the scrub kernel: "
                                         f"{sorted(set(cache) - plan.kernel_paths)}")
                want = 0
                for path, leaf in cache.items():
                    rule = plan.rules[path]
                    policy, constant = common.kernel_fill(rule.fill)
                    plain[path] = leaf.clone()
                    want = want + scrub_kernel.scrub_plain(
                        plain[path], policy=policy, constant=constant,
                        detector=rule.detect)[1][:2].to(torch.int64)
                want = want.tolist()
        cache, out = inner(cache, stats, trigger=trigger)
        log_deltas.append([out[k] - stats[k]
                           for k in ("nan_found", "inf_found", "events")])
        if len(log_deltas) == scrub_no:
            for path, leaf in cache.items():
                if not bool(torch.isfinite(leaf).all()):
                    raise AssertionError(f"{path}: a fatal lane survived the scrub")
                if path in plain and not torch.equal(detect.bits_of(leaf),
                                                     detect.bits_of(plain[path])):
                    raise AssertionError(f"{path}: the scrub's bits differ from "
                                         "scrub_plain's")
            if want is not None and log_deltas[-1][:2] != want:
                raise AssertionError(f"the scrub counted {log_deltas[-1]}, "
                                     f"scrub_plain [nan, inf] {want}")
        return cache, out

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


# ------------------------------------------------------------ phase 10
# xLSTM training at full xlstm-1.3b width, XT_LAYERS blocks: bf16 params, f32
# moments, batch 4 x 128 (512 tokens a step: the step is held by the host's
# eager time loops, whose length is the sequence's, so 2 x 256 took ~8 s a
# step), 3 steps; faults planted before step 2.  The
# chunked mLSTM trains in chunks of XT_CHUNK (the same function, another
# tiling): at the config's chunk of 128 the gradient of the reference's
# ``_chunked_mlstm`` is NaN in both packages, at 64 in the reference's
# (its stabilised denominator underflows; ROADMAP §3)
XT_B, XT_S, XT_STEPS, XT_PLANT_STEP, XT_CHUNK = 4, 128, 3, 1, 32
# the depth trained: 16 of the 48 blocks (2 groups), to keep the whole
# script inside its time limit (a step is host-bound and its time grows
# with depth)
XT_LAYERS = 16
XT_PLANTS = (("params/mlstm_groups/mlstm/w_q", (1, 3, 100, 200), float("nan")),
             ("params/mlstm_groups/mlstm/w_q", (0, 6, 4000, 7), float("inf")),
             ("opt/nu/slstm_layers/slstm/w", (1, 1000, 5000), float("nan")),
             ("opt/nu/slstm_layers/slstm/w", (0, 7, 8000), float("-inf")))
# card vs CPU, one group (8 blocks) in f32, 64 tokens: the loss and each
# gradient leaf (relative L2) within this
XT_CPU_RTOL = 1e-4
# the profiled step windows tried before its device groups and idle share
# are printed as null (the profiler can drop device events in a step's
# ~250k; a window counts only if it recorded every scrub launch)
XT_PROFILE_TRIES = 2


def _xlstm_train_flops(n_params: int, B: int, S: int) -> float:
    """6 FLOPs per parameter and token (forward and backward)."""
    return 6.0 * n_params * B * S


def xlstm_train_phase(report: dict) -> None:
    """xLSTM training at full width and XT_LAYERS blocks on the card (ROADMAP
    §1 item 14): memory mode through the boundary scrub kernel over ~12 GB, repair
    off poisoned, card against CPU."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import detect
    from repro_torch.data import SyntheticStream
    from repro_torch.kernels import common, scrub as scrub_kernel
    from repro_torch.launch import train as ttrain
    from repro_torch.models import XLSTMLM
    from repro_torch.runtime import ApproxConfig, ApproxSpace

    card = gpu_line()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config("xlstm-1.3b"), ssm_chunk=XT_CHUNK,
                              n_layers=XT_LAYERS,
                              repair=ApproxConfig(mode="memory", policy="zero"))
    model = XLSTMLM(cfg, device="cuda", seed=0)
    tree = model.param_tree()
    n_params = sum(t.numel() for t in tree.values())
    data = SyntheticStream(cfg, seed=0, batch=XT_B, seq=XT_S, device="cuda")
    batches = [data(i) for i in range(XT_STEPS)]
    opt = ttrain.make_optimizer(peak_lr=3e-4, warmup=2, total=XT_STEPS)

    def plant(state):
        with torch.no_grad():
            for path, idx, value in XT_PLANTS:
                state[path][idx] = value

    space = ApproxSpace(cfg.repair)
    state = ttrain.init_train_state(model, opt, space=space)
    raw = ttrain.raw_train_step(model, opt)
    plain: dict = {}

    def checked(state, batch):
        for path, want in plain.pop("leaves", {}).items():
            if not torch.equal(detect.bits_of(state[path]), detect.bits_of(want)):
                raise AssertionError(f"xlstm train: the boundary scrub of {path} "
                                     "differs from scrub_plain's")
            for p, idx, _ in XT_PLANTS:
                if p == path and float(state[path][idx]) != 0.0:
                    raise AssertionError(f"xlstm train: {path}{idx} does not "
                                         "hold the zero fill")
        return raw(state, batch)

    step_fn = space.wrap_train_step(checked)
    losses, step_ms, deltas, want = [], [], [], []
    common.reset_launches()                  # the train path's counts from 0
    for i, batch in enumerate(batches):
        if i == XT_PLANT_STEP:
            plant(state)
            counts = torch.zeros(3, dtype=torch.int64, device="cuda")
            plain["leaves"] = {}
            for path in sorted({p for p, _, _ in XT_PLANTS}):
                rule = space.ruleset.rule_for(path)[1]
                policy, constant = common.kernel_fill(rule.fill)
                clone = state[path].detach().clone()
                counts += scrub_kernel.scrub_plain(
                    clone, policy=policy, constant=constant,
                    detector=rule.detect)[1].to(torch.int64)
                plain["leaves"][path] = clone
            want = counts.tolist()
            del clone
        before = dict(state["stats"])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step_fn(state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        deltas.append([state["stats"][k] - before[k]
                       for k in ("nan_found", "inf_found", "events")])
    launches = dict(common.LAUNCHES)
    if plain or not want:
        raise AssertionError("xlstm train: the checked step never ran")
    if deltas[XT_PLANT_STEP][:2] != want[:2] or deltas[XT_PLANT_STEP][2] != 1:
        raise AssertionError(f"xlstm train: boundary scrub counted "
                             f"{deltas[XT_PLANT_STEP]}, scrub_plain {want}")
    if any(any(d) for i, d in enumerate(deltas) if i != XT_PLANT_STEP):
        raise AssertionError(f"xlstm train: clean steps counted {deltas}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"xlstm train: memory mode lost the loss: {losses}")
    resident = {p: t for p, t in ttrain.resident(state).items()
                if t.is_floating_point()}
    n_leaves = len(resident)
    if launches != {"scrub": n_leaves * XT_STEPS}:
        raise AssertionError(f"xlstm train: launches {launches}, want scrub "
                             f"{n_leaves} a step and no mLSTM kernel")
    state = ttrain._fold_rule_counts(space, state)
    log(f"xlstm train ok arm=memory: xlstm-1.3b {cfg.n_layers} blocks "
        f"{cfg.dtype_name} "
        f"params={n_params} batch {XT_B}x{XT_S}, losses "
        f"{[round(v, 4) for v in losses]}, plants before step "
        f"{XT_PLANT_STEP + 1} counted [nan, inf, events] {deltas[XT_PLANT_STEP]}, "
        f"scrub_plain's [nan, inf] {want[:2]}, leaves bit-equal, planted lanes "
        f"hold 0; scrub launches {n_leaves} a step ({n_leaves // 3} params + "
        f"{2 * n_leaves // 3} moments), no mLSTM kernel; rule stats "
        f"{space.rule_stats()} ({card})")

    wall = {"memory_arm_s": time.perf_counter() - t_phase}

    # -- timing: one profiled step (device activity only), the boundary
    # scrub alone and the update alone; a window counts only if it recorded
    # every scrub launch (the profiler can drop device events)
    warm_ms = statistics.median(step_ms[1:])
    step_recorded = []
    for _ in range(XT_PROFILE_TRIES):
        step_counts: dict = {}
        per = device_profile(lambda: step_fn(state, batches[0]),
                             counts=step_counts)
        step_recorded.append(sum(c for k, c in step_counts.items()
                                 if "scrub_stream" in k))
        if step_recorded[-1] == n_leaves:
            break
    else:
        per = None
    plan = space.plan_for(resident, scope="tree", trigger="boundary")
    for _ in range(5):
        counts = {}
        scrub_per = device_profile(
            lambda: plan.run(resident, rules_out=np.zeros(
                (space.ruleset.n_rules, 3), np.int64)), counts=counts)
        keys = [k for k in scrub_per if "scrub_stream" in k]
        if sum(counts[k] for k in keys) == n_leaves:
            scrub_ms = sum(scrub_per[k] for k in keys)
            break
    else:
        raise AssertionError(f"xlstm train: the profiler dropped scrub "
                             f"launches in 5 windows: {counts}")
    groups = {"scrub": 0.0, "gemm": 0.0, "copy": 0.0, "other": 0.0}
    for key, ms in (per or {}).items():
        low = key.lower()
        if "scrub_stream" in key:
            groups["scrub"] += ms
        elif any(n in low for n in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
            groups["gemm"] += ms
        elif "memcpy" in low or "memset" in low:
            groups["copy"] += ms
        else:
            groups["other"] += ms
    busy = sum(groups.values())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    grads = model.bind_grads()
    opt_state = {k[4:]: v for k, v in state.items() if k.startswith("opt/")}
    adam_ms = sum(device_profile(lambda: opt.update(grads, opt_state, tree)).values())
    p_bytes = sum(t.numel() * t.element_size() for t in tree.values())
    m_bytes = sum(t.numel() * t.element_size() for p, t in state.items()
                  if p.startswith(("opt/mu/", "opt/nu/")))
    flops = _xlstm_train_flops(n_params, XT_B, XT_S)
    wall["profile_s"] = time.perf_counter() - t_phase - wall["memory_arm_s"]
    row = dict(
        ms_per_step=warm_ms, step_ms=step_ms,
        tokens_per_s=XT_B * XT_S / warm_ms * 1e3,
        device_idle_share=(1.0 - busy / warm_ms) if busy else None,
        device_ms_per_step=groups if per else None,
        launches_per_step={k: v / XT_STEPS for k, v in launches.items()},
        max_memory_allocated_gb=peak_gb,
        scrub_device_ms=scrub_ms,
        scrub_bound_ms=(p_bytes + m_bytes) / HBM_BYTES_PER_S * 1e3,
        scrub_bytes=p_bytes + m_bytes, scrub_leaves=n_leaves,
        step_profile_scrub_launches=step_recorded,
        adamw_device_ms=adam_ms,
        adamw_bound_ms=(3 * p_bytes + 2 * m_bytes) / HBM_BYTES_PER_S * 1e3,
        model_tflop=flops / 1e12,
        flops_bound_ms=flops / PEAK_FLOPS["bfloat16"] * 1e3,
        top_kernels_ms=[(k[:60], v) for k, v in
                        sorted((per or {}).items(), key=lambda kv: -kv[1])[:8]],
        wall_s=wall,
    )
    report["xlstm_train"] = row
    log(f"timing xlstm train: {json.dumps(row)} ({card})")

    # -- repair off: the same plants poison the run
    del state, opt_state, step_fn, raw, resident, plan
    torch.cuda.empty_cache()
    model.init_weights(0)
    off = ApproxSpace(dataclasses.replace(cfg.repair, mode="off"))
    state = ttrain.init_train_state(model, opt, space=off)
    off_step = ttrain.build_train_step(model, opt, space=off)
    off_losses = []
    for i, batch in enumerate(batches[:XT_PLANT_STEP + 1]):
        if i == XT_PLANT_STEP:
            plant(state)
        state, metrics = off_step(state, batch)
        off_losses.append(float(metrics["loss"]))
    finite = all(bool(torch.isfinite(t).all()) for p, t in state.items()
                 if p.startswith("params/"))
    if math.isfinite(off_losses[XT_PLANT_STEP]) and finite:
        raise AssertionError(f"xlstm train: repair off survived: {off_losses}")
    log(f"xlstm train ok arm=off: losses {off_losses}, params finite {finite} "
        f"(poisoned at the step after the plants) ({card})")
    del state, off_step, grads, tree, model
    torch.cuda.empty_cache()
    t_parity = time.perf_counter()

    # -- card against CPU: one group (8 blocks), f32, TF32 off, 64 tokens
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fcfg = dataclasses.replace(cfg, n_layers=cfg.slstm_every,
                               dtype_name="float32", remat=False)
    cpu = XLSTMLM(fcfg, device="cpu", seed=0)
    gpu = XLSTMLM(fcfg, device="cuda", seed=1)
    cpu_tree = cpu.param_tree()
    with torch.no_grad():
        for path, t in gpu.param_tree().items():
            t.copy_(cpu_tree[path])
    tokens = SyntheticStream(fcfg, seed=1, batch=1, seq=64, device="cpu")(0)
    outs = []
    for m in (gpu, cpu):
        g = m.bind_grads()
        loss, _ = m.loss({"tokens": tokens["tokens"].to(m.device)})
        loss.backward()
        outs.append((float(loss.detach()), {p: v.cpu() for p, v in g.items()}))
        del g, loss
    loss_rel = abs(outs[0][0] - outs[1][0]) / abs(outs[1][0])
    grad_rel = {p: float((outs[0][1][p] - w).norm() / w.norm().clamp_min(1e-30))
                for p, w in outs[1][1].items()}
    worst = max((v, p) for p, v in grad_rel.items())
    bad = [p for p, v in grad_rel.items() if not v <= XT_CPU_RTOL]
    if not loss_rel <= XT_CPU_RTOL or bad:
        raise AssertionError(f"xlstm train parity: loss rel {loss_rel}, "
                             f"grads beyond {XT_CPU_RTOL}: {bad}")
    log(f"xlstm train parity ok: card vs CPU, {fcfg.n_layers} blocks at full "
        f"width, f32, 64 tokens: loss {outs[0][0]:.6f} vs {outs[1][0]:.6f} "
        f"(rel {loss_rel:.2e}), worst grad {worst[1]} {worst[0]:.2e}; bar "
        f"{XT_CPU_RTOL} on each; {time.perf_counter() - t_parity:.1f} s ({card})")


# the autopilot (ROADMAP §1 item 15): the campaign's Poisson bar on each
# cell's flips, the frontier's quality budget, the guard contract of the
# drift arms, and the train guard's geometry (qwen2-1.5b width cut to
# AP_TRAIN_LAYERS layers: ~0.42 B parameters, 4.2 GB of params and moments)
AP_SIGMAS = 6.0
AP_BUDGET = 0.3
AP_GUARD = dict(window=2, tolerance=1.0, floor=0.0, patience=1, cooldown=0)
AP_TRAIN_LAYERS, AP_TRAIN_B, AP_TRAIN_S, AP_TRAIN_STEPS = 4, 2, 128, 4
AP_TRAIN_BER = 1e-6
AP_PLANT_FROM = 3       # the drift arm plants after every step from this one


def _bits_sum(t) -> int:
    """A tensor's stored words summed as int64: one bit flip changes it."""
    import torch

    from repro_torch.core import detect

    return int(torch.sum(detect.bits_of(t), dtype=torch.int64))


def _plant_live(engine, step: int) -> int:
    """NaN in a K lane and ±Inf in a V lane of page 0 of the decoding
    requests (offset 1, below every write slot), at a layer that moves with
    ``step``.  Returns the lanes planted."""
    running = [r for r in engine.sched.running
               if r.prefill_pos is None and r.n_context > PG + 1]
    tree = engine.pool.tree
    layers = tree["layers/k"].shape[1]
    for i, req in enumerate(running[:2]):
        layer = (step + 7 * i) % layers
        tree["layers/k"][req.pages[0], layer, 1, 0, 5 + i] = float("nan")
        tree["layers/v"][req.pages[0], layer, 1, 1, 9 + i] = (
            float("inf") if step % 2 else float("-inf"))
    return 2 * len(running[:2])


def autopilot_phase(report: dict) -> None:
    """The autopilot on the card (ROADMAP §1 item 15): (a) the campaign's
    serve episodes at qwen2-1.5b full width and depth over the transformer
    preset's two groups and four refresh points, (b) the frontier, (c) the
    engine's online guard, steady and under drift, (d) the train loop's
    guard."""
    import gc

    import torch

    from repro_torch import autopilot
    from repro_torch.autopilot import campaign as campaign_lib
    from repro_torch.configs import get_config, get_preset
    from repro_torch.core.regions import Region
    from repro_torch.data import SyntheticStream
    from repro_torch.kernels import common
    from repro_torch.launch import train as ttrain
    from repro_torch.models import TransformerLM
    from repro_torch.runtime import (ApproxConfig, ApproxSpace, AutopilotConfig,
                                     Detector, RepairRule, RuleSet, ScrubSchedule)
    from repro_torch.serving import Engine

    card = gpu_line()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    model = report.get("model") or TransformerLM(get_config("qwen2-1.5b"),
                                                 device="cuda", seed=0)
    ccfg = get_preset("transformer", steps=8).campaign
    groups = {g.name: g for g in ccfg.groups}
    names = {g.pattern: g.name for g in ccfg.groups}
    windows = ccfg.prompt_len + ccfg.steps - 1

    # -- (a) the campaign ------------------------------------------------
    space = campaign_lib.campaign_space(ccfg.groups)
    resident = {f"params/{p}": t for p, t in model.param_tree().items()}
    resident.update({f"cache/{p}": t for p, t in model.init_cache(
        ccfg.batch, ccfg.prompt_len + ccfg.steps + 1).items()})
    plan = space.plan_for(resident, scope="tree", trigger="boundary")
    routes = {
        g.name: "/".join(sorted({"kernel" if p in plan.kernel_paths else "tensor-level"
                                 for p in resident if re.search(g.pattern, p)}))
        for g in ccfg.groups
    }
    if routes != {"ffn_weights": "tensor-level", "kv_cache": "kernel"}:
        raise AssertionError(f"autopilot: scrub routes {routes}")
    del resident, plan, space

    episodes, checked = [], collections.Counter()
    real_serve, real_inject = campaign_lib._serve_episode, ApproxSpace.inject

    def timed_serve(model_, space_, cfg_, pattern, ber, ep_key, force=None):
        before = collections.Counter(common.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_serve(model_, space_, cfg_, pattern, ber, ep_key, force=force)
        torch.cuda.synchronize()
        launched = collections.Counter(common.LAUNCHES) - before
        episodes.append(dict(group=names.get(pattern, "clean"), ber=ber,
                             s=time.perf_counter() - t0,
                             scrub_per_step=launched["scrub"] / windows))
        return out

    def confined_inject(self, tree, generator, ber=None, *, regions=None, **kw):
        """The first two windows of each cell: no leaf outside the mask
        may change."""
        if regions is None or checked[id(regions)] >= 2:
            return real_inject(self, tree, generator, ber, regions=regions, **kw)
        checked[id(regions)] += 1
        outside = [p for p, r in regions.items()
                   if r is not Region.APPROX and tree[p].is_floating_point()]
        sums = {p: _bits_sum(tree[p]) for p in outside}
        out = real_inject(self, tree, generator, ber, regions=regions, **kw)
        moved = [p for p in outside if _bits_sum(tree[p]) != sums[p]]
        if moved:
            raise AssertionError(f"autopilot: flips outside the group in {moved}")
        return out

    campaign_lib._serve_episode, ApproxSpace.inject = timed_serve, confined_inject
    try:
        common.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        profile = autopilot.run_campaign(model, ccfg)
        torch.cuda.synchronize()
        campaign_s = time.perf_counter() - t0
        campaign_launches = dict(common.LAUNCHES)
        n_confined = sum(checked.values())
        again = autopilot.run_campaign(model, dataclasses.replace(
            ccfg, groups=ccfg.groups[:1], refresh_points=ccfg.refresh_points[:2]))
    finally:
        campaign_lib._serve_episode, ApproxSpace.inject = real_serve, real_inject
    if campaign_launches.get("scrub", 0) < 1:
        raise AssertionError(f"autopilot: the campaign never launched the scrub "
                             f"kernel ({campaign_launches})")
    if again.cells != profile.cells[:2]:
        raise AssertionError(f"autopilot: a repeated cell differs: {again.cells} "
                             f"vs {profile.cells[:2]}")
    for c, ep in zip(profile.cells, episodes[1:1 + len(profile.cells)]):
        lam = windows * c.approx_bytes * 8 * c.ber
        if abs(c.flips - lam) > AP_SIGMAS * math.sqrt(lam):
            raise AssertionError(f"autopilot: {c.group} at {c.refresh_s} s: "
                                 f"{c.flips} flips vs Poisson mean {lam:.1f}")
        log(f"autopilot cell {c.group} refresh={c.refresh_s} s ber={c.ber:.3g}: "
            f"quality {c.quality:.4f}, flips {c.flips} (Poisson mean {lam:.1f}), "
            f"faults/step {c.faults_per_step}, approx bytes {c.approx_bytes}, "
            f"energy saving {c.energy_saving:.4f}; episode {ep['s']:.2f} s, "
            f"{ep['scrub_per_step']:.2f} scrub launches a step "
            f"({routes[c.group]} repair) ({card})")
    log(f"autopilot campaign ok: qwen2-1.5b L={model.cfg.n_layers} "
        f"{model.cfg.dtype_name}, {len(profile.cells)} cells + clean in "
        f"{campaign_s:.2f} s (clean episode {episodes[0]['s']:.2f} s), "
        f"{n_confined} windows held to their group, the first "
        f"{len(again.cells)} cells repeated bit for bit, launches "
        f"{campaign_launches} ({card})")

    # -- (b) the frontier ------------------------------------------------
    frontier = autopilot.solve_frontier(profile, AP_BUDGET)
    for a in frontier.assignments:
        ok = [c for c in profile.group_cells(a.group)
              if math.isfinite(c.quality) and c.quality <= AP_BUDGET]
        if a.collapsed != (not ok) or (ok and a.refresh_s != max(c.refresh_s for c in ok)):
            raise AssertionError(f"autopilot: frontier assignment {a}")
        log(f"autopilot frontier {a.group}: refresh {a.refresh_s} s, "
            f"collapsed {a.collapsed}, quality {a.quality:.4f}, expected "
            f"faults/step {a.expected_faults_per_step}")
    if autopilot.ToleranceProfile.from_json(profile.to_json()) != profile:
        raise AssertionError("autopilot: the profile's JSON does not round-trip")
    text = frontier.to_json()
    if autopilot.FrontierAssignment.from_json(text).to_json() != text:
        raise AssertionError("autopilot: the frontier's JSON does not round-trip")
    log(f"autopilot frontier ok: budget {AP_BUDGET}, byte-weighted energy "
        f"saving {frontier.energy_saving:.4f}, JSON round-trips")

    # -- (c) the engine's guard ------------------------------------------
    prompts = requests(model.cfg.vocab)
    base = serving_config()

    def engine_space(rules):
        return ApproxSpace(model.cfg.repair, mode="memory", policy="zero",
                           max_magnitude=None, rules=rules,
                           scrub=ScrubSchedule(boundary=False, interval=0))

    steady = collections.defaultdict(list)
    arms = (("plain", base), ("guarded", dataclasses.replace(
        base, autopilot=frontier.autopilot())))
    for _ in range(2):                      # in turns
        for name, cfg in arms:
            eng = Engine(model, cfg, space=engine_space(frontier.ruleset()),
                         device="cuda")
            before = collections.Counter(common.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = drive(eng, prompts, plant_after=None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            m = eng.metrics()
            launched = collections.Counter(common.LAUNCHES) - before
            steady[name].append(dict(
                ms=1e3 * wall / m["steps"], tokens=[r["tokens"] for r in results],
                launches={k: v / m["steps"] for k, v in sorted(launched.items())},
                scrubbed=m["scrubbed_bytes"], trips=m["autopilot_trips"],
                guard_ms=1e3 * m["stage_wall_s"]["guard"] / m["steps"]))
    ref = steady["plain"][0]
    for name, runs in steady.items():
        for run in runs:
            for key in ("tokens", "launches", "scrubbed"):
                if run[key] != ref[key]:
                    raise AssertionError(f"autopilot steady arm {name}: {key} differs")
    if any(run["trips"] for runs in steady.values() for run in runs):
        raise AssertionError("autopilot steady arm: the guard tripped at BER 0")
    log(f"autopilot steady ok: frontier rules and guard at BER 0, 0 trips, "
        f"tokens, launches a step {ref['launches']} and scrubbed bytes "
        f"{ref['scrubbed']} as without the guard; ms a step in turns: plain "
        f"{[round(r['ms'], 3) for r in steady['plain']]}, guarded "
        f"{[round(r['ms'], 3) for r in steady['guarded']]}, the guard's tick "
        f"{[round(r['guard_ms'], 4) for r in steady['guarded']]} ms a step ({card})")

    kv = groups["kv_cache"]
    eng = Engine(model, dataclasses.replace(base, autopilot=AutopilotConfig(
        **AP_GUARD, expected=((kv.name, 0.0),))),
        space=engine_space(RuleSet(((kv.pattern, kv.labeled_rule()),))),
        device="cuda")
    finite = []

    def checking(fn):
        def call(*a, **k):
            out = fn(*a, **k)
            finite.append(bool(torch.isfinite(out[0]).all()))
            return out
        return call

    hooked = ("serve_step_paged", "prefill_paged", "serve_step", "prefill")
    for name in hooked:
        setattr(model, name, checking(getattr(model, name)))
    try:
        rids = [eng.add_request(p, max_new=16) for p in prompts]
        common.reset_launches()
        trace, planted, step = [], 0, 0
        while eng.has_work:
            before = collections.Counter(common.LAUNCHES)
            g0 = eng.stage_wall_s["guard"]
            eng.step()
            launched = collections.Counter(common.LAUNCHES) - before
            trace.append(dict(paged=eng.paged_plan is not None,
                              decode=launched["paged_decode"],
                              prefill=launched["paged_prefill"],
                              scrub=launched["scrub"], trips=len(eng.guard.trips),
                              guard_ms=1e3 * (eng.stage_wall_s["guard"] - g0)))
            if step >= AP_PLANT_FROM and not eng.space.ruleset.entries[0][1].exact:
                planted += _plant_live(eng, step)
            step += 1
        drift_launches = dict(common.LAUNCHES)
    finally:
        for name in hooked:
            delattr(model, name)
    trips = eng.guard.trips
    if min(drift_launches.get(k, 0) for k in ("paged_decode", "paged_prefill", "scrub")) < 1:
        raise AssertionError(f"autopilot drift arm: launches {drift_launches}")
    if [t["action"] for t in trips] != ["stricter", "exact"]:
        raise AssertionError(f"autopilot drift arm: trips {trips}")
    done = [len(eng.results[r]["generated"]) for r in rids]
    if done != [16] * len(rids) or not all(finite) or not all(
            bool(torch.isfinite(t).all()) for t in eng.pool.tree.values()):
        raise AssertionError(f"autopilot drift arm: generated {done}, "
                             f"{finite.count(False)} non-finite logits")
    at = [next(i for i, s in enumerate(trace) if s["trips"] > n) for n in range(len(trips))]
    for trip, i in zip(trips, at):
        after = trace[i + 1] if i + 1 < len(trace) else None
        log(f"autopilot trip at step {i}: {json.dumps(trip)}; paged_decode "
            f"{trace[i]['paged']}; launches paged_decode/paged_prefill/scrub "
            f"step {i} {trace[i]['decode']}/{trace[i]['prefill']}/{trace[i]['scrub']}, "
            f"step {i + 1} " + (f"{after['decode']}/{after['prefill']}/{after['scrub']}"
                                if after else "none") +
            f"; the tick with the plan rebuild {trace[i]['guard_ms']:.3f} ms")
    quiet = [s["guard_ms"] for j, s in enumerate(trace) if j not in at]
    log(f"autopilot drift ok: {planted} lanes planted over steps "
        f"{AP_PLANT_FROM}-{at[-1]}, trips stricter at step {at[0]} and exact at "
        f"step {at[1]}, {len(rids)} requests x 16 tokens, {len(finite)} logits "
        f"checks finite, rule stats {eng.rule_stats()[kv.name]}, launches "
        f"{drift_launches}, the guard's tick {statistics.median(quiet):.4f} ms "
        f"median without a trip ({card})")

    # -- (d) the train loop's guard --------------------------------------
    tcfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=AP_TRAIN_LAYERS,
                               repair=ApproxConfig(mode="memory", policy="zero"))
    tmodel = TransformerLM(tcfg, device="cuda", seed=0)
    pattern = r"params/|opt/"
    resident_rule = RepairRule(detect=Detector(nan=True, inf=True), fill="zero",
                               trigger="boundary", label="resident")
    tspace = ApproxSpace(ApproxConfig(
        mode="memory", rules=RuleSet(((pattern, resident_rule),)),
        autopilot=AutopilotConfig(**AP_GUARD, expected=(("resident", 0.0),))))
    data = SyntheticStream(tcfg, seed=0, batch=AP_TRAIN_B, seq=AP_TRAIN_S,
                           device="cuda")
    seen = []

    def data_fn(i):
        seen.append((collections.Counter(common.LAUNCHES), tspace.ruleset.entries[0][1]))
        return data(i)

    common.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, history = ttrain.train_loop(
        tmodel, ttrain.make_optimizer(warmup=1, total=AP_TRAIN_STEPS), data_fn,
        steps=AP_TRAIN_STEPS, seed=0, ber=AP_TRAIN_BER, space=tspace, log_every=1)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    seen.append((collections.Counter(common.LAUNCHES), None))
    resident = ttrain.resident(state)
    n_bytes = sum(t.numel() * t.element_size() for t in resident.values())

    def implied(rule):
        rs = ApproxSpace(ApproxConfig(mode="memory", rules=RuleSet(((pattern, rule),))))
        return len(rs.plan_for(resident, scope="tree", trigger="boundary").kernel_paths)

    per_step = [(seen[i + 1][0] - seen[i][0])["scrub"] for i in range(AP_TRAIN_STEPS)]
    want = [implied(seen[i][1]) for i in range(AP_TRAIN_STEPS)]
    decisions = [d for h in history if "autopilot" in h for d in h["autopilot"]]
    losses = [h["loss"] for h in history if "loss" in h]
    deployed = tspace.ruleset.entries[0][1]
    if not decisions or not (deployed.exact or deployed.detect.max_magnitude is not None):
        raise AssertionError(f"autopilot train guard: decisions {decisions}, "
                             f"deployed {deployed}")
    if per_step != want or not sum(per_step) or len(losses) != AP_TRAIN_STEPS or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"autopilot train guard: scrub launches {per_step} vs "
                             f"{want}, losses {losses}")
    log(f"autopilot train ok: qwen2-1.5b width, {AP_TRAIN_LAYERS} layers, "
        f"{AP_TRAIN_B}x{AP_TRAIN_S}, ber={AP_TRAIN_BER:g} over {n_bytes} bytes, "
        f"flips {[h.get('flips') for h in history if 'loss' in h]}, losses "
        f"{[round(x, 4) for x in losses]} (ln V = {math.log(tcfg.vocab):.4f}), trips "
        f"{[(d['action'], d['window'], d['observed']) for d in decisions]}, "
        f"deployed {'exact' if deployed.exact else 'stricter'}, scrub launches "
        f"a step {per_step} (implied by each step's rule: {want}), "
        f"{train_s:.2f} s ({card})")
    del tmodel, state, resident
    timing = dict(
        campaign_s=campaign_s, episode_s=[e["s"] for e in episodes],
        steady_ms_per_step={k: [r["ms"] for r in v] for k, v in steady.items()},
        guard_tick_ms=statistics.median(quiet),
        trip_tick_ms=[trace[i]["guard_ms"] for i in at], train_s=train_s,
        phase_s=time.perf_counter() - t_phase)
    log(f"timing autopilot: {json.dumps(timing)} ({card})")
    # each engine is a reference cycle (its repair manager holds a bound
    # method of the engine) that holds the model and its pool
    del model, eng, tspace, data, data_fn, seen
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 12 (LLaVA)
# LLaVA-NeXT-Mistral-7B (32 layers, d_model 4096, 32/8 heads of 128, d_ff
# 14336, vocab 32000, untied; 14.48 GB of bf16 weights) at full width and
# depth on the engine cell, tokens only as the reference serves it; its bf16
# pool's kernels; one forward of LLAVA_PATCHES patch rows before
# LLAVA_TOKENS tokens (2,048 positions: the chunked attention); card vs CPU
# at 2 layers in f32 on a patch batch of LLAVA_PARITY_SEQ positions
LLAVA_ARCH = "llava-next-mistral-7b"
LLAVA_POOL = PoolShape(65, 32, 16, 8, 128, 32)
LLAVA_PATCHES, LLAVA_TOKENS = 256, 1792
LLAVA_PARITY_SEQ = 64


def _llava_prefix_forward(model, row) -> None:
    """The served model's ``forward`` over one request of LLAVA_PATCHES
    patch rows and LLAVA_TOKENS tokens: finite logits of the tokens alone,
    timed (CUDA events, after a warm call)."""
    import torch

    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(11)
    tokens = torch.randint(0, cfg.vocab, (1, LLAVA_TOKENS), generator=gen,
                           device="cuda")
    patches = torch.randn((1, LLAVA_PATCHES, cfg.d_model), generator=gen,
                          device="cuda").to(cfg.dtype)
    logits = model(tokens, patch_embeds=patches)
    if tuple(logits.shape) != (1, LLAVA_TOKENS, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"llava prefix forward: {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    if torch.equal(model(tokens)[:, -1], logits[:, -1]):
        raise AssertionError("llava prefix forward: the prefix changed nothing")
    ms = cuda_ms(lambda: model(tokens, patch_embeds=patches), iters=3, warmup=1)
    n = LLAVA_PATCHES + LLAVA_TOKENS
    row["prefix_forward"] = dict(patches=LLAVA_PATCHES, tokens=LLAVA_TOKENS,
                                 positions=n, ms=ms, tokens_per_s=n / ms * 1e3)
    log(f"llava prefix ok: {LLAVA_PATCHES} patch rows + {LLAVA_TOKENS} tokens "
        f"({n} positions, chunked attention), logits {tuple(logits.shape)} "
        f"finite; timing llava forward {ms:.2f} ms ({n / ms * 1e3:.0f} "
        f"positions/s) ({gpu_line()})")


def _llava_parity() -> None:
    """LLaVA at full width with 2 layers in f32 (TF32 off): the loss and
    every gradient of one patch batch on the card and on the CPU (plain
    versions) within TRAIN_CPU_RTOL."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticStream
    from repro_torch.models import TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    fcfg = dataclasses.replace(get_config(LLAVA_ARCH), n_layers=2,
                               dtype_name="float32")
    cpu = TransformerLM(fcfg, device="cpu", seed=0)
    gpu = TransformerLM(fcfg, device="cuda", seed=1)
    with torch.no_grad():
        for path, t in gpu.param_tree().items():
            t.copy_(cpu.param_tree()[path])
    batch = SyntheticStream(fcfg, seed=1, batch=1, seq=LLAVA_PARITY_SEQ,
                            device="cpu")(0)
    outs = []
    for m in (gpu, cpu):
        g = m.bind_grads()
        loss, _ = m.loss({k: v.to(m.device) for k, v in batch.items()})
        loss.backward()
        outs.append((float(loss.detach()), {p: v.cpu() for p, v in g.items()}))
    loss_rel = abs(outs[0][0] - outs[1][0]) / abs(outs[1][0])
    worst = max(
        (float((outs[0][1][p] - w).abs().max() / w.abs().max().clamp_min(1e-30)), p)
        for p, w in outs[1][1].items())
    if loss_rel > TRAIN_CPU_RTOL or worst[0] > TRAIN_CPU_RTOL:
        raise AssertionError(f"llava parity: loss rel {loss_rel}, worst grad {worst}")
    log(f"llava parity ok: card vs CPU, 2 layers at full width, f32, "
        f"{tuple(batch['patch_embeds'].shape)[1]} patch rows + "
        f"{tuple(batch['tokens'].shape)[1]} tokens: loss {outs[0][0]:.6f} (rel "
        f"{loss_rel:.2e}), {len(outs[1][1])} grads, worst {worst[0]:.2e} at "
        f"{worst[1]} <= {TRAIN_CPU_RTOL} ({time.perf_counter() - t0:.1f} s)")
    del cpu, gpu, outs
    gc.collect()
    torch.cuda.empty_cache()


def llava_phase(report: dict) -> None:
    """LLaVA-NeXT-Mistral-7B: the paged kernels and the page scrub at its
    bf16 pool against their plain versions and timed beside SDPA; the model
    served at full width and depth through ``Engine.step`` (the fused
    decode and the wgmma prefill in its profile); the patch-prefix forward
    on the served model; card vs CPU at 2 layers in f32 on a patch batch.
    Every model is freed before the phase returns."""
    _check_start("llava", report)
    kernels = _dense_pool_kernels(LLAVA_ARCH, LLAVA_POOL, "bfloat16", "fused")
    row = _serve_dense(LLAVA_ARCH, "fused", then=_llava_prefix_forward)
    report["llava"] = dict(kernels=kernels, serve=row)
    _llava_parity()


# ------------------------------------------------------------ phase 13 (Zamba)
# Zamba2-7B (81 Mamba2 layers: 13 groups of 6 and a tail of 3, d_model 3584,
# ssm_state 64; two shared attention blocks at width 7168, 32 heads of 224;
# 15.59 GB of bf16 weights) at full width and depth through ``generate``
# (the xLSTM cell's 4 prompts of 32 tokens, 16 new, the cache scrubbed
# every 8 steps by the scrub kernel, a zero fill); a NaN planted in the SSM
# state before the first scrub after the warmup; the forward over
# ZAMBA_FORWARD_S tokens; card vs CPU at ZAMBA_CUT_LAYERS layers in f32
ZAMBA_ARCH = "zamba2-7b"
ZAMBA_PLANT_SCRUB = XL_PROMPT_LEN // XL_SCRUB + 1   # before step 32, the first new token
ZAMBA_PLANTS = [("mamba_groups/ssm", (7, 3, 2, 50, 10, 20), float("nan"))]
ZAMBA_FORWARD_S = 2048
ZAMBA_CUT_LAYERS = 13        # 2 groups (both shared sets) and a tail of 1
ZAMBA_CUT_PROMPT, ZAMBA_CUT_NEW, ZAMBA_CUT_SCRUB = 4, 4, 2
ZAMBA_CUT_PLANTS = [("mamba_groups/ssm", (1, 5, 1, 100, 3, 9), float("nan")),
                    ("mamba_tail/ssm", (0, 0, 7, 60, 1), float("inf"))]


def _zamba_cfg(**changes):
    from repro_torch.configs import get_config
    from repro_torch.runtime import ApproxConfig

    # a kernel fill, so the serving scrub runs the scrub kernel on the cache
    return dataclasses.replace(
        get_config(ZAMBA_ARCH),
        repair=ApproxConfig(mode="memory", policy="zero"), **changes)


def _zamba_cut_parity() -> None:
    """Zamba2-7B at full width cut to ZAMBA_CUT_LAYERS layers in f32 (TF32
    off), on the card (the scrub kernel) and on the CPU (its plain
    version), the same weights, prompts and plants: greedy tokens, stats,
    each scrub's counts and the scrubbed bytes equal."""
    import gc

    import numpy as np
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import ZambaLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = _zamba_cfg(n_layers=ZAMBA_CUT_LAYERS, dtype_name="float32")
    gpu = ZambaLM(cfg, device="cuda", seed=0)
    cpu = ZambaLM(cfg, device="cpu", seed=1)
    with torch.no_grad():
        for path, t in cpu.param_tree().items():
            t.copy_(gpu.param_tree()[path].cpu())
    n_params = sum(t.numel() for t in gpu.param_tree().values())
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(2, ZAMBA_CUT_PROMPT)))
    outs = []
    for m in (gpu, cpu):
        space = serve.serve_space(m, ZAMBA_CUT_SCRUB, memoize=False)
        deltas: list = []
        _plant_before(space, 2, ZAMBA_CUT_PLANTS, deltas)
        tokens, stats = serve.generate(
            m, prompts, max_new=ZAMBA_CUT_NEW,
            max_seq=ZAMBA_CUT_PROMPT + ZAMBA_CUT_NEW, space=space)
        outs.append(dict(tokens=tokens.cpu().tolist(), stats=stats, deltas=deltas,
                         scrubbed_bytes=space.scrubbed_bytes))
    if outs[0]["deltas"][1][:2] != [1, 1]:
        raise AssertionError(f"zamba parity: scrubs found {outs[0]['deltas']}")
    for key in outs[0]:
        if outs[0][key] != outs[1][key]:
            raise AssertionError(f"zamba parity: {key} differs between card and "
                                 f"CPU: {outs[0][key]} vs {outs[1][key]}")
    log(f"zamba parity ok: card vs CPU, {ZAMBA_CUT_LAYERS} layers at full width "
        f"({n_params / 1e9:.2f} B, {4 * n_params / 1e9:.2f} GB f32), 2 x "
        f"{ZAMBA_CUT_PROMPT} + {ZAMBA_CUT_NEW}: tokens, stats {outs[0]['stats']}, "
        f"scrub deltas {outs[0]['deltas']} and {outs[0]['scrubbed_bytes']} "
        f"scrubbed bytes equal ({time.perf_counter() - t0:.1f} s)")
    del gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()


def zamba_phase(report: dict) -> None:
    """Zamba2-7B at full width and depth in bf16 through ``generate``: the
    interval scrub runs the scrub kernel on every cache leaf, a NaN planted
    in the SSM state is repaired before the next step reads it (that
    scrub's leaves bit- and count-equal to ``scrub_plain``), and every
    step's logits are finite; then a warm and a profiled run (ms a step,
    idle share), the forward over ZAMBA_FORWARD_S tokens, and card vs CPU
    at ZAMBA_CUT_LAYERS layers in f32.  Every model is freed before the
    phase returns."""
    import gc

    import numpy as np
    import torch

    from repro_torch.kernels import common
    from repro_torch.launch import serve
    from repro_torch.models import ZambaLM

    _check_start("zamba", report)
    card = gpu_line()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ZambaLM(_zamba_cfg(), device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in model.param_tree().values())
    weight_gb = sum(t.nbytes for t in model.param_tree().values()) / 1e9
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab, size=(XL_PROMPTS, XL_PROMPT_LEN)))
    max_seq = XL_PROMPT_LEN + XL_NEW
    cache_bytes = {p: int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
                   for p, (shape, dt) in model.cache_defs(XL_PROMPTS, max_seq).items()}
    space = serve.serve_space(model, XL_SCRUB, memoize=False)
    deltas, steps = [], []
    _plant_before(space, ZAMBA_PLANT_SCRUB, ZAMBA_PLANTS, deltas, against_plain=True)
    _checked_steps(model, steps)
    common.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens, stats = serve.generate(model, prompts, max_new=XL_NEW, max_seq=max_seq,
                                   space=space)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    del model.serve_step                     # drop the checking wrapper
    launches = dict(common.LAUNCHES)
    n_steps = max_seq - 1
    want = [[1, 0] if i == ZAMBA_PLANT_SCRUB - 1 else [0, 0]
            for i in range(len(deltas))]
    if tokens.shape != (XL_PROMPTS, max_seq) or len(steps) != n_steps:
        raise AssertionError(f"zamba generate: {tuple(tokens.shape)}, {len(steps)} steps")
    if [d[:2] for d in deltas] != want:
        raise AssertionError(f"zamba generate: scrubs found {deltas}, want {want}")
    if launches.get("scrub", 0) != len(deltas) * len(cache_bytes):
        raise AssertionError(f"zamba generate: scrub launches {launches}, "
                             f"{len(deltas)} scrubs of {len(cache_bytes)} leaves")
    scrubbed = space.scrubbed_bytes
    # the same run unchecked and unplanted: the warm timing, then profiled
    run = lambda: serve.generate(  # noqa: E731
        model, prompts, max_new=XL_NEW, max_seq=max_seq,
        space=serve.serve_space(model, XL_SCRUB, memoize=False))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    per = device_profile(run)
    groups, by_kernel = device_groups(per)
    busy = sum(groups.values())
    # the forward over ZAMBA_FORWARD_S tokens (chunk 128, chunked attention)
    ftok = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.cfg.vocab, size=(1, ZAMBA_FORWARD_S))).to("cuda")
    logits = model(ftok)
    if tuple(logits.shape) != (1, ZAMBA_FORWARD_S, model.cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"zamba forward: {tuple(logits.shape)} not finite")
    del logits
    fwd_ms = cuda_ms(lambda: model(ftok), iters=3, warmup=1)
    row = dict(
        arch=ZAMBA_ARCH, layers=model.cfg.n_layers, groups=model.n_groups,
        tail=model.n_tail, dtype=model.cfg.dtype_name, params=n_params,
        weight_gb=weight_gb, init_s=init_s, steps=n_steps, scrubs=len(deltas),
        scrub_deltas=deltas, stats=stats, launches=launches,
        scrubbed_bytes=scrubbed, cache_gb={p: b / 1e9 for p, b in cache_bytes.items()},
        first_wall_s=first, warm_wall_s=warm, ms_per_step=1e3 * warm / n_steps,
        new_tokens_per_s=XL_PROMPTS * XL_NEW / warm,
        device_ms_per_step={k: v / n_steps for k, v in groups.items()},
        scrub_device_ms_per_step={k: v / n_steps for k, v in by_kernel.items() if v},
        device_idle_share=(1.0 - busy / (1e3 * warm)) if busy else None,
        forward_tokens=ZAMBA_FORWARD_S, forward_ms=fwd_ms,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    report["zamba"] = row
    log(f"zamba generate ok: {XL_PROMPTS} x {XL_PROMPT_LEN} + {XL_NEW} at full width "
        f"({n_params / 1e9:.3f} B, {weight_gb:.3f} GB bf16), every logit finite, the "
        f"NaN planted in mamba_groups/ssm repaired by scrub {ZAMBA_PLANT_SCRUB} "
        f"before step {XL_PROMPT_LEN} read it, every leaf of that scrub (the f32 "
        f"SSM state, the bf16 conv state and shared K/V) bit- and count-equal to "
        f"scrub_plain of its copy, scrub launches {launches.get('scrub')} "
        f"({len(deltas)} scrubs x {len(cache_bytes)} leaves), {scrubbed} bytes "
        f"scrubbed ({card})")
    log(f"timing zamba: {json.dumps(row)} ({card})")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    _zamba_cut_parity()


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


PHASES = ("kernel_phase", "ops_phase", "engine_phase", "fallback_phase",
          "prefix_tier_phase", "parity_phase", "injection_phase",
          "dense_variants_phase", "moe_phase", "train_phase",
          "checkpoint_phase", "mlstm_phase", "xlstm_forward_phase",
          "xlstm_generate_phase", "xlstm_depth_phase", "xlstm_parity_phase",
          "xlstm_train_phase", "autopilot_phase", "llava_phase",
          "zamba_phase")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--phases", default="",
                    help="comma-separated phases to run alone (default: all, "
                         "and the report lines)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _native

    # torch.utils.checkpoint imports torch._dynamo at its first call, and
    # that import leaves a frame cycle (torch.fx.wrap keeps its own frame)
    # whose f_back chain holds every caller's locals, a phase's models
    # among them, until the next full collection: import it here, where
    # the stack holds nothing
    import torch._dynamo  # noqa: F401

    phases = args.phases.split(",") if args.phases else list(PHASES)
    unknown = set(phases) - set(PHASES)
    if unknown:
        print(f"chip_smoke: unknown phases {sorted(unknown)}", file=sys.stderr)
        return 2
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
    for name in phases:
        t0 = time.perf_counter()
        globals()[name](report)
        log(f"{name}: {time.perf_counter() - t0:.2f} s")
    if args.phases:
        log(f"phases ok: {phases} ({card})")
        return 0
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
