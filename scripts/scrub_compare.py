#!/usr/bin/env python3
"""The scrub kernel of one checkout at the xLSTM cache's size, on the card.

    python3 scripts/scrub_compare.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that two checkouts' kernels can be timed in turns on one card, each in a
process of its own: for example this checkout and an unpacked ``git
archive`` of its parent, in the order parent, change, change, parent.  Only
the public ``scrub`` is called, so any version of the port will do.  The
kernel is built from that checkout's sources into its own
``build/repro_torch_kernels/``.

The buffer is ``mlstm_groups/C`` of the xLSTM generate cache at xlstm-1.3b
width, batch 4: (6, 7, 4, 4, 1024, 1024) f32, 2.82 GB, above the 50 MB L2.
Seven NaN/±Inf lanes are planted (as ``chip_smoke.py``'s shape (b)); the
first call must count exactly them and equal ``scrub_plain`` bit for bit.
Then, on the repaired (clean) buffer: the device time per call from CUDA
events around a queue of 10 calls (every device operation of the call:
kernels, memsets), the lesser of two queues, and the profiler's device time
per call of every operation it recorded, each call's time in one queue
(an event between consecutive calls), and the host's time to enqueue one
call (10 calls without a synchronisation).  Prints one JSON line with
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SHAPE = (6, 7, 4, 4, 1024, 1024)
PLANTS = (0, 1, 513, 1 << 20, 123456789, 700000000, -1)
HBM_BYTES_PER_S = 3.35e12


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("scrub_compare: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.core import detect
    from repro_torch.kernels import _native, scrub as sk

    _native.build(["scrub"], force=True)
    dev = torch.device("cuda")
    c = torch.randn(SHAPE, generator=torch.Generator(device=dev).manual_seed(2),
                    device=dev)
    flat = c.view(-1)
    idx = torch.tensor([i % flat.numel() for i in PLANTS], device=dev)
    flat[idx] = torch.tensor([float("nan"), float("inf"), float("-inf")] * 3,
                             device=dev)[:idx.numel()]
    ref = c.clone()
    got, want = sk.scrub(c)[1], sk.scrub_plain(ref)[1]
    torch.cuda.synchronize()
    ok = (torch.equal(got.cpu(), want.cpu())
          and int(got[0] + got[1]) == len(PLANTS)
          and torch.equal(detect.bits_of(c), detect.bits_of(ref)))
    counts = got.tolist()
    del ref, want
    torch.cuda.empty_cache()

    def queued(iters=10):
        sk.scrub(c)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            sk.scrub(c)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    ms = min(queued() for _ in range(2))
    # one queue with an event between consecutive calls: each call's share
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(11)]
    torch.cuda.synchronize()
    marks[0].record()
    for m in marks[1:]:
        sk.scrub(c)
        m.record()
    marks[-1].synchronize()
    per_call = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        sk.scrub(c)
    enqueue_us = (time.perf_counter() - t0) / 10 * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            sk.scrub(c)
        torch.cuda.synchronize()
    ops = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None) or getattr(
            evt, "self_cuda_time_total", 0)
        if us and not evt.self_cpu_time_total:
            ops[evt.key[:60]] = (us / 1e3 / 5, evt.count / 5)
    nbytes = c.numel() * c.element_size()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(
        label=args.label, src=args.src, card=card, ok=ok, counts=counts,
        queued_ms=ms, per_call_ms=per_call, enqueue_us=enqueue_us, profiled_ms=sum(v[0] for v in ops.values()), ops=ops,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, gb_per_s=nbytes / ms / 1e6,
    )), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
