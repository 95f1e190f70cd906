#!/usr/bin/env python3
"""The paged serving engine of one checkout at full width, on the card.

    python3 scripts/engine_compare.py [--src DIR] [--label NAME] [--repeats N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that two checkouts' engines can be timed in turns on one card, each in a
process of its own: for example this checkout and an unpacked ``git
archive`` of its parent, in the order parent, change, change, parent.  Only
the public surface is called (``TransformerLM``, ``Engine``,
``ServingConfig``, ``kernels.common.LAUNCHES``), so any version of the port
since the paged engine will do.  The kernels are built from that
checkout's sources into its own ``build/repro_torch_kernels/``.

The workload is ``chip_smoke.py``'s engine phase: Qwen2-1.5B at full width
(28 layers, bf16, random weights from seed 0), ``ServingConfig(page_size=16,
n_pages=64, max_batch=4, max_pages_per_request=8)``, 6 requests of 20–100
prompt tokens (numpy seed 0) with 16 new tokens each, a NaN in two K lanes
and an Inf in a V lane of two decoding requests' pages after step 3.  One
cold run, then ``N`` warm runs, each timed by the host's clock up to a
synchronisation.  Prints one JSON line: ms a warm step per run and their
median, kernel launches a step (the cold run), a digest of the tokens, and
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def plant(engine) -> None:
    """NaN in two K lanes and Inf in one V lane of two decoding requests'
    first pages (``chip_smoke.py``'s plant)."""
    running = [r for r in engine.sched.running
               if r.prefill_pos is None and r.n_context > 17]
    a, b = running[0], running[1]
    tree = engine.pool.tree
    tree["layers/k"][a.pages[0], 3, 1, 0, 7] = float("nan")
    tree["layers/k"][a.pages[0], 9, 1, 1, 70] = float("nan")
    tree["layers/v"][b.pages[0], 0, 1, 1, 3] = float("inf")


def serve(engine, prompts) -> list:
    rids = [engine.add_request(p, max_new=16) for p in prompts]
    steps = 0
    while engine.has_work:
        engine.step()
        steps += 1
        if steps == 4:
            plant(engine)
    return [engine.results[r]["tokens"] for r in rids]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("engine_compare: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _native, common
    from repro_torch.models import TransformerLM
    from repro_torch.serving import Engine, ServingConfig

    _native.build(["paged_decode", "paged_prefill", "scrub"])
    cfg = get_config("qwen2-1.5b")
    model = TransformerLM(cfg, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    lengths = rng.integers(20, 101, size=6)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)).tolist() for n in lengths]
    scfg = ServingConfig(page_size=16, n_pages=64, max_batch=4,
                         max_pages_per_request=8)

    common.reset_launches()
    engine = Engine(model, scfg, device="cuda")
    tokens = serve(engine, prompts)
    torch.cuda.synchronize()
    steps = engine._t
    launches = {k: v / steps for k, v in sorted(common.LAUNCHES.items())}
    ms = []
    for _ in range(args.repeats):
        warm = Engine(model, scfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if serve(warm, prompts) != tokens:
            raise AssertionError("a warm run's tokens differ from the cold run's")
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0) / warm._t)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(
        label=args.label, steps=steps, ms_per_step=ms,
        median_ms_per_step=statistics.median(ms), launches_per_step=launches,
        tokens_sha1=hashlib.sha1(json.dumps(tokens).encode()).hexdigest()[:12],
        card=card,
    )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
