#!/usr/bin/env python3
"""Serving configurations of this checkout's engine in turns, on the card.

    python3 scripts/engine_arms.py [--rounds N]

The workload is ``chip_smoke.py``'s engine phase (Qwen2-1.5B at full width,
28 layers, bf16, random weights from seed 0; 6 requests of 20–100 prompt
tokens, 16 new each; ``ServingConfig(page_size=16, n_pages=64, max_batch=4,
max_pages_per_request=8)``), served by four arms in one process:

  paged       the paged kernels, lockstep (the engine phase)
  drain4      the same with ``drain_interval=4``
  gathered    ``paged_decode="off"``: everything through the gathered view
              and the probe repair
  repair-off  ``repair="off"`` on the gathered view, no faults

Every arm but ``repair-off`` gets the smoke's plants after step 3 (a NaN in
two K lanes and an Inf in a V lane of two decoding requests' pages).  Each
round serves every arm once on a fresh engine, in the order of the list in
even rounds and reversed in odd ones, each run timed by the host's clock up
to a synchronisation.  Prints one JSON line: each arm's ms a step per
round, median and quartiles, and for the pairs (gathered, repair-off) and
(drain4, paged) the ratio of the medians and the share of rounds in which
the first arm was faster, with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ARMS = ("paged", "drain4", "gathered", "repair-off")
PAIRS = (("gathered", "repair-off"), ("drain4", "paged"))


def plant(engine) -> None:
    """``chip_smoke.py``'s plant: NaN in two K lanes and Inf in one V lane
    of two decoding requests' first pages."""
    running = [r for r in engine.sched.running
               if r.prefill_pos is None and r.n_context > 17]
    a, b = running[0], running[1]
    tree = engine.pool.tree
    tree["layers/k"][a.pages[0], 3, 1, 0, 7] = float("nan")
    tree["layers/k"][a.pages[0], 9, 1, 1, 70] = float("nan")
    tree["layers/v"][b.pages[0], 0, 1, 1, 3] = float("inf")


def serve(engine, prompts, planted: bool) -> list:
    rids = [engine.add_request(p, max_new=16) for p in prompts]
    steps = 0
    while engine.has_work:
        engine.step()
        steps += 1
        if planted and steps == 4:
            plant(engine)
    engine.drain()
    return [engine.results[r]["tokens"] for r in rids]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("engine_arms: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _native
    from repro_torch.models import TransformerLM
    from repro_torch.serving import Engine, ServingConfig

    _native.build(["paged_decode", "paged_prefill", "scrub"])
    cfg = get_config("qwen2-1.5b")
    model = TransformerLM(cfg, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    lengths = rng.integers(20, 101, size=6)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)).tolist() for n in lengths]
    base = ServingConfig(page_size=16, n_pages=64, max_batch=4,
                         max_pages_per_request=8)
    configs = {
        "paged": base,
        "drain4": dataclasses.replace(base, drain_interval=4),
        "gathered": dataclasses.replace(base, paged_decode="off"),
        "repair-off": dataclasses.replace(base, repair="off"),
    }
    tokens = {}
    for name in ARMS:                      # warm-up: one run each
        tokens[name] = serve(Engine(model, configs[name], device="cuda"),
                             prompts, name != "repair-off")
    if tokens["drain4"] != tokens["paged"]:
        raise AssertionError("drain4's tokens differ from lockstep's")
    ms = {name: [] for name in ARMS}
    for r in range(args.rounds):
        for name in (ARMS if r % 2 == 0 else ARMS[::-1]):
            engine = Engine(model, configs[name], device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve(engine, prompts, name != "repair-off")
            torch.cuda.synchronize()
            ms[name].append(1e3 * (time.perf_counter() - t0) / engine._t)

    def quartiles(x):
        q = statistics.quantiles(x, n=4)
        return [q[0], statistics.median(x), q[2]]

    pairs = {
        f"{a}/{b}": dict(
            median_ratio=statistics.median(ms[a]) / statistics.median(ms[b]),
            first_faster=sum(x < y for x, y in zip(ms[a], ms[b])) / args.rounds,
        )
        for a, b in PAIRS
    }
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(
        rounds=args.rounds, ms_per_step=ms,
        quartiles_ms={k: quartiles(v) for k, v in ms.items()},
        pairs=pairs, card=card,
    )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
