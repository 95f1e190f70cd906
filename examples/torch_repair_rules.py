"""Heterogeneous protection with the ``RepairRule`` API on the PyTorch/CUDA
port, the twin of ``examples/repair_rules.py``.

One ``RuleSet`` binds three protection classes: optimizer state
range-guarded with a tile-mean fill, KV-style cache leaves NaN-only with a
zero fill repaired reactively, and an embedding table pinned to an
ECC-like exact island.  The same rules drive a boundary scrub, a reactive
pass and an injection window, with per-rule counters in one ledger.  The
state is the port's flat ``{path: tensor}`` dict under the original's
paths; its values come from a seeded ``torch.Generator``.

    python examples/torch_repair_rules.py
    python examples/torch_repair_rules.py --device cpu   # plain versions
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import device as device_lib  # noqa: E402
from repro_torch.core import stats as stats_lib  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    ApproxConfig, ApproxSpace, Detector, RepairRule, RuleSet,
)


def main(device=None, seed: int = 0) -> dict:
    dev = device_lib.resolve(device)
    rules = RuleSet((
        # optimizer moments: a flipped high exponent bit gives ~1e38, a
        # legal float that destroys training: range guard, tile-mean fill
        (r"(^|/)opt(/|$)",
         RepairRule(detect=Detector(max_magnitude=1e3), fill="neighbor_mean")),
        # KV pages: activations are not O(1), so NaN-only detection; a zero
        # fill is fine; repaired reactively, not at every step boundary
        (r"(^|/)(k|v)(/|$)",
         RepairRule(detect=Detector(inf=False), fill="zero",
                    trigger="reactive")),
        # embeddings: "exact via stronger correction" is just another rule
        (r"(^|/)embed(/|$)", RepairRule.exact_rule(label="embed-exact")),
    ))
    space = ApproxSpace(ApproxConfig(mode="memory", rules=rules, ber=1e-4))

    gen = torch.Generator(device=dev).manual_seed(seed)
    state = {
        "params/w": torch.randn((64, 64), generator=gen, device=dev),
        "opt/mu": torch.randn((64, 64), generator=gen, device=dev),
        "k": torch.randn((16, 64), generator=gen, device=dev),
        "embed/table": torch.ones((32, 16), device=dev),
    }

    # one injection window: the exact island is never struck
    state, flips = space.inject(state, gen)
    embed_intact = bool((state["embed/table"] == 1.0).all())
    print(f"injection window: {int(flips)} flips (embed untouched: "
          f"{embed_intact})")

    # poison one lane per protection class
    state["opt/mu"][0, 0] = 4e4                 # a legal float
    state["k"][1, 2] = float("nan")
    state["params/w"][3, 3] = float("inf")

    # boundary pass: the reactive KV rule holds its fire
    state, st = space.scrub(state, stats_lib.zeros(), trigger="boundary")
    kv_resident = bool(torch.isnan(state["k"][1, 2]))
    print(f"boundary scrub: opt range-guard fired "
          f"(|mu[0,0]| now {abs(float(state['opt/mu'][0, 0])):.3f}), "
          f"kv NaN still resident: {kv_resident}")

    # reactive pass: now the KV rule repairs
    state, st = space.scrub(state, st, trigger="reactive")
    kv_clean = bool(torch.isfinite(state["k"]).all())
    print(f"reactive pass: kv clean: {kv_clean}")

    space.record(st)
    print("\nper-rule ledger (one unified definition across passes):")
    for label, counters in space.rule_stats().items():
        print(f"  {label:24s} {counters}")
    print(f"aggregate stream: {space.stats_dict()}")
    return dict(flips=int(flips), embed_intact=embed_intact,
                kv_resident_after_boundary=kv_resident, kv_clean=kv_clean,
                rule_stats=space.rule_stats(), stats=space.stats_dict())


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = _args()
    main(a.device, a.seed)
