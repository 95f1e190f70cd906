"""EDEN-style BER autopilot end to end on the PyTorch/CUDA port, the twin
of ``examples/autopilot.py`` at its sizes (README §Autopilot).

Three layers, one story:

  1. **campaign**: group the state by path regex (FFN weights vs the KV
     cache), sweep a ladder of DRAM refresh points, and measure each
     group's quality loss in isolation (injected episodes teacher-forced
     against the clean trajectory);
  2. **frontier**: pick the most aggressive refresh each group tolerates
     within one quality budget; a group that fails everywhere collapses to
     an exact-ECC island.  The solver emits the per-region refresh map, a
     concrete ``RuleSet``, the expected fault rates and the byte-weighted
     energy saving;
  3. **guard**: deploy those expectations online: the serving engine
     watches the per-rule fault counters each window and tightens a
     drifting group's rule, stricter detection first, exact-ECC demotion
     second.

The flips come from seeded ``torch.Generator``s (not the original's
``jax.random`` draws), so the cells differ from the original's; the
preset, sweep, budget and engine are its own.

    python examples/torch_autopilot.py                  # on the card
    python examples/torch_autopilot.py --device cpu     # plain versions
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import device as device_lib  # noqa: E402
from repro_torch.autopilot import run_campaign, solve_frontier  # noqa: E402
from repro_torch.configs import get_preset  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import ApproxConfig  # noqa: E402
from repro_torch.serving import Engine, ServingConfig  # noqa: E402


def main(argv=None) -> dict:
    args = _args(argv)
    dev = device_lib.resolve(args.device)

    # -- 1. the profiling campaign ---------------------------------------
    # the transformer preset: a tiny qwen2 with two region groups.  Keep
    # the sweep short for the demo: two refresh points, six decode steps.
    preset = get_preset("transformer", steps=6)
    preset = dataclasses.replace(
        preset,
        campaign=dataclasses.replace(preset.campaign, refresh_points=(1.0, 2.0)),
    )
    print(f"profiling {preset.name!r} on {dev}: "
          f"{[g.name for g in preset.campaign.groups]} x "
          f"{list(preset.campaign.refresh_points)} s refresh")
    profile = run_campaign(preset.build_model(device=dev), preset.campaign)
    for c in profile.cells:
        print(f"  {c.group:<12} refresh={c.refresh_s:>5.2f}s "
              f"ber={c.ber:.0e} quality={c.quality:.3f} "
              f"flips={c.flips} saving={c.energy_saving:.3f}")

    # -- 2. the frontier solve -------------------------------------------
    frontier = solve_frontier(profile, budget=preset.budget)
    print(f"\nbudget {preset.budget}: per-group assignment")
    for a in sorted(frontier.assignments, key=lambda a: a.group):
        tag = "EXACT ISLAND" if a.collapsed else f"{a.refresh_s:.2f}s"
        print(f"  {a.group:<12} -> {tag:<12} quality={a.quality:.3f} "
              f"expected_faults/step={a.expected_faults_per_step:.2f}")
    print(f"byte-weighted energy saving: {frontier.energy_saving:.3f}")

    # the artifacts are deployable objects, not a report: a refresh map,
    # a RuleSet, and the guard's expected-rate table
    print(f"refresh map: {frontier.refresh_map()}")
    print(f"rules: {[(p, r.label, r.exact) for p, r in frontier.ruleset().entries]}")
    auto = frontier.autopilot()
    print(f"guard expectations: {auto.expected}")

    # -- 3. the online guard ---------------------------------------------
    # serve with the solved ruleset, but simulate MORE faults than the
    # profile promised (a drifting DRAM module): the guard notices the
    # excess within a few windows and tightens the drifting group's rule.
    arch = dataclasses.replace(
        preset.arch, repair=ApproxConfig(mode="memory", rules=frontier.ruleset()),
    )
    model = build_model(arch, device=dev, seed=0)
    cfg = ServingConfig(
        page_size=4, n_pages=16, max_batch=2, max_pages_per_request=8,
        repair="page", ber=2e-3, seed=0,       # ~100x the profiled BER
        paged_decode="off",   # gathered path: repairs land in rule counters
        # short windows + no slack so the drift shows within one request
        autopilot=dataclasses.replace(auto, window=2, patience=1, floor=0.0),
    )
    eng = Engine(model, cfg, device=dev)
    eng.add_request(list(range(1, 9)), max_new=8)
    results = eng.run()
    print(f"\nserved under drift: autopilot_trips="
          f"{eng.metrics()['autopilot_trips']}")
    for trip in eng.guard.trips:
        print(f"  tightened {trip['label']!r}: {trip['action']} "
              f"(observed {trip['observed']} faults vs "
              f"threshold {trip['threshold']:.1f} in window {trip['window']})")
    return dict(profile=profile, frontier=frontier, trips=list(eng.guard.trips),
                metrics=eng.metrics(), results=results)


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    main()
