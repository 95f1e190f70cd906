#!/usr/bin/env python3
"""What ``chip_smoke.py``'s device-time readings cost the host, on the card.

    python3 scripts/profile_sums.py [--rounds N]

Serves ``chip_smoke.py``'s engine cell (Qwen2-1.5B at full width, bf16,
seed 0, six requests of 16 new tokens with faults planted after step 3)
once unprofiled, then ``N`` times through ``chip_smoke.device_profile``:
even rounds with device activity alone, odd ones with host activity too and
its table written to ``chiprun_out/profile_sums.txt``.  Each round times
the reading (the run under the profiler and its sums by name) and then
``key_averages()`` of the same trace, and checks that both give the same
names and sums (within 1e-6 ms); it prints one line per round with the
event counts and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _native
    from repro_torch.models import build_model
    from repro_torch.serving import Engine

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_sums: CUDA is not available", file=sys.stderr)
        return 1
    _native.build()
    cfg = get_config("qwen2-1.5b")
    model = build_model(cfg, device="cuda", seed=0)
    prompts = cs.requests(cfg.vocab)

    def run():
        cs.drive(Engine(model, cs.serving_config(), device="cuda"), prompts)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    print(f"unprofiled run {time.perf_counter() - t0:.2f} s", flush=True)
    kept = []

    class Kept(torch.profiler.profile):
        """The profiler ``device_profile`` opens, kept to read it again."""

        def __exit__(self, *exc):
            kept.append(self)
            return super().__exit__(*exc)

    torch.profiler.profile = Kept
    for r in range(args.rounds):
        table = "profile_sums.txt" if r % 2 else ""
        t0 = time.perf_counter()
        per = cs.device_profile(run, table=table, pad=0.0)
        t1 = time.perf_counter()
        avg: dict = {}
        for evt in kept[-1].key_averages():
            us = getattr(evt, "self_device_time_total", 0)
            if us and not evt.self_cpu_time_total:
                avg[evt.key] = avg.get(evt.key, 0.0) + us / 1e3
        t2 = time.perf_counter()
        diff = max(abs(per.get(k, 0.0) - v) for k, v in avg.items())
        if set(per) != set(avg) or diff > 1e-6:
            raise AssertionError(f"the two sums differ: {sorted(set(per) ^ set(avg))}, "
                                 f"largest difference {diff} ms")
        events = kept[-1].profiler.kineto_results.events()
        n_dev = sum(1 for e in events
                    if e.device_type() == torch.autograd.DeviceType.CUDA)
        print(f"round {r} ({'host and device' if table else 'device alone'}): "
              f"device_profile {t1 - t0:.2f} s, key_averages {t2 - t1:.2f} s; "
              f"{len(events)} events, {n_dev} on the device, {len(per)} names, "
              f"device total {sum(per.values()):.3f} ms, largest difference "
              f"{diff:.3g} ms ({cs.gpu_line()})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
