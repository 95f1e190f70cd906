"""Serving-engine quickstart on the PyTorch/CUDA port, the twin of
``examples/serve_engine.py``: continuous batching over a paged KV pool in
approximate memory, with page-granular reactive repair.

More concurrent requests than the page pool can hold run through the whole
lifecycle (admit, prefill, decode, finish, with preemption under page
pressure) while bit flips strike the pool between steps.  Repair
granularity is the knob:

  --repair page    scrub only the faulted pages among those each step
                   touched (the paper's reactive design, page-granular)
  --repair whole   scrub the entire pool whenever anything faulted
  --repair off     no repair

The prompts come from a seeded ``torch.Generator`` (not the original's
``jax.random`` draws), so the tokens differ from the original's; the
sizes, pool and schedule are its own.

    python examples/torch_serve_engine.py [--ber 1e-3] [--requests 8]
    python examples/torch_serve_engine.py --device cpu   # plain versions
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import device as device_lib  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import ApproxConfig  # noqa: E402
from repro_torch.serving import Engine, ServingConfig  # noqa: E402


def main(device=None, arch: str = "qwen2-1.5b", requests: int = 8,
         max_new: int = 10, ber: float = 1e-3, repair: str = "page") -> dict:
    dev = device_lib.resolve(device)
    cfg = dataclasses.replace(
        get_config(arch).reduced(),
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=97,
        repair=ApproxConfig(mode="off"),   # the engine's space owns repair
    )
    model = build_model(cfg, device=dev, seed=0)

    # a pool smaller than the worst-case demand: 8 requests of up to 5
    # pages each over 10 pages, so admission control and preemption act
    engine = Engine(
        model,
        ServingConfig(
            page_size=4, n_pages=10, max_batch=4, max_pages_per_request=5,
            repair=repair, ber=ber, sweep_interval=8, sweep_pages=2, seed=3,
        ),
        device=dev,
    )
    rids = []
    for i in range(requests):
        gen = torch.Generator().manual_seed(i)
        prompt = torch.randint(1, 96, (5 + i % 3,), generator=gen)
        rids.append(engine.add_request(prompt.tolist(), max_new=max_new))

    t0 = time.time()
    results = engine.run()
    dt = time.time() - t0

    m = engine.metrics()
    d = engine.stats_dict()
    print(f"arch={cfg.name} repair={repair} BER={ber:g} device={dev}")
    print(
        f"served {len(results)} requests / {m['tokens_emitted']} tokens in "
        f"{dt:.1f}s ({1000 * dt / max(m['tokens_emitted'], 1):.0f} ms/token); "
        f"preemptions={m['n_preemptions']}"
    )
    print(
        f"pool: flips={d['flips']} repairs nan={d['nan_found']} "
        f"inf={d['inf_found']} events={d['events']}"
    )
    print(
        f"repair: {m['scrub_calls']} scrub calls "
        f"({m['reactive_scrubs']} reactive, {m['sweep_scrubs']} sweep), "
        f"{m['scrubbed_bytes_per_token']:.0f} scrubbed bytes/token, "
        f"{m['hot_pages']} pages ever charged an event"
    )
    print(f"request 0 continuation: {results[rids[0]]['generated']}")
    return dict(results=results, metrics=m, stats=d)


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=10)
    ap.add_argument("--ber", type=float, default=1e-3)
    ap.add_argument("--repair", default="page", choices=["page", "whole", "off"])
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = _args()
    main(a.device, a.arch, a.requests, a.max_new, a.ber, a.repair)
