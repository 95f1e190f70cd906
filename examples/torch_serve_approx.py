"""Serving under approximate memory on the PyTorch/CUDA port, the twin of
``examples/serve_approx.py``: batched greedy decoding over a protected
dense KV cache, on the ``ApproxSpace`` API.

The KV cache is the dominant approximate-memory resident in serving.  Bit
flips strike the cache between steps, in two conditions:

  --repair register   every cache read repairs in flight (a cost each step)
  --repair memory     a scrub of the cache before each step, counted as a
                      pass when it repaired something (one-shot, then clean:
                      serving's Table 3)

Flips come from a seeded ``torch.Generator``, so they land elsewhere than
the original's ``jax.random`` flips; the sizes and the BER are its own.

    python examples/torch_serve_approx.py [--tokens 48] [--ber 1e-4]
    python examples/torch_serve_approx.py --device cpu   # plain versions
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
from repro_torch.core import stats as stats_lib  # noqa: E402
from repro_torch.launch.serve import build_serve_step, serve_space  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import ApproxConfig  # noqa: E402


def main(device=None, arch: str = "qwen2-1.5b", batch: int = 4,
         tokens: int = 48, ber: float = 1e-4, repair: str = "memory") -> dict:
    dev = device_lib.resolve(device)
    cfg = dataclasses.replace(
        get_config(arch).reduced(),
        repair=ApproxConfig(mode=repair, policy="neighbor_mean",
                            max_magnitude=1e3, ber=ber),
    )
    model = build_model(cfg, device=dev, seed=0)
    max_seq = tokens + 8

    # one runtime object for the serving cache; serve_space() forces the
    # memory-mode scrub path so a poisoned cache is repairable either way
    space = serve_space(model)
    cache = model.init_cache(batch, max_seq)
    step_fn = space.wrap_serve_step(build_serve_step(model))
    stats = stats_lib.zeros()
    gen = torch.Generator(device=dev).manual_seed(9)

    tok = torch.ones((batch, 1), dtype=torch.int32, device=dev)
    out_tokens = [tok]
    t0 = time.time()
    n_scrubs = 0
    for t in range(tokens):
        # an approximate-memory window strikes the resident cache; the
        # ground-truth flip count lands in the unified ``flips`` counter
        cache, _ = space.inject(cache, gen, ber)
        if repair == "memory":
            cache, after = space.scrub(cache, stats)
            n_scrubs += int(after["events"] > stats["events"])
            stats = after
        nxt, logits, cache, stats = step_fn(cache, tok, t, stats)
        assert bool(torch.isfinite(logits).all()), "NaN reached the logits!"
        tok = nxt[:, None]
        out_tokens.append(tok)
    dt = time.time() - t0
    space.record(stats)

    seq = torch.cat(out_tokens, dim=1)
    d = space.stats_dict()
    print(f"arch={cfg.name} repair={repair} BER={ber:g} device={dev}")
    print(f"decoded {tokens} tokens x batch {batch} in {dt:.1f}s "
          f"({1000 * dt / tokens:.0f} ms/token)")
    print(f"cache: flips={d['flips']} repairs nan={d['nan_found']} "
          f"inf={d['inf_found']} events={d['events']} scrub_passes={n_scrubs}")
    print(f"sample continuation (batch 0): {seq[0, :16].tolist()} ...")
    print("all logits finite: True")
    return dict(tokens=seq, stats=d, scrub_passes=n_scrubs)


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=48)
    ap.add_argument("--ber", type=float, default=1e-4)
    ap.add_argument("--repair", default="memory", choices=["register", "memory"])
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = _args()
    main(a.device, a.arch, a.batch, a.tokens, a.ber, a.repair)
