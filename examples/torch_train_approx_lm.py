"""Train a ~100M-parameter LM under approximate memory on the PyTorch/CUDA
port, the twin of ``examples/train_approx_lm.py``.

Three conditions over the same data and seed (the paper's §4 structure,
applied to a training loop instead of one matmul):

  --repair off       bit flips accumulate; the run NaN-poisons
  --repair register  per-use repair: survives, pays detect + select every read
  --repair memory    step-boundary scrub + write-back: survives, one repair
                     per flip (the paper's recommendation)

The approximate-memory window (BER) strikes params + optimizer moments
between steps.  Data and flips come from seeded ``torch.Generator`` streams
(``data.SyntheticStream``, ``launch.train.inject_state``), so the numbers
differ from the original's ``jax.random`` ones.  Every ``--ckpt-every``
steps a ``CheckpointManager`` (keep 2, scrub-on-save) writes the state to
``--ckpt-dir``, by default ``repro_torch_ckpt`` in the temporary directory
(apart from the original's ``repro_ckpt``).  Both families train:
``--arch qwen2-1.5b`` or ``--arch xlstm-1.3b`` (register mode is not
ported for the xLSTM).

    python examples/torch_train_approx_lm.py [--steps 300] [--ber 1e-8] \\
        [--repair memory] [--arch qwen2-1.5b] [--ckpt-dir DIR] \\
        [--ckpt-every 100]
    python examples/torch_train_approx_lm.py --steps 3 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import device as device_lib  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticStream  # noqa: E402
from repro_torch.launch.train import make_optimizer, train_loop  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import ApproxConfig, ApproxSpace  # noqa: E402


def build_100m(arch: str, repair_mode: str):
    """~100M-param variant of the chosen family (CPU-trainable)."""
    cfg = get_config(arch)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-100m",
        n_layers=min(cfg.n_layers, 8),
        d_model=768,
        n_heads=12,
        n_kv=min(cfg.n_kv, 4) if cfg.n_kv < cfg.n_heads else 8,
        head_dim=64,
        d_ff=3072 if cfg.d_ff else 0,
        vocab=32768,
        dtype_name="float32",
        slstm_every=4,
        repair=ApproxConfig(mode=repair_mode, policy="neighbor_mean",
                            max_magnitude=1e3),
        attn_q_block=128,
        attn_kv_block=128,
        ssm_chunk=64,
    )


def main(argv=None) -> list:
    args = _args(argv)
    dev = device_lib.resolve(args.device)
    cfg = build_100m(args.arch, args.repair)
    model = build_model(cfg, device=dev, seed=0)
    n_params = sum(t.numel() for t in model.param_tree().values())
    print(f"arch={cfg.name}  params={n_params:,}  repair={args.repair}  "
          f"BER={args.ber:g}  device={dev}")

    opt = make_optimizer(peak_lr=1e-3, warmup=20, total=args.steps)
    data = SyntheticStream(cfg, seed=0, batch=args.batch, seq=args.seq,
                           device=dev)
    mgr = CheckpointManager(args.ckpt_dir, keep=2, scrub=True)
    # one ApproxSpace owns the run: the boundary scrub inside the step, the
    # injection window between steps, one stats stream (flips included)
    space = ApproxSpace(cfg.repair, ber=args.ber)

    t0 = time.time()
    _, hist = train_loop(model, opt, data, steps=args.steps, seed=0,
                         ber=args.ber, checkpoint_manager=mgr,
                         checkpoint_every=args.ckpt_every, log_every=10,
                         space=space)
    dt = time.time() - t0

    print(f"\n{'step':>6} {'loss':>9} {'acc':>7} {'flips':>7} "
          f"{'repairs(nan/inf)':>18}")
    for h in hist:
        print(f"{h['step']:>6} {h['loss']:>9.4f} {h['accuracy']:>7.4f} "
              f"{h['flips']:>7} {h['nan_found']:>9}/{h['inf_found']}")
    print(f"\n{args.steps} steps in {dt:.1f}s "
          f"({1000 * dt / args.steps:.0f} ms/step); "
          f"final checkpoint: step {mgr.latest_step()}")
    return hist


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ber", type=float, default=1e-8)
    ap.add_argument("--repair", default="memory",
                    choices=["off", "register", "memory"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    return ap.parse_args(argv)


if __name__ == "__main__":
    main()
