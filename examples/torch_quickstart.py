"""Quickstart on the PyTorch/CUDA port: the paper's experiment on the
`ApproxSpace` API, the twin of ``examples/quickstart.py``.

  0. one approximate-memory window of bit flips, counted in the unified
     stats;
  1. a single NaN in a matrix operand poisons a whole output row (Fig. 1);
  2. the fused-repair matmul prevents it, and memory mode scrubs the
     operand at its origin;
  3. Table 3: register mode re-fires on every reuse, memory mode repairs
     the origin once (asserted: events 4/4/4/4 against 4/0/0/0 at
     n = 512, blocks (128, 128, 256)), every kernel event landing in the
     space's unified stats (asserted);
  4. the memory-mode scrub of a resident buffer through the space;
  5. the same two mechanisms on attention over a cached K/V with one NaN
     (the serving form of Table 3).

The port's memory mode repairs IN PLACE, so every consumer below gets its
own clone of the poisoned operand.

    python examples/torch_quickstart.py                 # on the card
    python examples/torch_quickstart.py --device cpu    # plain versions
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import device as device_lib  # noqa: E402
from repro_torch.core import injection  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime import ApproxConfig, ApproxSpace  # noqa: E402

N, BLOCKS, REUSE = 512, (128, 128, 256), 4


def main(device=None, seed: int = 0) -> dict:
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((N, N), generator=gen, device=dev)
    b = torch.randn((N, N), generator=gen, device=dev)
    space = ApproxSpace(ApproxConfig(mode="memory", policy="zero", ber=1e-6))
    recorded = []

    def record(counts):
        space.record_kernel(counts)
        recorded.append(int(counts[ops.MM_EV_TOTAL]))

    # -- 0. the simulation boundary (flips in place: inject over a clone)
    _, flips = space.inject({"a": a.clone()}, gen, ber=1e-5)
    print(f"one approximate-memory window at BER 1e-5: {flips} bit flips "
          f"(ground truth, recorded in unified stats)")

    # -- 1. the failure the paper describes: one NaN poisons a row
    a_bad = injection.inject_nan(a, 1, generator=gen)
    c_poisoned = a_bad @ b
    n_nan = int(torch.isnan(c_poisoned).sum())
    print(f"plain matmul with ONE NaN operand -> {n_nan} NaN outputs "
          f"({100.0 * n_nan / c_poisoned.numel():.1f}% of the result)")

    # -- 2. reactive fused repair; memory mode scrubs its (cloned) operand
    res = ops.repair_matmul(a_bad.clone(), b, mode="memory", policy="zero",
                            blocks=BLOCKS)
    record(res.counts)
    print(f"repair_matmul      -> finite: {bool(torch.isfinite(res.c).all())}, "
          f"events: {recorded[-1]}, "
          f"origin scrubbed: {not bool(torch.isnan(res.a).any())}")
    err = float((res.c - a @ b).abs().max())
    print(f"max |error| vs clean product: {err:.3f} "
          f"(bounded by the repaired lane's contribution)")
    # the zero policy: the clean product with the NaN lane zeroed, up to
    # the f32 summation order
    torch.testing.assert_close(
        res.c, a.masked_fill(torch.isnan(a_bad), 0.0) @ b, rtol=1e-4, atol=1e-3,
        msg="repair_matmul differs from the product with the lane zeroed")

    # -- 3. Table 3: register vs memory over repeated consumption
    print("\nreuse  register-events  memory-events   (paper Table 3)")
    a_reg, a_mem = a_bad.clone(), a_bad.clone()
    reg, mem = [], []
    for i in range(REUSE):
        r = ops.repair_matmul(a_reg, b, mode="register", blocks=BLOCKS)
        m = ops.repair_matmul(a_mem, b, mode="memory", blocks=BLOCKS)
        record(r.counts)
        reg.append(recorded[-1])
        record(m.counts)
        mem.append(recorded[-1])
        a_reg, a_mem = r.a, m.a
        print(f"  {i}        {reg[-1]:3d}             {mem[-1]:3d}")
    print("\nregister mode pays on every reuse; memory mode paid once.")
    visits = N // BLOCKS[1]
    assert reg == [visits] * REUSE, f"register events {reg}"
    assert mem == [visits] + [0] * (REUSE - 1), f"memory events {mem}"
    assert bool(torch.isnan(a_reg).any()), "register mode changed its operand"
    events = space.stats_dict()["events"]
    assert events == sum(recorded), (
        f"kernel counters did not reach unified stats: {events} != "
        f"{sum(recorded)}"
    )

    # -- 4. the memory-mode mechanism at the state-dict level
    clean = space.scrub({"w": a_bad.clone()})
    print(f"space.scrub repaired the resident buffer: "
          f"{not bool(torch.isnan(clean['w']).any())}")

    # -- 5. the same on attention over a cached K/V (serving's Table 3)
    q = torch.randn((1, 4, 256, 64), generator=gen, device=dev)
    k = injection.inject_nan(
        torch.randn((1, 2, 256, 64), generator=gen, device=dev), 1,
        generator=gen)
    v = torch.randn((1, 2, 256, 64), generator=gen, device=dev)
    k_reg, k_mem, att_reg, att_mem = k.clone(), k.clone(), [], []
    for _ in range(REUSE):
        r = ops.flash_attention(q, k_reg, v, mode="register", blocks=(64, 64))
        m = ops.flash_attention(q, k_mem, v, mode="memory", blocks=(64, 64))
        space.record_kernel(r.counts)
        space.record_kernel(m.counts)
        att_reg.append(int(r.counts[ops.AT_EV_TOTAL]))
        att_mem.append(int(m.counts[ops.AT_EV_TOTAL]))
        assert bool(torch.isfinite(r.out).all() and torch.isfinite(m.out).all())
        torch.testing.assert_close(r.out, m.out, rtol=1e-5, atol=1e-5,
                                   msg="register and memory attention differ")
    print(f"flash_attention over a poisoned K: register events {att_reg}, "
          f"memory events {att_mem}")
    assert att_reg[0] > 0 and att_reg == [att_reg[0]] * REUSE
    assert att_mem == [att_reg[0]] + [0] * (REUSE - 1)

    stats = space.stats_dict()
    print(f"\nunified stats (flips + scrub + fused-kernel events in one "
          f"stream): {stats}")
    return dict(register=reg, memory=mem, attention_register=att_reg,
                attention_memory=att_mem, stats=stats, flips=flips,
                nan_outputs=n_nan, max_error=err)


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


if __name__ == "__main__":
    args = _args()
    main(args.device, args.seed)
