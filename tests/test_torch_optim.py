"""Port parity of the optimizer, the schedule and the synthetic stream
against the JAX reference on the CPU.

* ``cosine_with_warmup``: within 5e-7 relative of the reference, eager and
  under jit, at every step from 0 to total + 5 (XLA itself gives different
  last bits eager and under jit: 3 ulps at most here);
* ``AdamW.update`` with an active clip and a negative ``nu`` lane: f32
  moments and params within 1e-6 relative of the leaf's largest value
  (the global norm sums in another order), bf16 params equal except where
  the f32 update rounds to a neighbouring bf16 value (at most 0.1 % of the
  lanes, one ulp), the step and the learning rate as the reference's;
* ``SyntheticStream``: pure in (seed, step), the reference's shapes,
  dtypes and ``host_slice`` rows, tokens in range with the same n-gram
  structure (its bits cannot be threefry's).
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import SyntheticStream as JStream  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import cosine_with_warmup as jcosine  # noqa: E402
from repro.optim.adamw import OptState  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticStream, batch_for_step  # noqa: E402
from repro_torch.optim import AdamW, cosine_with_warmup  # noqa: E402

SCHEDULE_RTOL = 5e-7
F32_RTOL = 1e-6
MAX_DIFF_SHARE = 1e-3


@pytest.mark.parametrize("peak,warmup,total", [
    (3e-3, 5, 30), (1e-3, 20, 300), (3e-4, 0, 50), (3e-4, 100, 160)])
def test_schedule_matches_reference(peak, warmup, total):
    steps = np.arange(total + 6, dtype=np.int32)
    jsched = jcosine(peak, warmup, total)
    eager = np.array([float(jsched(jnp.asarray(s))) for s in steps], np.float32)
    jitted = np.asarray(jax.jit(jax.vmap(jsched))(jnp.asarray(steps)))
    got = cosine_with_warmup(peak, warmup, total)(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    for want in (eager, jitted):
        np.testing.assert_allclose(got.numpy(), want, rtol=SCHEDULE_RTOL, atol=0)
    one = cosine_with_warmup(peak, warmup, total)(int(steps[-1]))
    assert one.dim() == 0 and float(one) == pytest.approx(0.1 * peak, rel=1e-6)


SHAPES = {"w": (24, 40), "b": (40,), "table": (31, 24)}


def _adam_inputs(dtype, seed=0):
    """Params, big grads (the clip is active), moments with one negative
    ``nu`` lane, step 4."""
    rng = np.random.default_rng(seed)
    np_dt = {"float32": np.float32, "bfloat16": jnp.bfloat16}[dtype]
    params = {k: np.asarray(jnp.asarray(rng.standard_normal(s) * 0.3, np_dt))
              for k, s in SHAPES.items()}
    grads = {k: np.asarray(jnp.asarray(rng.standard_normal(s) * 2.0, np_dt))
             for k, s in SHAPES.items()}
    mu = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
          for k, s in SHAPES.items()}
    nu = {k: np.abs(rng.standard_normal(s) * 0.01).astype(np.float32)
          for k, s in SHAPES.items()}
    nu["w"][3, 7] = -0.5            # a flipped sign bit: finite drift
    return params, grads, mu, nu, 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    params, grads, mu, nu, step = _adam_inputs(dtype)
    sched = dict(peak=1e-2, warmup=2, total=20)
    jopt = JAdamW(lr=jcosine(sched["peak"], sched["warmup"], sched["total"]))
    topt = AdamW(lr=cosine_with_warmup(sched["peak"], sched["warmup"],
                                       sched["total"]))
    jp, jstate, jmet = jopt.update(
        jax.tree.map(jnp.asarray, grads),
        OptState(jnp.asarray(step, jnp.int32), jax.tree.map(jnp.asarray, mu),
                 jax.tree.map(jnp.asarray, nu)),
        jax.tree.map(jnp.asarray, params))
    tp = {k: convert.to_torch(v) for k, v in params.items()}
    tstate = {"step": torch.tensor(step, dtype=torch.int32)}
    tstate.update({f"mu/{k}": torch.from_numpy(v.copy()) for k, v in mu.items()})
    tstate.update({f"nu/{k}": torch.from_numpy(v.copy()) for k, v in nu.items()})
    tmet = topt.update({k: convert.to_torch(v) for k, v in grads.items()},
                       tstate, tp)
    assert float(jmet["grad_norm"]) > 1.0          # the clip is active
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=F32_RTOL)
    assert float(tmet["lr"]) == float(jmet["lr"])
    assert int(tstate["step"]) == int(jstate.step) == step + 1
    for k in SHAPES:
        for name, want in (("mu", jstate.mu[k]), ("nu", jstate.nu[k])):
            got = tstate[f"{name}/{k}"].numpy()
            want = np.asarray(want)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=F32_RTOL * np.abs(want).max())
        got, want = tp[k], np.asarray(jp[k])
        assert got.dtype == convert.to_torch(want).dtype
        if dtype == "float32":
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=F32_RTOL * np.abs(want).max())
        else:
            g = got.view(torch.int16).numpy().astype(np.int32)
            w = want.view(np.int16).astype(np.int32)
            diff = np.abs(g - w)
            assert (diff > 0).mean() <= MAX_DIFF_SHARE and diff.max() <= 1
    # the negative nu lane was clamped before use: finite, and only the
    # fresh g² term remains
    v = tstate["nu/w"][3, 7]
    assert torch.isfinite(tp["w"]).all() and 0.0 <= float(v) < 0.5


def test_adamw_init_layout():
    p = {"a": torch.zeros(3, 2, dtype=torch.bfloat16), "b": torch.zeros(5)}
    st = AdamW(lr=cosine_with_warmup(1e-3, 1, 10)).init(p)
    assert list(st) == ["step", "mu/a", "mu/b", "nu/a", "nu/b"]
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    assert st["mu/a"].dtype == torch.float32 and st["mu/a"].shape == (3, 2)


# ------------------------------------------------------------- the stream


def _cfgs():
    jcfg = dataclasses.replace(jget_config("qwen2-1.5b").reduced(), vocab=256)
    tcfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(), vocab=256)
    return jcfg, tcfg


def test_stream_is_pure_in_seed_and_step():
    _, tcfg = _cfgs()
    s = SyntheticStream(tcfg, seed=3, batch=4, seq=16, device="cpu")
    a, b = s(5)["tokens"], s(5)["tokens"]
    assert torch.equal(a, b)
    assert not torch.equal(a, s(6)["tokens"])
    other = SyntheticStream(tcfg, seed=4, batch=4, seq=16, device="cpu")
    assert not torch.equal(a, other(5)["tokens"])
    direct = batch_for_step(tcfg, 3, 5, batch=4, seq=16, device="cpu")
    assert torch.equal(a, direct["tokens"])


def test_stream_shapes_dtypes_and_structure_match_reference():
    jcfg, tcfg = _cfgs()
    jb = [np.asarray(JStream(jcfg, seed=0, batch=8, seq=64)(i)["tokens"])
          for i in range(4)]
    tb = [SyntheticStream(tcfg, seed=0, batch=8, seq=64, device="cpu")(i)
          ["tokens"].numpy() for i in range(4)]
    assert tb[0].shape == jb[0].shape == (8, 64)
    assert tb[0].dtype == jb[0].dtype == np.int32
    near = []
    for toks in (np.stack(jb), np.stack(tb)):
        assert toks.min() >= 0 and toks.max() < 256
        near.append((np.abs(toks[..., 1:] - toks[..., :-1]) <= 2).mean())
    assert abs(near[0] - near[1]) <= 0.05, near     # the n-gram repeat
    assert abs(np.mean(tb) - np.mean(jb)) <= 0.15 * np.mean(jb)


def test_host_slice_arithmetic_matches_reference():
    jcfg, tcfg = _cfgs()
    whole = SyntheticStream(tcfg, seed=1, batch=6, seq=8, device="cpu")(2)
    for index in range(3):
        ts = SyntheticStream(tcfg, seed=1, batch=6, seq=8, process_index=index,
                             process_count=3, device="cpu")
        js = JStream(jcfg, seed=1, batch=6, seq=8, process_index=index,
                     process_count=3)
        assert ts.host_batch == js.host_batch == 2
        want = js.host_slice({"tokens": jnp.asarray(whole["tokens"].numpy())})
        np.testing.assert_array_equal(ts(2)["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
    with pytest.raises(ValueError):
        SyntheticStream(tcfg, seed=1, batch=5, seq=8, process_count=2)


def test_stream_refuses_the_unported_families():
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="slice 5"):
        batch_for_step(dataclasses.replace(tcfg, family="audio"), 0, 0,
                       batch=2, seq=4, device="cpu")
