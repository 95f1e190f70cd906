"""Port parity of training (``repro_torch.launch.train`` and what it runs)
against the JAX reference on the CPU: the loss, ``matmul_f32``'s backward,
the model's loss and every gradient, three train steps (``n_micro`` 1 and
2), the boundary scrub's counts under planted faults, register mode, and
the paper's end-to-end claim (repair off poisons a run, NaN/Inf-only
repair is not enough, memory mode with the range guard survives it).

Both packages start from the same state: the reference's
``init_train_state`` carried across by ``convert.train_state_from_jax``,
and the reference's token batches fed to both as numpy (the port's
synthetic stream cannot draw threefry's bits).  The model is
``qwen2-1.5b.reduced()`` with 2 layers and vocab 256.

Tolerances, each measured against what the two summation orders give:

* f32 gradients: every lane within 1e-5 of the leaf's largest |grad|
  (measured: 1.3e-6);
* bf16 gradients: the relative L2 error of each leaf under 3e-2, where the
  reference's own bf16 gradient differs from its f32 one by more (the
  control);
* f32 state after three steps: moments within 1e-5 of the leaf's largest
  |moment|; params within 2 % of the summed learning rates — Adam divides
  by the gradient's own scale, so a lane whose gradient is rounding noise
  (``attn/bk``: adding a constant to every key score changes nothing, so
  its gradient is 0 in exact arithmetic) moves by ±lr in either package;
* bf16 state after three steps: moments within 3e-2 (relative L2); every
  param lane within twice the summed learning rates plus one bf16 ulp
  (updates of opposite sign, then a rounding), and each leaf's update
  (params after minus before) within 10 % relative L2 of the reference's
  (measured: at most 6.7 %) — except ``NOISE_LEAVES`` and leaves whose
  update the reference rounds away on most lanes (the norm scales at 1.0,
  where three updates of at most 3.6e-3 stay under half of bf16's ulp).
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import rules as jrules  # noqa: E402
from repro.data import SyntheticStream as JStream  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import base as jbase  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.runtime import ApproxConfig as JApproxConfig  # noqa: E402
from repro.runtime import ApproxSpace as JApproxSpace  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import rules as trules  # noqa: E402
from repro_torch.core.regions import flatten  # noqa: E402
from repro_torch.data import SyntheticStream  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import base as tbase  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.nn.layers import matmul_f32  # noqa: E402
from repro_torch.runtime import ApproxConfig, ApproxSpace  # noqa: E402

WIDTHS = dict(n_layers=2, vocab=256)
BATCH, SEQ = 8, 32
LR = dict(peak_lr=3e-3, warmup=5, total=30)
F32_GRAD_TOL = 1e-5
BF16_GRAD_TOL = 3e-2
F32_MOMENT_TOL = 1e-5
F32_PARAM_LR_SHARE = 2e-2
BF16_PARAM_LR_SHARE = 1e-1
MAX_DIFF_SHARE = 1e-3       # bf16 lanes that may differ by summation order
# gradients that are 0 in exact arithmetic (a key bias adds one constant to
# every score of a row), so any two roundings of them are noise
NOISE_LEAVES = ("layers/attn/bk",)
REMAT_TOL = 1e-6
BF16_UPDATE_TOL = 0.1       # relative L2 error of a bf16 leaf's 3-step update


def cfgs(dtype="float32", mode="memory", policy="zero", rules=None,
         max_magnitude=1e3):
    kw = dict(mode=mode, policy=policy, max_magnitude=max_magnitude)
    jrep = JApproxConfig(**kw, rules=rules[0] if rules else None)
    trep = ApproxConfig(**kw, rules=rules[1] if rules else None)
    jcfg = dataclasses.replace(jget_config("qwen2-1.5b").reduced(), **WIDTHS,
                               dtype_name=dtype, repair=jrep)
    tcfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(), **WIDTHS,
                               dtype_name=dtype, repair=trep)
    return jcfg, tcfg


def pair(dtype="float32", **kw):
    """(reference model, optimizer, space, state) and (port model,
    optimizer, space, state) from one reference init."""
    jcfg, tcfg = cfgs(dtype, **kw)
    jm = jbuild_model(jcfg)
    jopt = jtrain.make_optimizer(**LR)
    jspace = JApproxSpace(jcfg.repair)
    js = jtrain.init_train_state(jm, jopt, jax.random.PRNGKey(0), space=jspace)
    tm, ts = convert.train_state_from_jax(jax.tree.map(np.asarray, js), tcfg,
                                          device="cpu")
    tspace = ApproxSpace(tcfg.repair)
    return (jm, jopt, jspace, js), (tm, ttrain.make_optimizer(**LR), tspace, ts)


def batches(jcfg, n):
    stream = JStream(jcfg, seed=0, batch=BATCH, seq=SEQ)
    return [np.asarray(stream(i)["tokens"]) for i in range(n)]


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def max_rel(got, want) -> float:
    g, w = as_f32(got), as_f32(want)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def rel_l2(got, want) -> float:
    g, w = as_f32(got), as_f32(want)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def jflat_state(js) -> dict:
    """The reference state's float leaves under the port's flat paths."""
    tree = {"params": js["params"],
            "opt": {"mu": js["opt"].mu, "nu": js["opt"].nu}}
    return flatten(jax.tree.map(np.asarray, tree))


def port_grads(tm, tokens):
    grads = tm.bind_grads()
    for g in grads.values():
        g.zero_()
    loss, metrics = tm.loss({"tokens": torch.from_numpy(np.array(tokens))})
    loss.backward()
    return loss.detach(), metrics, grads


# ------------------------------------------------------------------ the loss


@pytest.mark.parametrize("masked", [False, True], ids=["all", "mask"])
def test_next_token_loss_matches_reference(masked):
    """Loss, accuracy and token count on the same logits, within f32
    rounding (logsumexp sums in another order)."""
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 17, 41))).astype(np.float32)
    tokens = rng.integers(0, 41, (3, 17)).astype(np.int32)
    mask = (rng.random((3, 17)) < 0.6) if masked else None
    jl, jm = jbase.next_token_loss(jnp.asarray(logits), jnp.asarray(tokens),
                                   None if mask is None else jnp.asarray(mask))
    tl, tm = tbase.next_token_loss(
        torch.from_numpy(logits), torch.from_numpy(tokens),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for k in ("loss", "accuracy", "tokens"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    if masked:
        assert float(tm["tokens"]) == float(mask[:, 1:].sum())


# ----------------------------------------------------- matmul_f32's backward


def _ordered(bits: np.ndarray) -> np.ndarray:
    i = bits.astype(np.int32)
    return np.where(i < 0, -(i & 0x7FFF), i)


def bf16_bar(got: torch.Tensor, want) -> tuple:
    """(share of lanes that differ, largest distance in bf16 ulps)."""
    g = _ordered(got.detach().view(torch.int16).numpy())
    w = _ordered(np.asarray(want).view(np.int16))
    dist = np.abs(g - w)
    return float((dist > 0).mean()), int(dist.max())


def test_matmul_f32_backward_keeps_the_f32_cotangent():
    """dA and dB in bf16 against ``jax.vjp`` of the reference's product
    (``preferred_element_type=f32``) with an f32 cotangent: at most 0.1 %
    of lanes differ, none by more than one ulp.  The control rounds the
    cotangent to bf16 first, and the bar must refuse it."""
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.standard_normal((2, 48, 128)), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((128, 96)) / 8, jnp.bfloat16)
    g = jnp.asarray(rng.standard_normal((2, 48, 96)), jnp.float32)

    def ref(x, w):
        return jnp.einsum("...i,io->...o", x, w,
                          preferred_element_type=jnp.float32)

    _, vjp = jax.vjp(ref, a, b)
    ja, jb = vjp(g)
    ta = convert.to_torch(np.asarray(a)).requires_grad_(True)
    tb = convert.to_torch(np.asarray(b)).requires_grad_(True)
    tg = torch.from_numpy(np.array(g))
    out = matmul_f32(ta, tb)
    assert out.dtype == torch.float32
    out.backward(tg)
    assert ta.grad.dtype == tb.grad.dtype == torch.bfloat16
    for got, want in ((ta.grad, ja), (tb.grad, jb)):
        share, ulps = bf16_bar(got, want)
        assert share <= MAX_DIFF_SHARE and ulps <= 1, (share, ulps)
    g16 = tg.to(torch.bfloat16)
    ctrl_a = torch.matmul(g16, tb.detach().t())
    ctrl_b = torch.matmul(ta.detach().reshape(-1, 128).t(), g16.reshape(-1, 96))
    for got, want in ((ctrl_a, ja), (ctrl_b, jb)):
        share, ulps = bf16_bar(got, want)
        assert share > MAX_DIFF_SHARE or ulps > 1, (share, ulps)


def test_matmul_f32_without_grad_is_the_plain_product():
    a = torch.randn(4, 8).to(torch.bfloat16)
    b = torch.randn(8, 3).to(torch.bfloat16)
    torch.testing.assert_close(matmul_f32(a, b), a.float() @ b.float(),
                               rtol=0, atol=0)


# ------------------------------------------------------- loss and gradients


@pytest.fixture(scope="module")
def grads_by_dtype():
    """{dtype: (reference loss, grads), (port loss, grads)} at step 0."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        (jm, _, _, js), (tm, _, _, _) = pair(dtype)
        tokens = batches(jm.cfg, 1)[0]
        (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
            js["params"], {"tokens": jnp.asarray(tokens)})
        tl, tmet, tg = port_grads(tm, tokens)
        out[dtype] = ((float(jl), jmet, flatten(jax.tree.map(np.asarray, jg))),
                      (float(tl), tmet, {p: g.clone() for p, g in tg.items()}))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_metrics_match_reference(grads_by_dtype, dtype):
    (jl, jmet, _), (tl, tmet, _) = grads_by_dtype[dtype]
    np.testing.assert_allclose(tl, jl, rtol=1e-6 if dtype == "float32" else 1e-4)
    assert float(tmet["tokens"]) == float(jmet["tokens"]) == BATCH * (SEQ - 1)
    np.testing.assert_allclose(float(tmet["accuracy"]), float(jmet["accuracy"]),
                               atol=2.0 / (BATCH * SEQ))


def test_every_f32_grad_matches_reference(grads_by_dtype):
    (_, _, jg), (_, _, tg) = grads_by_dtype["float32"]
    assert set(jg) == set(tg) and len(tg) == 14
    for path, g in tg.items():
        assert g.shape == jg[path].shape, path
        assert max_rel(g, jg[path]) <= F32_GRAD_TOL, (path, max_rel(g, jg[path]))


def test_every_bf16_grad_matches_reference(grads_by_dtype):
    """Each leaf within BF16_GRAD_TOL (relative L2), and each leaf with a
    gradient (all but ``NOISE_LEAVES``) closer to the reference's bf16
    gradient than that is to its f32 gradient."""
    (_, _, jg), (_, _, tg) = grads_by_dtype["bfloat16"]
    (_, _, jg32), _ = grads_by_dtype["float32"]
    for path, g in tg.items():
        assert g.dtype == torch.bfloat16, path
        err, ctrl = rel_l2(g, jg[path]), rel_l2(jg32[path], jg[path])
        assert err <= BF16_GRAD_TOL, (path, err)
        if path not in NOISE_LEAVES:
            assert err < ctrl, (path, err, ctrl)


def test_remat_changes_no_gradient():
    """Recomputing each block in the backward changes the gradients only by
    the order in which autograd sums a tensor's contributions (the q, k
    and v paths into a block's normed input)."""
    (jm, _, _, js), (tm, _, _, _) = pair("float32")
    tokens = batches(jm.cfg, 1)[0]
    _, _, with_remat = port_grads(tm, tokens)
    with_remat = {p: g.clone() for p, g in with_remat.items()}
    tm.cfg = dataclasses.replace(tm.cfg, remat=False)
    _, _, without = port_grads(tm, tokens)
    for p in with_remat:
        assert max_rel(with_remat[p], without[p]) <= REMAT_TOL, p


def test_serving_forward_stays_out_of_autograd():
    _, (tm, _, _, _) = pair("float32")
    tm.bind_grads()
    out = tm(torch.zeros(1, 8, dtype=torch.long))
    assert not out.requires_grad


# ------------------------------------------------------------ train steps


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_reference(dtype, n_micro):
    (jm, jopt, jspace, js), (tm, topt, tspace, ts) = pair(dtype)
    jstep = jax.jit(jtrain.build_train_step(jm, jopt, n_micro=n_micro,
                                            space=jspace))
    tstep = ttrain.build_train_step(tm, topt, n_micro=n_micro, space=tspace)
    p0 = {p: as_f32(t) for p, t in ts.items() if p.startswith("params/")}
    lrs = []
    for tokens in batches(jm.cfg, 3):
        js, jmet = jstep(js, {"tokens": jnp.asarray(tokens)})
        ts, tmet = tstep(ts, {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-6 if dtype == "float32" else 1e-4)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]),
                                   rtol=1e-5 if dtype == "float32" else 2e-3)
        np.testing.assert_allclose(float(tmet["lr"]), float(jmet["lr"]),
                                   rtol=2e-7)
        lrs.append(float(jmet["lr"]))
    assert int(ts["opt/step"]) == int(js["opt"].step) == 3
    assert ts["opt/step"].dtype == torch.int32
    want = jflat_state(js)
    for path, w in want.items():
        got = ts[path]
        assert tuple(got.shape) == w.shape, path
        if path.startswith("opt/"):
            assert got.dtype == torch.float32
            if dtype == "float32":
                assert max_rel(got, w) <= F32_MOMENT_TOL, (path, max_rel(got, w))
            else:
                assert rel_l2(got, w) <= BF16_GRAD_TOL, (path, rel_l2(got, w))
            continue
        err = np.abs(as_f32(got) - as_f32(w))
        if dtype == "float32":
            assert err.max() <= F32_PARAM_LR_SHARE * sum(lrs), (path, err.max())
            continue
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(as_f32(w)), 1e-30))) - 7)
        assert (err <= 2 * sum(lrs) + ulp).all(), path
        moved = as_f32(w) != p0[path]
        if path[7:] not in NOISE_LEAVES and moved.mean() >= 0.5:
            upd = rel_l2(as_f32(got) - p0[path], as_f32(w) - p0[path])
            assert upd <= BF16_UPDATE_TOL, (path, upd)
    assert ts["stats"] == {k: int(v) for k, v in js["stats"].items()}


# ------------------------------------------------- the boundary scrub's counts


def _rulesets():
    """Moments under a NaN/Inf rule with a zero fill, weights under a
    range guard with a constant fill, the rest under the default rule."""
    pats = (
        ("opt/.*", dict(detect=dict(nan=True, inf=True), fill="zero",
                        label="moments")),
        ("params/layers/mlp/.*", dict(detect=dict(max_magnitude=1e3),
                                      fill=0.5, label="mlp")),
    )

    def build(mod):
        return mod.RuleSet(tuple(
            (p, mod.RepairRule(detect=mod.Detector(**r["detect"]),
                               fill=r["fill"], label=r["label"]))
            for p, r in pats))

    return build(jrules), build(trules)


PLANTS = (  # (path, flat lane, value) before each of the three steps
    (("params/layers/mlp/w_down", 5, float("nan")),
     ("opt/nu/embed/table", 17, float("inf"))),
    (),
    (("params/layers/mlp/w_gate", 301, -3e4),
     ("opt/mu/layers/attn/wq", 9, float("nan")),
     ("params/embed/table", 4, float("-inf"))),
)


def _plant_both(js, ts, plants):
    """Set one flat lane of a leaf to ``value`` in both states (the
    reference's nested dicts are updated in place)."""
    for path, lane, value in plants:
        with torch.no_grad():
            ts[path].view(-1)[lane] = value
        head, *keys = path.split("/")
        if head == "params":
            node = js["params"]
        else:
            node, keys = getattr(js["opt"], keys[0]), keys[1:]
        for k in keys[:-1]:
            node = node[k]
        leaf = node[keys[-1]]
        node[keys[-1]] = leaf.reshape(-1).at[lane].set(value).reshape(leaf.shape)
    return js, ts


def test_memory_mode_boundary_scrub_counts_equal_reference():
    """Faults planted in params and moments before steps 1 and 3: the
    state's stats and the space's rule ledger equal the reference's bit for
    bit, and every repaired lane holds its rule's fill."""
    (jm, jopt, jspace, js), (tm, topt, tspace, ts) = pair(
        "float32", rules=_rulesets())
    jstep = jax.jit(jtrain.build_train_step(jm, jopt, space=jspace))
    tstep = ttrain.build_train_step(tm, topt, space=tspace)
    for plants, tokens in zip(PLANTS, batches(jm.cfg, 3)):
        js, ts = _plant_both(js, ts, plants)
        js, _ = jstep(js, {"tokens": jnp.asarray(tokens)})
        ts, tmet = tstep(ts, {"tokens": torch.from_numpy(tokens)})
        assert np.isfinite(float(tmet["loss"]))
        assert ts["stats"] == {k: int(v) for k, v in js["stats"].items()}
        np.testing.assert_array_equal(ts["rule_counts"],
                                      np.asarray(js["rule_counts"]))
    assert ts["stats"]["nan_found"] == 2 and ts["stats"]["inf_found"] == 3
    assert ts["stats"]["events"] == 2
    js = jtrain._fold_rule_counts(jspace, js)
    ts = ttrain._fold_rule_counts(tspace, ts)
    assert tspace.rule_stats() == jspace.rule_stats()
    assert tspace.rule_stats()["moments"]["nan_found"] == 1
    assert not ts["rule_counts"].any()
    for path in ("params/layers/mlp/w_down", "params/layers/mlp/w_gate",
                 "opt/nu/embed/table", "params/embed/table"):
        assert torch.isfinite(ts[path]).all(), path


def test_register_mode_grads_stay_finite_with_a_nan_weight():
    """A NaN lane in one weight: register mode repairs it at every read, so
    the loss and every gradient are finite and equal the reference's
    within the f32 bar; the stored lane stays NaN (register mode never
    writes back)."""
    (jm, _, _, js), (tm, _, _, ts) = pair("float32", mode="register",
                                          policy="zero")
    path, lane = "params/layers/mlp/w_up", 77
    js, ts = _plant_both(js, ts, ((path, lane, float("nan")),))
    tokens = batches(jm.cfg, 1)[0]
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        js["params"], {"tokens": jnp.asarray(tokens)})
    tl, _, tg = port_grads(tm, tokens)
    assert np.isfinite(float(tl))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    jg = flatten(jax.tree.map(np.asarray, jg))
    for p, g in tg.items():
        assert torch.isfinite(g).all(), p
        assert max_rel(g, jg[p]) <= F32_GRAD_TOL, (p, max_rel(g, jg[p]))
    assert torch.isnan(ts[path].view(-1)[lane])


def test_train_state_layout_matches_reference():
    (jm, _, jspace, js), (tm, _, tspace, ts) = pair("bfloat16")
    want = jflat_state(js)
    tensors = {p for p, v in ts.items() if isinstance(v, torch.Tensor)}
    assert tensors == set(want) | {"opt/step"}
    for p, w in want.items():
        assert tuple(ts[p].shape) == w.shape, p
    assert ts["params/layers/attn/wq"].shape[0] == 2
    assert ts["rule_counts"].shape == (tspace.ruleset.n_rules, 3)
    # the state's params are the model's own bytes
    assert ts["params/layers/mlp/w_up"][1].data_ptr() == \
        tm.layers[1].mlp.w_up.data_ptr()
    regions = tspace.regions_for(ttrain.resident(ts))
    assert regions["opt/step"].value == "exact"
    assert regions["opt/nu/embed/table"].value == "approx"


def test_train_loop_refuses_what_is_not_ported():
    """Meshes (slice 6) and register mode on the xLSTM (slice 5) still
    raise; the checkpoint manager and xLSTM training are ported
    (``tests/test_torch_checkpoint.py``, ``tests/test_torch_xlstm_train.py``)."""
    _, (tm, topt, _, _) = pair("float32")
    with pytest.raises(NotImplementedError, match="slice 6"):
        ttrain.train_loop(tm, topt, lambda i: None, steps=1, mesh=object())
    xcfg = dataclasses.replace(get_config("xlstm-1.3b").reduced(),
                               repair=ApproxConfig(mode="register"))
    with pytest.raises(NotImplementedError, match="slice 5"):
        build_model(xcfg, device="cpu")


# ---------------------------------------- the paper's claim, end to end


def e2e_run(mode, steps=30, ber=2e-6, seed=0, max_magnitude=1e3):
    """The twin of tests/test_e2e_training.py's ``run``: the same config
    (neighbor_mean fill, range guard 1e3), BER, batch and steps, the
    port's own stream and injection."""
    _, tcfg = cfgs("float32", mode=mode, policy="neighbor_mean",
                   max_magnitude=max_magnitude)
    model = build_model(tcfg, device="cpu", seed=seed)
    opt = ttrain.make_optimizer(peak_lr=3e-3, warmup=5, total=steps)
    data = SyntheticStream(tcfg, seed=seed, batch=BATCH, seq=SEQ, device="cpu")
    return ttrain.train_loop(model, opt, data, steps=steps, seed=seed, ber=ber,
                             log_every=max(steps // 10, 1))


def _all_finite(state) -> bool:
    return all(bool(torch.isfinite(t).all()) for p, t in state.items()
               if p.startswith("params/"))


def test_training_without_repair_gets_poisoned():
    state, hist = e2e_run("off")
    assert any(not np.isfinite(h["loss"]) for h in hist) or not _all_finite(state)


def test_nan_only_repair_is_insufficient_for_training():
    """The paper-faithful NaN/Inf-only repair (no range guard) does not
    survive sustained-BER training: a finite ~1e38 flip explodes the run."""
    state, hist = e2e_run("memory", max_magnitude=None)
    assert any(not np.isfinite(h["loss"]) or h["loss"] > 1e3 for h in hist) \
        or not _all_finite(state)


def test_training_with_memory_repair_converges():
    state, hist = e2e_run("memory")
    losses = [h["loss"] for h in hist]
    assert all(np.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]
    assert hist[-1]["nan_found"] + hist[-1]["inf_found"] > 0
    assert hist[-1]["flips"] > 0
    assert _all_finite(state)
