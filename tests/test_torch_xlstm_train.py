"""Port parity of xLSTM training against the JAX reference on the CPU, at
``get_config("xlstm-1.3b").reduced()`` (4 blocks: one group of 3 mLSTM + 1
sLSTM, d_model 128, chunk 16, f32, remat on): the stacked parameter
layout, ``train_state_from_jax``, the loss and every gradient, three
``train_loop`` steps in memory mode with planted faults (params, counts
and rule stats), repair off poisoned, and the serving paths on the stacked
layout.

Both packages start from the reference's ``init_train_state`` carried
across by ``convert.train_state_from_jax`` and see the reference's token
batches.  The reference's loss runs its ``_chunked_mlstm`` under
``jax.grad``; the port's runs the same function's twin under autograd.
Tolerances (f32, two summation orders): the loss within 1e-5 relative;
each gradient leaf within 1e-4 of its norm (relative L2; measured ≤ 6e-6).
After one step the moments are within 1e-5 of the leaf's largest |moment|;
the params are within 2 lr on every lane and each leaf's update within
1e-3 of the reference's (relative L2; measured ≤ 3.2e-4).  Adam divides by
the gradient's own scale, so a lane whose gradient is near eps or rounding
noise moves by up to ±lr in either package (``tests/test_torch_train.py``).
After three steps the xLSTM has amplified those lanes (``ROADMAP.md`` §3:
the xLSTM amplifies one ulp), so each leaf is held against a one-ulp
control: the reference's own run from params one ulp up.  The port's
distance to the reference stays within ``CONTROL_X`` times the control's
(measured: at most 1.05 times).
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
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.runtime import ApproxConfig as JApproxConfig  # noqa: E402
from repro.runtime import ApproxSpace as JApproxSpace  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.regions import flatten  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import XLSTMLM  # noqa: E402
from repro_torch.runtime import ApproxConfig, ApproxSpace  # noqa: E402

ARCH = "xlstm-1.3b"
BATCH, SEQ = 2, 32
LR = dict(peak_lr=3e-3, warmup=2, total=10)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
F32_MOMENT_TOL = 1e-5
UPDATE_TOL = 1e-3
CONTROL_X = 2.0
# (path, index, value) planted in both states before the first step
PLANTS = (("params/mlstm_groups/mlstm/w_q", (0, 1, 5, 9), float("nan")),
          ("params/slstm_layers/slstm/r", (0, 2, 3, 4), float("inf")),
          ("opt/nu/mlstm_groups/mlstm/w_up", (0, 0, 7, 11), float("nan")),
          ("opt/mu/embed/table", (3, 3), float("-inf")))


def cfgs(mode="memory", policy="zero"):
    kw = dict(mode=mode, policy=policy, max_magnitude=1e3)
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(),
                               repair=JApproxConfig(**kw))
    tcfg = dataclasses.replace(get_config(ARCH).reduced(),
                               repair=ApproxConfig(**kw))
    return jcfg, tcfg


def pair(**kw):
    jcfg, tcfg = cfgs(**kw)
    jm = jbuild_model(jcfg)
    jopt = jtrain.make_optimizer(**LR)
    jspace = JApproxSpace(jcfg.repair)
    js = jtrain.init_train_state(jm, jopt, jax.random.PRNGKey(0), space=jspace)
    tm, ts = convert.train_state_from_jax(jax.tree.map(np.asarray, js), tcfg,
                                          device="cpu")
    return (jm, jopt, jspace, js), (tm, ttrain.make_optimizer(**LR),
                                   ApproxSpace(tcfg.repair), ts)


def batches(jcfg, n):
    stream = JStream(jcfg, seed=0, batch=BATCH, seq=SEQ)
    return [np.asarray(stream(i)["tokens"]) for i in range(n)]


def jflat_state(js) -> dict:
    tree = {"params": js["params"],
            "opt": {"mu": js["opt"].mu, "nu": js["opt"].nu}}
    return flatten(jax.tree.map(np.asarray, tree))


def plant_both(js, ts, plants):
    """Set one lane of a leaf in both states."""
    for path, idx, value in plants:
        with torch.no_grad():
            ts[path][idx] = value
        head, *keys = path.split("/")
        if head == "params":
            root = js["params"]
        else:
            root = getattr(js["opt"], keys[0])
            keys = keys[1:]
        node = root
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = node[keys[-1]].at[idx].set(value)
    return js, ts


def rel_l2(got, want) -> float:
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def max_rel(got, want) -> float:
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


@pytest.fixture(scope="module")
def grads():
    """(reference loss, metrics, grads), (port loss, metrics, grads) of
    one batch from one init."""
    (jm, _, _, js), (tm, _, _, _) = pair()
    tokens = batches(jm.cfg, 1)[0]
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        js["params"], {"tokens": jnp.asarray(tokens)})
    tg = tm.bind_grads()
    loss, tmet = tm.loss({"tokens": torch.from_numpy(tokens)})
    loss.backward()
    return ((float(jl), jmet, flatten(jax.tree.map(np.asarray, jg))),
            (float(loss.detach()), tmet, {p: g.clone() for p, g in tg.items()}),
            (tm, tokens))


# ----------------------------------------------------------- the layout


def test_param_tree_is_the_reference_layout():
    """20 leaves under the reference's paths, in its order and shapes;
    each block's parameter is a view of its slot."""
    (_, _, _, js), (tm, _, _, ts) = pair()
    want = flatten(jax.tree.map(np.asarray, js["params"]))
    tree = tm.param_tree()
    assert list(tree) == list(want) and len(tree) == 20
    for path, arr in want.items():
        assert tuple(tree[path].shape) == arr.shape, path
        assert tree[path].is_contiguous()
    G, M = tm.n_groups, tm.m_per_group
    for g in range(G):
        for i in range(M):
            blk = tm.mblock(g, i)
            assert blk.mlstm.w_q.data_ptr() == \
                tree["mlstm_groups/mlstm/w_q"][g, i].data_ptr()
            assert blk.norm.scale.data_ptr() == \
                tree["mlstm_groups/norm/scale"][g, i].data_ptr()
        assert tm.slstm_layers[g].slstm.r.data_ptr() == \
            tree["slstm_layers/slstm/r"][g].data_ptr()


def test_train_state_from_jax_holds_the_models_tensors():
    (_, _, _, js), (tm, _, tspace, ts) = pair()
    want = jflat_state(js)
    tensors = {p for p, v in ts.items() if isinstance(v, torch.Tensor)}
    assert tensors == set(want) | {"opt/step"}
    for path, arr in want.items():
        assert tuple(ts[path].shape) == arr.shape, path
        np.testing.assert_array_equal(ts[path].detach().numpy(), arr)
    for path, t in tm.param_tree().items():
        assert ts[f"params/{path}"] is t
    assert ts["rule_counts"].shape == (tspace.ruleset.n_rules, 3)
    assert len([p for p in want if p.startswith("opt/")]) == 40


# ----------------------------------------------------- loss and gradients


def test_loss_matches_reference(grads):
    (jl, jmet, _), (tl, tmet, _), _ = grads
    assert abs(tl - jl) <= LOSS_TOL * abs(jl), (tl, jl)
    assert float(tmet["tokens"]) == float(jmet["tokens"]) == BATCH * (SEQ - 1)
    assert not tmet["loss"].requires_grad


def test_every_grad_matches_reference(grads):
    (_, _, jg), (_, _, tg), _ = grads
    assert list(tg) == list(jg) and len(tg) == 20
    for path, g in tg.items():
        assert g.shape == jg[path].shape, path
        assert rel_l2(g, jg[path]) <= GRAD_TOL, (path, rel_l2(g, jg[path]))


def test_remat_changes_no_gradient(grads):
    """Without remat the gradients are the same up to the order in which
    autograd sums a tensor's contributions."""
    _, (_, _, with_remat), (tm, tokens) = grads
    tm.cfg = dataclasses.replace(tm.cfg, remat=False)
    try:
        tg = tm.bind_grads()
        for g in tg.values():
            g.zero_()
        loss, _ = tm.loss({"tokens": torch.from_numpy(tokens)})
        loss.backward()
    finally:
        tm.cfg = dataclasses.replace(tm.cfg, remat=True)
    for path, g in tg.items():
        assert max_rel(g, with_remat[path].numpy()) <= 1e-6, path


def test_chunked_mlstm_grad_at_full_head_dim_matches_reference():
    """The train path's chunked mLSTM at xlstm-1.3b's head dim (4 heads of
    1024) over 256 tokens in chunks of 32, the chunk the card's train phase
    uses, with gates as the model draws them at init (forget gates near
    1/2, so the stabiliser m* grows ~0.7 a token of a chunk): every input's
    gradient finite and within 1e-4 of the reference's (relative L2).
    At chunks of 64 and 128 the reference's gradient is NaN on such gates
    (``ROADMAP.md`` §3)."""
    from repro.nn.xlstm import _chunked_mlstm as jchunked
    from repro_torch.nn.xlstm import _chunked_mlstm

    rng = np.random.default_rng(0)
    shape = (1, 256, 4, 1024)
    q, k, v = ((s * rng.standard_normal(shape)).astype(np.float32)
               for s in (1 / 32, 1.0, 1.0))
    li = (0.5 * rng.standard_normal(shape[:3])).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(0.5 * rng.standard_normal(shape[:3])),
                    np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    args = (q, k, v, li, lf)
    jg = jax.grad(lambda *a: jnp.sum(jchunked(*a, chunk=32) * w),
                  argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    (_chunked_mlstm(*ts, chunk=32) * torch.from_numpy(w)).sum().backward()
    for name, t, g in zip(("q", "k", "v", "log_i", "log_f"), ts, jg):
        assert np.isfinite(np.asarray(g)).all(), name
        assert torch.isfinite(t.grad).all(), name
        assert rel_l2(t.grad, g) <= GRAD_TOL, (name, rel_l2(t.grad, g))


# ------------------------------------------------------------- train steps


def _three_steps(jm, jopt, jspace, js, toks):
    return jtrain.train_loop(
        jm, jopt, lambda i: {"tokens": jnp.asarray(toks[i])}, steps=3,
        key=jax.random.PRNGKey(0), state=js, space=jspace, log_every=1)


def test_three_train_loop_steps_with_plants_match_reference():
    """Faults planted in weights and moments before step 0: the boundary
    scrub counts them as the reference's does (stats and rule stats
    equal), and after three steps every param and moment leaf is as close
    to the reference's as the reference's own one-ulp control."""
    (jm, jopt, jspace, js), (tm, topt, tspace, ts) = pair()
    js, ts = plant_both(js, ts, PLANTS)
    toks = batches(jm.cfg, 3)
    ulp_up = {**js, "params": jax.tree.map(
        lambda x: jnp.asarray(np.nextafter(np.asarray(x), np.float32(np.inf))),
        js["params"])}
    jstate, jhist = _three_steps(jm, jopt, jspace, js, toks)
    tstate, thist = ttrain.train_loop(
        tm, topt, lambda i: {"tokens": torch.from_numpy(toks[i])}, steps=3,
        state=ts, space=tspace, log_every=1)
    for jh, th in zip(jhist, thist):
        assert abs(th["loss"] - jh["loss"]) <= LOSS_TOL * abs(jh["loss"])
    assert tstate["stats"] == {k: int(v) for k, v in jstate["stats"].items()}
    assert tstate["stats"]["nan_found"] == 2 and tstate["stats"]["inf_found"] == 2
    assert tspace.rule_stats() == jspace.rule_stats()
    assert tspace.stats_dict() == jspace.stats_dict()
    ctrl = jflat_state(_three_steps(jm, jopt, JApproxSpace(jm.cfg.repair),
                                    ulp_up, toks)[0])
    for path, w in jflat_state(jstate).items():
        got = tstate[path].detach().numpy()
        assert np.isfinite(got).all(), path
        d_port = np.linalg.norm(got - w)
        d_ctrl = np.linalg.norm(ctrl[path] - w)
        assert d_ctrl <= 1e-2 * np.linalg.norm(w), (path, d_ctrl)
        assert d_port <= CONTROL_X * d_ctrl + 1e-6 * np.linalg.norm(w), \
            (path, d_port, d_ctrl)


@pytest.mark.parametrize("n_micro", [2])
def test_n_micro_matches_one_batch(n_micro):
    """Two microbatches of one batch: the step's loss, moments and update
    against the reference's ``n_micro`` step."""
    (jm, jopt, jspace, js), (tm, topt, tspace, ts) = pair()
    p0 = {p: t.detach().numpy().copy() for p, t in ts.items()
          if p.startswith("params/")}
    tokens = batches(jm.cfg, 1)[0]
    jstep = jax.jit(jtrain.build_train_step(jm, jopt, n_micro=n_micro,
                                            space=jspace))
    js, jmet = jstep(js, {"tokens": jnp.asarray(tokens)})
    tstep = ttrain.build_train_step(tm, topt, n_micro=n_micro, space=tspace)
    ts, tmet = tstep(ts, {"tokens": torch.from_numpy(tokens)})
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= \
        LOSS_TOL * abs(float(jmet["loss"]))
    lr = float(jmet["lr"])
    for path, w in jflat_state(js).items():
        got = ts[path]
        if path.startswith("opt/"):
            assert max_rel(got, w) <= F32_MOMENT_TOL, (path, max_rel(got, w))
            continue
        got = got.detach().numpy()
        assert np.abs(got - w).max() <= 2 * lr, path
        base = p0[path]
        if np.any(w != base):
            upd = np.linalg.norm((got - base) - (w - base)) / \
                np.linalg.norm(w - base)
            assert upd <= UPDATE_TOL, (path, upd)


def test_repair_off_is_poisoned():
    """The same plants with repair off: the first step's loss or the
    params are no longer finite."""
    (jm, _, _, _), (tm, topt, tspace, ts) = pair(mode="off")
    with torch.no_grad():
        for path, idx, value in PLANTS:
            ts[path][idx] = value
    tokens = batches(jm.cfg, 1)[0]
    state, metrics = ttrain.build_train_step(tm, topt, space=tspace)(
        ts, {"tokens": torch.from_numpy(tokens)})
    finite = all(bool(torch.isfinite(t).all()) for p, t in state.items()
                 if p.startswith("params/"))
    assert not np.isfinite(float(metrics["loss"])) or not finite


# ------------------------------------------- serving on the stacked layout


def test_serving_paths_match_reference_on_the_stacked_layout():
    """``forward`` (the kernel's plain version in every mLSTM block, zero
    counts), ``serve_step`` and ``generate`` on the stacked layout: logits
    as the reference's, tokens and stats equal; a write into a stacked
    slot is what the block reads."""
    jcfg, tcfg = cfgs()
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                 device="cpu")
    assert isinstance(tm, XLSTMLM)
    tokens = np.random.default_rng(1).integers(0, 512, (2, 32)).astype(np.int32)
    want = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(tokens)}))
    got, counts = tm(torch.from_numpy(tokens), with_counts=True)
    assert counts.tolist() == [0] * 8 and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    prompt = tokens[:, :8]
    kw = dict(max_new=6, max_seq=16, scrub_every=4)
    jtok, jst = jserve.generate(jm, jp, jnp.asarray(prompt), **kw)
    ttok, tst = serve.generate(tm, torch.from_numpy(prompt), **kw)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert tst == jst
    with torch.no_grad():
        tm.param_tree()["mlstm_groups/mlstm/w_down"][0, 1].zero_()
    assert not bool(tm.mblock(0, 1).mlstm.w_down.any())
