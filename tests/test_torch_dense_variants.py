"""Port parity of the dense variants — LayerNorm, the GeLU MLP with biases
and the untied head — on tiny twins of StarCoder2-15B (LayerNorm, GeLU,
QKV bias, GQA, untied), StableLM-1.6B (LayerNorm, SwiGLU, 25 % rotary, MHA,
untied) and Mistral-Large-123B (RMSNorm, SwiGLU, GQA, untied), with the
reference's parameters carried across by ``params_from_jax`` after every
bias and LayerNorm parameter was drawn nonzero (the init leaves them at 0
and 1, where a dropped one would pass unseen).  Counts are exact; floats
agree within rtol = atol = 1e-4 (f32; the two packages sum the products
in different orders, and two layers compound it), the modules within
1e-5.  Also the small public helpers of ``core`` and the deprecated
shims, each against the reference on the same numpy inputs."""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import detect as jdetect  # noqa: E402
from repro.core import injection as jinjection  # noqa: E402
from repro.core import regions as jregions  # noqa: E402
from repro.core import repair as jrepair  # noqa: E402
from repro.core import rules as jrules  # noqa: E402
from repro.core import stats as jstats  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.nn import layers as jlayers  # noqa: E402
from repro.nn import mlp as jmlp  # noqa: E402
from repro.runtime import ApproxConfig as JApproxConfig  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServingConfig as JServingConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import detect, injection, regions, repair, rules  # noqa: E402
from repro_torch.core import stats as stats_lib  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.nn.layers import LayerNorm  # noqa: E402
from repro_torch.nn.mlp import GeluMLP  # noqa: E402
from repro_torch.runtime import ApproxConfig  # noqa: E402
from repro_torch.serving import Engine, ServingConfig  # noqa: E402
from test_torch_engine import CASES, _plant  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("starcoder2-15b", "stablelm-1.6b", "mistral-large-123b")
# the MoE twins (tests/test_torch_moe.py) share the config and layout checks
MOE_ARCHS = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")
P, PG, M = 9, 4, 4
# the parameters the init leaves at 0 or 1: every bias, every norm scale
_DRAWN = ("/bias", "/scale", "/b_up", "/b_down", "/bq", "/bk", "/bv")


def _twin(get, arch, approx, **over):
    """``arch``'s tiny twin in one package: 2 layers, d_model 64, 4 heads of
    16, vocab 97, repair off, no recompute in the backward (one compile
    less for the reference's gradient); its norm, MLP, biases, rotary
    fraction, tying and MHA or GQA kept."""
    cfg = get(arch)
    return dataclasses.replace(
        cfg.reduced(), n_layers=2, d_model=64, n_heads=4,
        n_kv=4 if cfg.n_kv == cfg.n_heads else 2, head_dim=16, d_ff=128,
        vocab=97, repair=approx(mode="off"), remat=False, **over)


def tiny_cfg(arch, **over):
    return _twin(get_config, arch, ApproxConfig, **over)


def jtiny_cfg(arch, **over):
    return _twin(jget_config, arch, JApproxConfig, **over)


def _drawn_params(jm, seed):
    """The reference's params with every bias and norm parameter drawn from
    seeded normals (scales around 1, biases around 0)."""
    params = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in flat:
        name = "/" + "/".join(str(k.key) for k in path)
        if name.endswith(_DRAWN):
            draw = rng.standard_normal(leaf.shape).astype(leaf.dtype)
            leaf[...] = (1.0 + 0.3 * draw) if name.endswith("/scale") else 0.3 * draw
    return params


@pytest.fixture(scope="module")
def twins():
    """Each arch's reference model, its params and the port's model, built
    once for the module."""
    out = {}
    for i, arch in enumerate(ARCHS + MOE_ARCHS):
        jm = jbuild_model(jtiny_cfg(arch))
        jp = _drawn_params(jm, i)
        tm = convert.params_from_jax(jp, tiny_cfg(arch), device="cpu")
        out[arch] = (jm, jax.tree.map(jnp.asarray, jp), tm)
    return out


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(1, 97, size=shape).astype(np.int32)


# ------------------------------------------------------------------ modules

def test_layernorm_matches_reference():
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((2, 5, 64)) + 1.5).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(64)).astype(np.float32)
    want = jlayers.LayerNorm(64, dtype=jnp.float32)(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x))
    ln = LayerNorm(64, dtype=torch.float32, device="cpu")
    assert ln.eps == 1e-5
    ln.scale.copy_(torch.from_numpy(scale))
    ln.bias.copy_(torch.from_numpy(bias))
    np.testing.assert_allclose(ln(torch.from_numpy(x)).numpy(), np.asarray(want),
                               **MODULE_TOL)


def test_gelu_mlp_matches_reference():
    """Inputs in [-4, 4] through the identity-like up projection: GeLU's
    erf form differs from the reference's tanh form by up to ~5e-4
    there, so only the tanh form passes."""
    rng = np.random.default_rng(1)
    D, F = 32, 64
    x = rng.uniform(-4.0, 4.0, (2, 3, D)).astype(np.float32)
    p = {"w_up": np.eye(D, F, dtype=np.float32) + 0.01 * rng.standard_normal(
            (D, F)).astype(np.float32),
         "w_down": (rng.standard_normal((F, D)) / 8).astype(np.float32),
         "b_up": (0.3 * rng.standard_normal(F)).astype(np.float32),
         "b_down": (0.3 * rng.standard_normal(D)).astype(np.float32)}
    want = jmlp.GeluMLP(D, F, dtype=jnp.float32)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    mlp = GeluMLP(D, F, dtype=torch.float32, device="cpu")
    assert {n for n, _ in mlp.named_parameters()} == set(p)
    for k, v in p.items():
        getattr(mlp, k).copy_(torch.from_numpy(v))
    got = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)
    # the control: the erf form is outside the tolerance on these inputs
    h = torch.from_numpy(x) @ mlp.w_up + mlp.b_up
    erf = torch.nn.functional.gelu(h) @ mlp.w_down + mlp.b_down
    assert not np.allclose(erf.numpy(), np.asarray(want), **MODULE_TOL)


# -------------------------------------------------------------- the models

def test_configs_copy_the_reference():
    """Every field the port's ``ArchConfig`` has, full and reduced."""
    fields = [f.name for f in dataclasses.fields(get_config("qwen2-1.5b"))
              if f.name != "repair"]
    for arch in ARCHS + MOE_ARCHS:
        for mine, ref in ((get_config(arch), jget_config(arch)),
                          (get_config(arch).reduced(), jget_config(arch).reduced())):
            for f in fields:
                assert getattr(mine, f) == getattr(ref, f), (arch, f)
    assert get_config("stablelm-1.6b").reduced().n_kv == 4      # MHA stays MHA


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_param_tree_matches_reference_paths(twins, arch):
    jm, jp, tm = twins[arch]
    flat = regions.flatten(jax.tree.map(np.asarray, jp))
    tree = tm.param_tree()
    assert list(tree) == list(flat)
    for path, leaf in tree.items():
        np.testing.assert_array_equal(leaf.numpy(), flat[path])
    assert ("lm_head/w" in tree) and ("embed/table" in tree)
    cfg = tm.cfg
    assert ("final_norm/bias" in tree) == (cfg.norm == "ln")
    assert ("layers/mlp/b_up" in tree) == (cfg.mlp == "gelu" and not cfg.n_experts)
    assert ("layers/mlp/router/w" in tree) == bool(cfg.n_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(twins, arch):
    jm, jp, tm = twins[arch]
    tokens = _tokens((2, 12), 2)
    want = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(tokens)})
    got = tm(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_dense_cache_matches_reference(twins, arch):
    """A batched prefill at pos 0, then a decode at per-request positions:
    logits and the cache."""
    jm, jp, tm = twins[arch]
    B, T = 2, 16
    jc, tc = jm.init_cache(B, T), tm.init_cache(B, T)
    step = jax.jit(jm.serve_step)
    prompt = _tokens((B, 6), 3)
    jl, jc = step(jp, jc, {"tokens": jnp.asarray(prompt)}, jnp.int32(0))
    tl, tc = tm.serve_step(tc, torch.from_numpy(prompt), 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    pos, tok = np.array([6, 9], np.int32), _tokens((B, 1), 4)
    jl, jc = step(jp, jc, {"tokens": jnp.asarray(tok)}, jnp.asarray(pos))
    tl, tc = tm.serve_step(tc, torch.from_numpy(tok), torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    got = convert.cache_to_numpy(tc)
    for name in ("k", "v"):
        np.testing.assert_allclose(got["layers"][name],
                                   np.asarray(jc["layers"][name]), **TOL)


def _pools(tm, seed):
    """The same planted pool on both sides: NaN and Inf in resident pages,
    NaN in the null page, a lane only the range guard flags."""
    kh, dh = tm.cfg.n_kv, tm.cfg.resolved_head_dim
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((P, 2, PG, kh, dh)).astype(np.float32)
    v = rng.standard_normal((P, 2, PG, kh, dh)).astype(np.float32)
    k[1, 0, 2, 1, 5] = np.nan
    v[3, 1, 0, kh - 1, 0] = np.inf
    v[P - 1, 1, 1, 1, 1] = np.nan
    k[2, 1, 3, 0, 4] = 5.0e3
    jpool = {"layers": {"k": jnp.asarray(k), "v": jnp.asarray(v)}}
    return jpool, {"layers/k": convert.to_torch(k), "layers/v": convert.to_torch(v)}


def _detectors():
    return (dict(k=jrules.Detector(max_magnitude=1e3), v=jrules.Detector()),
            dict(k=rules.Detector(max_magnitude=1e3), v=rules.Detector()),
            {"k": ("constant", 0.25), "v": ("zero", 0.0)})


def _check_paged(out_j, out_t, jpool, tpool, rows=None):
    jl, jpool, jslot, jcnt = out_j
    tl, tslot, tcnt = out_t
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    assert int(tcnt.sum()) > 0
    sl = slice(None) if rows is None else slice(0, rows)
    np.testing.assert_allclose(tl[:, sl].numpy(), np.asarray(jl)[:, sl], **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[f"layers/{name}"].numpy(),
                                   np.asarray(jpool["layers"][name]), **TOL)


@pytest.mark.parametrize("split_k", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_paged_matches_reference(twins, arch, split_k):
    jm, jp, tm = twins[arch]
    jpool, tpool = _pools(tm, 5)
    bt = np.array([[0, 1, 2, P - 1], [3, 4, P - 1, P - 1], [P - 1] * 4], np.int32)
    pos = np.array([9, 5, 0], np.int32)
    tokens = np.array([[5], [17], [0]], np.int32)
    jdet, tdet, fills = _detectors()
    out_j = jax.jit(lambda *a: jm.serve_step_paged(
        *a, detectors=jdet, fills=fills, split_k=split_k))(
        jp, jpool, {"tokens": jnp.asarray(tokens)}, jnp.asarray(bt),
        jnp.asarray(pos))
    out_t = tm.serve_step_paged(
        tpool, torch.from_numpy(tokens), torch.from_numpy(bt),
        torch.from_numpy(pos), detectors=tdet, fills=fills, split_k=split_k)
    _check_paged(out_j, out_t, out_j[1], tpool)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_paged_matches_reference(twins, arch):
    jm, jp, tm = twins[arch]
    jpool, tpool = _pools(tm, 6)
    bt = np.array([[5, 6, 7, P - 1], [1, 2, P - 1, P - 1]], np.int32)
    tokens = _tokens((2, 7), 7)
    q_start, q_len = np.array([2, 0], np.int32), np.array([5, 7], np.int32)
    jdet, tdet, fills = _detectors()
    out_j = jax.jit(lambda *a: jm.prefill_paged(*a, detectors=jdet, fills=fills))(
        jp, jpool, {"tokens": jnp.asarray(tokens)}, jnp.asarray(bt),
        jnp.asarray(q_start), jnp.asarray(q_len))
    out_t = tm.prefill_paged(
        tpool, torch.from_numpy(tokens), torch.from_numpy(bt),
        torch.from_numpy(q_start), torch.from_numpy(q_len), detectors=tdet,
        fills=fills)
    _check_paged(out_j, out_t, out_j[1], tpool, rows=5)


# ----------------------------------------------------- engine, loss, grads

@pytest.mark.parametrize("case", ["preempt", "gathered"])
def test_starcoder2_engine_matches_reference_under_planted_faults(twins, case):
    """The engine test's planted faults (``test_torch_engine._plant``) on
    the paged path and on the gathered-view fallback, prompts in chunks of
    4 (one compiled prefill on the reference's side)."""
    jm, jp, tm = twins["starcoder2-15b"]
    kw = dict(CASES[case], prefill_chunk=4)
    je = JEngine(jm, jp, JServingConfig(**kw))
    te = Engine(tm, ServingConfig(**kw), device="cpu")
    assert (te.paged_plan is not None) == (case == "preempt")
    rng = np.random.default_rng(0)
    max_seq = kw["page_size"] * kw["max_pages_per_request"]
    for i in range(6):
        prompt = rng.integers(1, 96, size=4 + i % 4)
        max_new = min(6, max_seq - len(prompt))
        assert je.add_request(prompt, max_new) == te.add_request(prompt, max_new)
    step = 0
    while je.has_work:
        assert je.step() == te.step(), step
        if step in (1, 4):
            _plant(je, te, step)
        step += 1
    assert not te.has_work
    for rid, res in je.results.items():
        assert te.results[rid] == res
    np.testing.assert_array_equal(te.pool.page_events, je.pool.page_events)
    assert te.stats_dict() == je.stats_dict()
    assert te.stats_dict()["nan_found"] > 0
    assert te.rule_stats() == je.rule_stats()
    assert te.pool.scrubbed_bytes == je.pool.scrubbed_bytes
    np.testing.assert_array_equal(te.kernel_counts, je.kernel_counts)


def test_starcoder2_loss_and_grads_match_reference(twins):
    jm, jp, tm = twins["starcoder2-15b"]
    tokens = _tokens((2, 16), 8)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {"tokens": jnp.asarray(tokens)})
    grads = tm.bind_grads()
    try:
        for g in grads.values():
            g.zero_()
        tl, _ = tm.loss({"tokens": torch.from_numpy(tokens)})
        tl.backward()
        np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
        jg = regions.flatten(jax.tree.map(np.asarray, jg))
        assert set(grads) == set(jg)
        for path, g in grads.items():
            want = jg[path]
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(want).max()),
                                       err_msg=path)
        assert float(np.abs(jg["lm_head/w"]).max()) > 0
        assert float(np.abs(jg["layers/mlp/b_up"]).max()) > 0
    finally:
        for p in tm.parameters():
            p.requires_grad_(False)
            p.grad = None
        tm._grads = None


def test_untied_readout_rounds_to_bf16():
    """The untied head rounds its product to the activations' dtype before
    widening (the reference's ``Linear``): every logit is a bf16 value and
    they agree with the reference's ``Linear`` on the same operands; the
    tied readout keeps the f32 product."""
    rng = np.random.default_rng(9)
    h32 = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w32 = (rng.standard_normal((64, 97)) / 8).astype(np.float32)
    model = build_model(tiny_cfg("starcoder2-15b", dtype_name="bfloat16"),
                        device="cpu")
    model.lm_head.w.copy_(torch.from_numpy(w32).bfloat16())
    h = torch.from_numpy(h32).bfloat16()
    got = model._readout(h)
    assert got.dtype == torch.float32
    assert torch.equal(got, got.bfloat16().float())
    want = jlayers.Linear(64, 97, ("embed", "vocab"), dtype=jnp.bfloat16)(
        {"w": jnp.asarray(w32, jnp.bfloat16)}, jnp.asarray(h32, jnp.bfloat16))
    want = np.asarray(want.astype(jnp.float32))
    # one bf16 rounding of two f32 products that sum in different orders
    np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -7, atol=0)
    assert np.mean(got.numpy() == want) > 0.95
    tied = build_model(tiny_cfg("mistral-large-123b", dtype_name="bfloat16",
                                tie_embeddings=True), device="cpu")
    f32 = tied._readout(h)
    assert not torch.equal(f32, f32.bfloat16().float())


# ------------------------------------------- the small public helpers (18)

_DT = {"float32": (torch.float32, jnp.float32, np.float32),
       "float16": (torch.float16, jnp.float16, np.float16)}


def _faulty(np_dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(256) * 10.0).astype(np_dtype)
    x[[3, 50]] = np.nan
    x[[7]] = np.inf
    x[[9]] = -np.inf
    x[[11, 12]] = 3.0e4
    return x


def test_detect_helpers_match_reference():
    names = [str(d).split(".")[-1] for d in detect.supported_dtypes()]
    assert names == [jnp.dtype(d).name for d in jdetect.supported_dtypes()]
    for td, jd in zip(detect.supported_dtypes(), jdetect.supported_dtypes()):
        assert detect.layout_of(td).abs_mask == jdetect.layout_of(jd).abs_mask
    for name, (td, jd, nd) in _DT.items():
        x = _faulty(nd, 0)
        tx, jx = torch.from_numpy(x), jnp.asarray(x)
        for thr in (1e3, 2.5e4):
            np.testing.assert_array_equal(detect.extreme_mask(tx, thr).numpy(),
                                          np.asarray(jdetect.extreme_mask(jx, thr)))
        for inf in (True, False):
            got = detect.count_nonfinite(tx, include_inf=inf)
            assert got.dtype == torch.int32
            assert int(got) == int(jdetect.count_nonfinite(jx, include_inf=inf))
    xb = _faulty(np.float32, 1)
    tb = torch.from_numpy(xb).bfloat16()
    jb = jnp.asarray(xb, jnp.bfloat16)
    np.testing.assert_array_equal(detect.extreme_mask(tb, 1e3).numpy(),
                                  np.asarray(jdetect.extreme_mask(jb, 1e3)))
    assert int(detect.count_nonfinite(tb)) == int(jdetect.count_nonfinite(jb))


def test_expected_nan_fraction_and_approx_mask_match_reference():
    for td, jd in zip(detect.supported_dtypes(), jdetect.supported_dtypes()):
        for ber in (1e-9, 1e-6, 1e-3):
            assert (injection.expected_nan_fraction(td, ber)
                    == jinjection.expected_nan_fraction(jd, ber))
    nested = {"opt": {"step": np.zeros(()), "mu": np.zeros(3)},
              "rng_key": np.zeros(2, np.uint32), "router": {"w": np.zeros(2)},
              "layers": {"k": np.zeros(4)}}
    want = regions.flatten(jregions.approx_mask(nested, jregions.annotate(nested)))
    flat = regions.flatten(nested)
    got = regions.approx_mask(flat, regions.annotate(flat))
    assert got == want
    assert sorted(p for p, a in got.items() if not a) == [
        "opt/step", "rng_key", "router/w"]


def _state(seed):
    x = _faulty(np.float32, seed).reshape(16, 16)
    return {"layers/w": x, "opt/step": np.array([np.nan], np.float32)}


def test_scrub_pytree_shim_warns_and_matches_reference():
    state = _state(2)
    cfg, jcfg = repair.RepairConfig(policy="zero"), jrepair.RepairConfig(policy="zero")
    tree = {p: torch.from_numpy(v.copy()) for p, v in state.items()}
    with pytest.warns(DeprecationWarning, match="core.repair.scrub_pytree is a "
                      "deprecated shim; use runtime.ApproxSpace.scrub"):
        out, st = repair.scrub_pytree(tree, cfg, stats_lib.zeros())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jout, jst = jrepair.scrub_pytree(
            {"layers": {"w": jnp.asarray(state["layers/w"])},
             "opt": {"step": jnp.asarray(state["opt/step"])}}, jcfg, jstats.zeros())
    assert stats_lib.as_dict(st) == jstats.as_dict(jst)
    np.testing.assert_array_equal(out["layers/w"].numpy(),
                                  np.asarray(jout["layers"]["w"]))
    assert np.isnan(out["opt/step"].numpy()).all()          # exact: untouched
    assert stats_lib.as_dict(st)["nan_found"] == 2


def test_inject_pytree_shim_warns_and_counts_flips():
    state = _state(3)
    tree = {p: torch.from_numpy(v.copy()) for p, v in state.items()}
    before = {p: t.clone() for p, t in tree.items()}
    with pytest.warns(DeprecationWarning, match="core.repair.inject_pytree is a "
                      "deprecated shim; use runtime.ApproxSpace.inject"):
        out, flips = repair.inject_pytree(tree, 7, 1e-2)
    diff = detect.bits_of(out["layers/w"]) ^ detect.bits_of(before["layers/w"])
    changed = sum(bin(int(d) & 0xFFFFFFFF).count("1") for d in diff.view(-1))
    assert int(flips) == changed > 0
    assert torch.equal(out["opt/step"].view(torch.int32),
                       before["opt/step"].view(torch.int32))
    with pytest.warns(DeprecationWarning):
        _, again = repair.inject_pytree(
            {p: t.clone() for p, t in before.items()},
            torch.Generator().manual_seed(7), 1e-2)
    assert int(again) == int(flips)        # a seed is a generator seeded with it


def test_scrub_cache_shim_warns_and_matches_reference(twins):
    jm, _, tm = twins["starcoder2-15b"]
    rng = np.random.default_rng(4)
    tree = {"layers": {n: rng.standard_normal((2, 2, 8, 2, 16)).astype(np.float32)
                       for n in ("k", "v")}}
    tree["layers"]["k"][1, 0, 3, 1, 5] = np.nan
    tree["layers"]["v"][0, 1, 2, 0, 0] = -np.inf
    cache = tm.init_cache(2, 8)
    convert.cache_from_jax(cache, tree)
    with pytest.warns(DeprecationWarning, match="scrub_cache is a deprecated shim"):
        out, st = serve.scrub_cache(tm, cache)
    jout, jst = jserve.scrub_cache(jm, jax.tree.map(jnp.asarray, tree))
    assert stats_lib.as_dict(st) == jstats.as_dict(jst)
    got = convert.cache_to_numpy(out)
    for n in ("k", "v"):
        np.testing.assert_array_equal(got["layers"][n], np.asarray(jout["layers"][n]))
    assert stats_lib.as_dict(st)["nan_found"] == 1
