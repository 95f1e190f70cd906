"""Port parity of the Zamba hybrid: ``nn.ssm`` (``_chunked_ssd`` against
the reference's and against a step-by-step f64 recurrence, ``Mamba2``'s
forward and a run of ``decode_step``s) and ``models.zamba.ZambaLM`` at
``get_config("zamba2-7b").reduced()`` (4 layers: 2 groups of 2 Mamba
layers and a shared-block use, no tail) and at a 5-layer variant with a
tail of 1, against the reference's models on the same weights: the layout,
``forward``, ``loss`` and every gradient, the decode cache, ``generate``
with an interval scrub and faults planted in the SSM state (tokens, stats,
scrub counts and scrubbed bytes equal), the interval scrub leaf by leaf,
and the ``convert`` round trips.

The weights are drawn by the port's initialiser and carried to the
reference as numpy, with the per-head and norm parameters (``A_log``,
``D``, ``dt_bias``, the norm scales, the conv bias) drawn from seeded
normals so that a swapped leaf shows.  The reference's programs are
compiled once per model (module-scoped fixtures, one input shape per
path).  Models agree within rtol = atol = 1e-4 (f32; the two packages sum
the products in different orders), modules within 1e-5, gradients every
lane within 1e-5 of the leaf's largest |grad|.

The chunk-128 finding: the masked intra-chunk decay ``where(tri,
exp(dLa), 0)`` overflows to inf above the diagonal once a chunk's decay
exceeds e^88, so the forward is exact and the backward is NaN (``0 ·
inf``) in both packages; gradients are held at the reduced chunk of 16.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import stats as jstats_lib  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.nn import ssm as jssm  # noqa: E402
from repro.runtime import ApproxConfig as JApproxConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import stats as stats_lib  # noqa: E402
from repro_torch.core.regions import flatten  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ZambaLM, build_model  # noqa: E402
from repro_torch.nn import ssm  # noqa: E402
from repro_torch.runtime import ApproxConfig  # noqa: E402

ARCH = "zamba2-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-5
B, S = 2, 32
# per-head and norm leaves, drawn so that a swapped leaf shows
# (A_log and dt_bias drawn narrow: a chunk's decay must stay under e^88,
# or the gradient is NaN in both packages, as at the chunk of 128 below)
_DRAWN = {"/A_log": (1.0, 0.1), "/D": (1.0, 0.3), "/dt_bias": (-0.5, 0.2),
          "/scale": (1.0, 0.3), "/norm_scale": (1.0, 0.3), "/conv_b": (0.0, 0.3)}
VARIANTS = {"reduced": {}, "tail": {"n_layers": 5}}


def cfgs(variant, **over):
    kw = {**VARIANTS[variant], "remat": False, **over}
    return (dataclasses.replace(jget_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _draw(tree: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in tree.items():
        for suffix, (mean, std) in _DRAWN.items():
            if path.endswith(suffix):
                leaf = (mean + std * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        out[path] = leaf
    return out


def _nest(flat: dict) -> dict:
    out = {}
    for path, leaf in flat.items():
        *heads, name = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[name] = leaf
    return out


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(1, 512, size=shape).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    """Per variant: the reference model, its params (jnp), the numpy tree
    and the port's model holding the same weights (through
    ``params_from_jax``)."""
    out = {}
    for i, variant in enumerate(VARIANTS):
        jcfg, tcfg = cfgs(variant)
        drawn = ZambaLM(tcfg, device="cpu", seed=i)
        flat = _draw({p: t.numpy().copy() for p, t in drawn.param_tree().items()}, i)
        tree = _nest(flat)
        jm = jbuild(jcfg)
        tm = convert.params_from_jax(tree, tcfg, device="cpu")
        out[variant] = (jm, jax.tree.map(jnp.asarray, tree), flat, tm)
    return out


# ---------------------------------------------------------------- modules

def _recurrence(x, Bm, Cm, dt, A):
    """The SSD recurrence step by step, in f64."""
    x, Bm, Cm, dt, A = (np.asarray(a, np.float64) for a in (x, Bm, Cm, dt, A))
    b, s, h, p = x.shape
    state = np.zeros((b, h, Bm.shape[-1], p))
    ys = []
    for t in range(s):
        a = np.exp(dt[:, t] * A)
        state = a[..., None, None] * state + np.einsum(
            "bn,bh,bhp->bhnp", Bm[:, t], dt[:, t], x[:, t])
        ys.append(np.einsum("bn,bhnp->bhp", Cm[:, t], state))
    return np.stack(ys, axis=1)


@pytest.mark.parametrize("chunk", [4, 16, 32], ids=["chunk4", "chunk16", "whole"])
def test_chunked_ssd_matches_reference_and_recurrence(chunk):
    rng = np.random.default_rng(chunk)
    x = rng.standard_normal((2, 32, 3, 5)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((2, 32, 4)).astype(np.float32) for _ in range(2))
    dt = np.log1p(np.exp(rng.standard_normal((2, 32, 3)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(3)).astype(np.float32)
    got = ssm._chunked_ssd(*map(torch.from_numpy, (x, Bm, Cm, dt, A)), chunk=chunk)
    want = jax.jit(functools.partial(jssm._chunked_ssd, chunk=chunk))(
        *map(jnp.asarray, (x, Bm, Cm, dt, A)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)
    np.testing.assert_allclose(got.numpy(), _recurrence(x, Bm, Cm, dt, A),
                               **MODULE_TOL)


def test_chunked_ssd_refuses_a_ragged_sequence():
    x = torch.zeros(1, 12, 2, 2)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssm._chunked_ssd(x, torch.zeros(1, 12, 3), torch.zeros(1, 12, 3),
                         torch.zeros(1, 12, 2), torch.zeros(2), chunk=8)


@pytest.fixture(scope="module")
def mamba_pair():
    """A reference ``Mamba2`` (d_model 32, N 8, P 16, chunk 8) and the
    port's, one set of seeded weights."""
    jm = jssm.Mamba2(d_model=32, d_state=8, head_dim=16, chunk=8, dtype=jnp.float32)
    tm = ssm.Mamba2(32, d_state=8, head_dim=16, chunk=8, dtype=torch.float32,
                    device="cpu")
    rng = np.random.default_rng(7)
    p = {}
    for name, t in tm.named_parameters():
        draw = rng.standard_normal(t.shape).astype(np.float32)
        p[name] = {"A_log": 0.5 + 0.3 * draw, "D": 1.0 + 0.3 * draw,
                   "norm_scale": 1.0 + 0.3 * draw}.get(name, 0.3 * draw)
        p[name] = p[name].astype(np.float32)
        t.copy_(torch.from_numpy(p[name]))
    return jm, tm, jax.tree.map(jnp.asarray, p)


def test_mamba2_forward_matches_reference(mamba_pair):
    jm, tm, p = mamba_pair
    x = np.random.default_rng(8).standard_normal((2, 16, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jm.__call__)(p, jnp.asarray(x)))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), want, **MODULE_TOL)


def test_mamba2_decode_steps_match_reference_and_forward(mamba_pair):
    """Eight ``decode_step``s from a zero state: each output and the
    carried conv and SSM states equal the reference's, and the outputs
    equal the full-sequence forward's rows."""
    jm, tm, p = mamba_pair
    x = np.random.default_rng(9).standard_normal((2, 8, 32)).astype(np.float32)
    jstep = jax.jit(jm.decode_step)
    defs = tm.cache_defs(2)
    assert defs == {"conv": ((2, 3, 80), torch.float32),
                    "ssm": ((2, 4, 8, 16), torch.float32)}
    jcache = {k: jnp.zeros(shape, jnp.float32) for k, (shape, _) in defs.items()}
    tcache = {k: torch.zeros(shape) for k, (shape, _) in defs.items()}
    outs = []
    for t in range(8):
        want, jcache = jstep(p, jnp.asarray(x[:, t:t + 1]), jcache)
        got, tcache = tm.decode_step(torch.from_numpy(x[:, t:t + 1]), tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)
        for k in defs:
            np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                       **MODULE_TOL)
        outs.append(got)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                               tm(torch.from_numpy(x)).numpy(), **MODULE_TOL)


def test_chunk128_gradient_is_nan_in_both_packages():
    """The reference's masked decay overflows at its own chunk of 128: with
    ``A_log = 1`` (the init) and ``dt`` near softplus(1), a chunk's decay
    sums to ~-200 > ln(f32 max), so ``exp(dLa)`` is inf above the diagonal.
    The forward is finite and equal in both packages; the gradient of
    ``A_log`` is NaN in both (``0 · inf`` in the backward of ``where``).
    At chunk 16 both gradients are finite and agree."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 128, 2, 4)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((1, 128, 3)).astype(np.float32) for _ in range(2))
    dt = np.full((1, 128, 2), np.log1p(np.e), np.float32)
    A_log = np.ones(2, np.float32)
    grads = {}
    for chunk in (128, 16):
        def jloss(a_log, chunk=chunk):
            return jssm._chunked_ssd(*map(jnp.asarray, (x, Bm, Cm, dt)),
                                     -jnp.exp(a_log), chunk=chunk).sum()

        jy, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(A_log))
        a = torch.from_numpy(A_log).requires_grad_(True)
        y = ssm._chunked_ssd(*map(torch.from_numpy, (x, Bm, Cm, dt)),
                             -torch.exp(a), chunk=chunk).sum()
        y.backward()
        assert np.isfinite(float(jy)) and torch.isfinite(y)
        np.testing.assert_allclose(float(y.detach()), float(jy), rtol=1e-5)
        grads[chunk] = (a.grad.numpy(), np.asarray(jg))
    assert np.isnan(grads[128][0]).all() and np.isnan(grads[128][1]).all()
    assert np.isfinite(grads[16][0]).all()
    np.testing.assert_allclose(grads[16][0], grads[16][1], rtol=1e-4)


# ------------------------------------------------------------------ models

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_layout_matches_reference(variant):
    """Paths, shapes and dtypes of the weights and of the decode cache
    (``cache_defs``) equal the reference's abstract trees."""
    jcfg, tcfg = cfgs(variant)
    jm, tm = jbuild(jcfg), ZambaLM(tcfg, device="cpu")
    want = flatten(jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                                jm.abstract_params()))
    got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in tm.param_tree().items()}
    assert list(got) == list(want) and got == want
    jc = flatten(jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                              jm.abstract_cache(3, 24)))
    tc = {p: (shape, str(dt).replace("torch.", ""))
          for p, (shape, dt) in tm.cache_defs(3, 24).items()}
    assert list(tc) == list(jc) and tc == jc
    assert (tm.n_groups, tm.n_tail) == (2, 1 if variant == "tail" else 0)
    assert tm.shared[0].attn.head_dim == 2 * tcfg.d_model // tcfg.n_heads == 64


def test_full_width_geometry():
    """zamba2-7b copies the reference's config; at full width: 13 groups
    and a tail of 3, shared head dim 224, 7.79 B parameters (15.59 GB in
    bf16), counted from the shapes alone (no weights built)."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    for f in dataclasses.fields(cfg):
        if f.name != "repair":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    G, M, D = cfg.n_layers // cfg.mamba_per_attn, cfg.mamba_per_attn, cfg.d_model
    assert (G, cfg.n_layers - G * M) == (13, 3)
    assert 2 * D // cfg.n_heads == 224
    leaves = jax.tree.leaves(jax.tree.map(
        lambda a: int(np.prod(a.shape, dtype=np.int64)), jbuild(jcfg).abstract_params()))
    assert sum(leaves) == 7_792_519_376
    assert isinstance(build_model(dataclasses.replace(cfg.reduced(), n_layers=2),
                                  device="cpu"), ZambaLM)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_reference(models, variant):
    jm, jp, _, tm = models[variant]
    tokens = _tokens((B, S), 1)
    want = np.asarray(jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(tokens)}))
    got = tm(torch.from_numpy(tokens))
    assert got.shape == (B, S, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_every_grad_match_reference(models, variant):
    """The loss, its metrics and the gradient of every leaf (the shared
    sets' summed over the groups that use them, the tied table's over the
    embedding and the readout)."""
    jm, jp, _, tm = models[variant]
    tokens = _tokens((B, S), 2)

    def jloss(p):
        return jm.loss(p, {"tokens": jnp.asarray(tokens)})

    (jl, jmet), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    grads = tm.bind_grads()
    for g in grads.values():
        g.zero_()
    loss, metrics = tm.loss({"tokens": torch.from_numpy(tokens)})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    for k in ("accuracy", "tokens"):
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]), rtol=1e-6)
    want = flatten(jax.tree.map(np.asarray, jg))
    assert list(grads) == list(want)
    for path, w in want.items():
        err = np.abs(grads[path].numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL, (path, err)
    assert np.abs(want["shared/attn/wq"][1]).max() > 0       # both sets trained


def test_remat_changes_no_gradient(models):
    """``cfg.remat`` recomputes each Mamba layer and each group in the
    backward: the same gradients, bit for bit."""
    _, _, flat, _ = models["tail"]
    tokens = torch.from_numpy(_tokens((B, S), 3))
    out = []
    for remat in (False, True):
        tcfg = cfgs("tail", remat=remat)[1]
        tm = convert.params_from_jax(_nest(flat), tcfg, device="cpu")
        grads = tm.bind_grads()
        tm.loss({"tokens": tokens})[0].backward()
        out.append(grads)
    for path in out[0]:
        assert torch.equal(out[0][path], out[1][path]), path


def test_register_mode_repairs_every_pathless_read(models):
    """Register mode with NaN lanes in a Mamba projection, a per-head leaf,
    a shared attention weight and the embedding row of a prompt token:
    every read is pathless in both packages, so each lane is repaired at
    its use and the logits are finite and equal the reference's."""
    _, _, flat, _ = models["tail"]
    rep = dict(mode="register", policy="zero")
    jcfg = cfgs("tail", repair=JApproxConfig(**rep))[0]
    tcfg = cfgs("tail", repair=ApproxConfig(**rep))[1]
    planted = {p: a.copy() for p, a in flat.items()}
    for path, idx in (("mamba_groups/mamba/in_proj", (0, 1, 5, 7)),
                      ("mamba_tail/mamba/A_log", (0, 3)),
                      ("shared/attn/wq", (1, 3, 4)),
                      ("embed/table", (5, 2))):
        planted[path][idx] = np.nan
    jm = jbuild(jcfg)
    tm = convert.params_from_jax(_nest(planted), tcfg, device="cpu")
    tokens = _tokens((B, S), 6)
    tokens[0, 3] = 5
    want = np.asarray(jax.jit(jm.forward)(jax.tree.map(jnp.asarray, _nest(planted)),
                                          {"tokens": jnp.asarray(tokens)}))
    got = tm(torch.from_numpy(tokens))
    assert np.isfinite(want).all() and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert bool(torch.isnan(tm.shared[1].attn.wq[3, 4]))     # repaired at use only


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_serve_steps_match_reference(models, variant):
    """Six decode steps from a zero cache: logits and every cache leaf
    (the shared KV written at ``pos``, the Mamba states) equal the
    reference's; the port updates its cache in place."""
    jm, jp, _, tm = models[variant]
    tokens = _tokens((B, 6), 4)
    jcache = jm.init_cache(B, 8)
    tcache = tm.init_cache(B, 8)
    jstep = jax.jit(jm.serve_step)
    for t in range(6):
        tok = tokens[:, t:t + 1]
        want, jcache = jstep(jp, jcache, {"tokens": jnp.asarray(tok)},
                             jnp.asarray(t, jnp.int32))
        got, same = tm.serve_step(tcache, torch.from_numpy(tok), t)
        assert same is tcache
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jflat = flatten(jax.tree.map(np.asarray, jcache))
    assert list(jflat) == list(tcache)
    for path, w in jflat.items():
        np.testing.assert_allclose(tcache[path].numpy(), w, **TOL, err_msg=path)


# ---------------------------------------------------------- generate, scrub

# plants before the n-th interval scrub: (path, index, value)
_PLANTS = {
    1: [("mamba_groups/ssm", (1, 0, 1, 3, 5, 7), float("nan")),
        ("shared_kv/k", (0, 0, 2, 1, 9), float("inf"))],
    2: [("mamba_groups/ssm", (0, 1, 0, 6, 2, 30), float("nan")),
        ("mamba_groups/conv", (1, 1, 1, 2, 40), float("-inf"))],
}
_TAIL_PLANTS = {3: [("mamba_tail/ssm", (0, 1, 4, 15, 3), float("nan"))]}


def _planting(space, plant, plants):
    """Wrap ``space.scrub`` to plant ``plants`` into the cache before the
    matching call and log each call's [nan_found, inf_found, events]."""
    inner, log = space.scrub, []

    def scrub(cache, stats, *, trigger="forced"):
        for path, idx, val in plants.get(len(log) + 1, ()):
            cache = plant(cache, path, idx, val)
        cache, out = inner(cache, stats, trigger=trigger)
        log.append([out[k] - stats[k] for k in ("nan_found", "inf_found", "events")])
        return cache, out

    space.scrub = scrub
    return log


def _plant_jax(cache, path, idx, val):
    head, name = path.split("/")
    return {**cache, head: {**cache[head], name: cache[head][name].at[idx].set(val)}}


def _plant_torch(cache, path, idx, val):
    cache[path][idx] = val
    return cache


@pytest.mark.parametrize("variant,policy", [("reduced", "zero"),
                                            ("tail", "neighbor_mean")])
def test_generate_matches_reference(models, variant, policy):
    """Greedy generation (prompt 8, 6 new tokens, a dense shared KV of 16)
    with an interval scrub every 4 steps and NaN/Inf planted in the SSM,
    conv and KV leaves before the scrubs: the planted lanes are repaired
    before the next step reads them, and tokens, stats, each scrub's
    counts, rule stats and scrubbed bytes equal the reference's."""
    _, jp, flat, _ = models[variant]
    rep = dict(mode="memory", policy=policy)
    jcfg, tcfg = cfgs(variant, repair=JApproxConfig(**rep))[0], \
        cfgs(variant, repair=ApproxConfig(**rep))[1]
    jm, tm = jbuild(jcfg), convert.params_from_jax(_nest(flat), tcfg, device="cpu")
    plants = {**_PLANTS, **(_TAIL_PLANTS if variant == "tail" else {})}
    prompt = _tokens((B, 8), 5)
    jspace = jserve.serve_space(jm, 4, memoize=False)
    tspace = serve.serve_space(tm, 4, memoize=False)
    jlog = _planting(jspace, _plant_jax, plants)
    tlog = _planting(tspace, _plant_torch, plants)
    kw = dict(max_new=6, max_seq=16, scrub_every=4)
    jtok, jstats = jserve.generate(jm, jp, jnp.asarray(prompt), space=jspace, **kw)
    ttok, tstats = serve.generate(tm, torch.from_numpy(prompt), space=tspace, **kw)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert tstats == jstats
    assert tlog == jlog and len(tlog) == 4
    assert tlog[0][:2] == [1, 1] and tlog[1][:2] == [1, 1]
    assert tlog[2][:2] == ([1, 0] if variant == "tail" else [0, 0])
    assert tspace.rule_stats() == jspace.rule_stats()
    assert tspace.stats_dict() == jspace.stats_dict()
    assert tspace.scrubbed_bytes == jspace.scrubbed_bytes > 0


def test_interval_scrub_leaf_by_leaf_matches_reference(models):
    """Each cache leaf of the variant with a tail, alone, with two NaN and
    one Inf planted: the serving space's scrub gives the reference's
    counts, scrubbed bytes and repaired values leaf by leaf."""
    jm, _, flat, tm = models["tail"]
    jspace = jserve.serve_space(jm, 4, memoize=False)
    tspace = serve.serve_space(tm, 4, memoize=False)
    cache = {p: torch.randn(shape, generator=torch.Generator().manual_seed(i)).to(dt)
             for i, (p, (shape, dt)) in enumerate(tm.cache_defs(B, 16).items())}
    for i, (path, leaf) in enumerate(cache.items()):
        flat_view = leaf.view(-1)
        for j, val in enumerate((float("nan"), float("inf"), float("nan"))):
            flat_view[(97 * (i + 1) * (j + 1)) % flat_view.numel()] = val
        jtree = jax.tree.map(jnp.asarray, convert.cache_to_numpy({path: leaf.clone()}))
        jout, jst = jspace.scrub(jtree, jstats_lib.zeros(), trigger="interval")
        tout, tst = tspace.scrub({path: leaf.clone()}, stats_lib.zeros(),
                                 trigger="interval")
        assert {k: int(v) for k, v in jst.items()} == {k: int(v) for k, v in tst.items()}, path
        assert tspace.scrubbed_bytes == jspace.scrubbed_bytes, path
        assert int(tst["nan_found"]) == 2 and int(tst["inf_found"]) == 1, path
        np.testing.assert_array_equal(
            tout[path].numpy(), flatten(jax.tree.map(np.asarray, jout))[path])


def test_params_and_cache_round_trip(models):
    """``params_from_jax`` holds the tree it was given, leaf for leaf;
    ``cache_to_numpy`` gives the reference's nested cache layout, and
    ``cache_from_jax`` carries a reference cache back bit for bit."""
    jm, _, flat, tm = models["tail"]
    for path, t in tm.param_tree().items():
        np.testing.assert_array_equal(t.detach().numpy(), flat[path])
    with pytest.raises(KeyError, match="no ported parameter"):
        convert.params_from_jax({**_nest(flat), "extra": {"w": np.zeros(2)}},
                                tm.cfg, device="cpu")
    rng = np.random.default_rng(12)
    jcache = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(a.dtype),
                          jm.abstract_cache(B, 16))
    tcache = tm.init_cache(B, 16)
    convert.cache_from_jax(tcache, jcache)
    back = convert.cache_to_numpy(tcache)
    assert jax.tree.structure(back) == jax.tree.structure(jcache)
    for path, w in flatten(jcache).items():
        np.testing.assert_array_equal(flatten(back)[path], w)


def test_unported_paths_raise(models):
    _, _, _, tm = models["reduced"]
    cfg = tm.cfg
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(dataclasses.replace(cfg, family="audio"), device="cpu")
    prompt = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="no paged KV layout"):
        serve.generate(tm, prompt, max_new=2, max_seq=8, paged=True)
    with pytest.raises(NotImplementedError, match="token-by-token"):
        tm.prefill(tm.init_cache(1, 8), prompt, 0)
