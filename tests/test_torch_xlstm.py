"""Port parity of the xLSTM family at ``get_config("xlstm-1.3b").reduced()``
(4 blocks: one group of 3 mLSTM + 1 sLSTM, d_model 128, head dim 64,
chunk 16, f32), with the reference's weights carried across by
``xlstm_params_from_jax``.

The reference's ``forward`` runs its jnp oracle ``_chunked_mlstm``; the
port's runs the chunked kernel's plain version (on clean f32 inputs the two
differ in summation order only).  Tolerance rtol = atol = 1e-4 for logits
and cache leaves (f32 throughout; XLA and PyTorch sum the projections in
different orders, compounded over the blocks and the decode steps).  Tokens,
stats, rule stats and scrub counts must be identical.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.runtime import ApproxConfig as JApproxConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.regions import flatten  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import XLSTMLM, build_model  # noqa: E402
from repro_torch.runtime import ApproxConfig  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "xlstm-1.3b"


@pytest.fixture(scope="module")
def ref():
    """The reference's reduced xLSTM and its weights (numpy)."""
    jm = jbuild(jget_config(ARCH).reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def port(ref):
    return convert.xlstm_params_from_jax(ref[2], get_config(ARCH).reduced(),
                                         device="cpu")


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, size=shape).astype(np.int32)


def test_forward_matches_reference(ref, port):
    jm, jp, _ = ref
    tokens = _tokens((2, 32), 1)
    want = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(tokens)}))
    got, counts = port(torch.from_numpy(tokens), with_counts=True)
    assert counts.tolist() == [0] * 8
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_serve_step_matches_reference(ref, port):
    """Every step's logits and every cache leaf, over six steps from a
    cache with nonzero state in every leaf."""
    jm, jp, _ = ref
    B = 2
    jcache = jm.init_cache(B, 16)
    rng = np.random.default_rng(2)
    jcache = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)
                              * 0.1, x.dtype), jcache)
    tcache = port.init_cache(B)
    convert.cache_from_jax(tcache, jax.tree.map(np.asarray, jcache))
    step = jax.jit(jm.serve_step)
    for t, tok in enumerate(_tokens((6, B, 1), 3)):
        jl, jcache = step(jp, jcache, {"tokens": jnp.asarray(tok)},
                          jnp.asarray(t, jnp.int32))
        tl, tcache = port.serve_step(tcache, torch.from_numpy(tok), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        mine = flatten(convert.cache_to_numpy(tcache))
        theirs = flatten(jax.tree.map(np.asarray, jcache))
        assert mine.keys() == theirs.keys()
        for path in theirs:
            np.testing.assert_allclose(mine[path], theirs[path], err_msg=path,
                                       **TOL)


def test_cache_layout_matches_reference(ref, port):
    jm = ref[0]
    want = flatten(jax.tree.map(np.asarray, jm.init_cache(3, 8)))
    got = port.init_cache(3)
    assert list(got) == list(want)
    for path, arr in want.items():
        assert tuple(got[path].shape) == arr.shape, path
        assert str(got[path].dtype).split(".")[-1] == arr.dtype.name, path
        assert not bool(got[path].any())                      # zeros, m included


def test_decode_matches_forward(port):
    """Teacher-forced decode ≈ forward (the tolerance of
    ``tests/test_archs_smoke.py::test_decode_matches_forward``: the decode
    cache starts m at 0, the forward at −1e30)."""
    tokens = torch.from_numpy(_tokens((1, 16), 4))
    full = port(tokens)
    cache = port.init_cache(1)
    outs = []
    for t in range(16):
        logits, cache = port.serve_step(cache, tokens[:, t:t + 1], t)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)


# faults planted before the 1st and 3rd interval scrubs: (leaf, index, value)
_PLANTS = {
    1: [("mlstm_groups/C", (0, 1, 0, 2, 3, 4), np.nan),
        ("slstm_layers/c", (0, 1, 3, 5), np.inf),
        ("mlstm_groups/conv", (0, 2, 1, 0, 7), -np.inf)],
    3: [("mlstm_groups/C", (0, 0, 1, 1, 9, 0), -np.inf),
        ("mlstm_groups/n", (0, 2, 0, 3, 1), np.nan),
        ("slstm_layers/h", (0, 0, 2, 4), np.nan)],
}


def _planting(space, plant):
    """Wrap ``space.scrub`` to plant ``_PLANTS`` into the cache before the
    matching call and log each call's [nan_found, inf_found, events]."""
    inner, log = space.scrub, []

    def scrub(cache, stats, *, trigger="forced"):
        for path, idx, val in _PLANTS.get(len(log) + 1, ()):
            cache = plant(cache, path, idx, val)
        cache, out = inner(cache, stats, trigger=trigger)
        log.append([out[k] - stats[k] for k in ("nan_found", "inf_found", "events")])
        return cache, out

    space.scrub = scrub
    return log


def _plant_jax(cache, path, idx, val):
    head, name = path.split("/")
    leaf = cache[head][name]
    return {**cache, head: {**cache[head], name: leaf.at[idx].set(val)}}


def _plant_torch(cache, path, idx, val):
    cache[path][idx] = val
    return cache


@pytest.mark.parametrize("policy", ["zero", "neighbor_mean"])
def test_generate_matches_reference(ref, policy):
    """Greedy generation with faults planted in both caches and an
    interval scrub every 4 steps: ``zero`` scrubs through the scrub
    wrapper (its plain version on the CPU), ``neighbor_mean`` through the
    tensor-level policy."""
    jp, params = ref[1], ref[2]
    jcfg, tcfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    if policy == "zero":
        jcfg = dataclasses.replace(jcfg, repair=JApproxConfig(mode="memory", policy="zero"))
        tcfg = dataclasses.replace(tcfg, repair=ApproxConfig(mode="memory", policy="zero"))
    jm = jbuild(jcfg)
    tm = convert.xlstm_params_from_jax(params, tcfg, device="cpu")
    prompt = _tokens((2, 8), 5)
    jspace = jserve.serve_space(jm, 4, memoize=False)
    tspace = serve.serve_space(tm, 4, memoize=False)
    jlog, tlog = _planting(jspace, _plant_jax), _planting(tspace, _plant_torch)
    kw = dict(max_new=6, max_seq=16, scrub_every=4)
    jtok, jstats = jserve.generate(jm, jp, jnp.asarray(prompt), space=jspace, **kw)
    ttok, tstats = serve.generate(tm, torch.from_numpy(prompt), space=tspace, **kw)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert tstats == jstats
    assert tlog == jlog and len(tlog) == 4
    assert tlog[0][:2] == [1, 2] and tlog[2][:2] == [2, 1]
    assert tspace.rule_stats() == jspace.rule_stats()
    assert tspace.stats_dict() == jspace.stats_dict()


def test_unmapped_paths_and_unported_paths_raise(ref):
    cfg = get_config(ARCH).reduced()
    with pytest.raises(KeyError, match="no ported parameter"):
        convert.xlstm_params_from_jax({**ref[2], "extra": {"w": np.zeros(2)}},
                                      cfg, device="cpu")
    with pytest.raises(KeyError, match="lacks"):
        convert.xlstm_params_from_jax({"embed": ref[2]["embed"]}, cfg, device="cpu")
    assert isinstance(build_model(cfg, device="cpu"), XLSTMLM)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(dataclasses.replace(cfg, family="audio"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        XLSTMLM(dataclasses.replace(cfg, repair=ApproxConfig(mode="register")),
                device="cpu")
    tm = XLSTMLM(cfg, device="cpu")
    prompt = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="no paged KV layout"):
        serve.generate(tm, prompt, max_new=2, max_seq=8, paged=True)
    with pytest.raises(NotImplementedError, match="token-by-token"):
        serve.build_serve_step(tm)(tm.init_cache(1), prompt, 0)
