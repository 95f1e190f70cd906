"""Port parity of the dense-cache transformer and what serves over it: the
model's ``forward`` (direct and chunked attention), ``serve_step`` and
``prefill`` against the JAX model (f32, the same weights), ``generate`` over
the dense cache and ``generate(paged=True)`` over the engine against the
JAX loops, the use-site repair of on-read rules, the dense cache carried
across by ``convert`` and the workload traces.  Floats agree within
rtol = atol = 1e-5; tokens, stats and counts exactly.

Two tests run the port against itself: its bit-flip injection draws from a
``torch.Generator`` and the reference's from a ``PRNGKey``, so the two
packages see different flips, and the desynchronized drain's replay
contract is held port to port."""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import tiny_transformer  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.serving import workload as jworkload  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import repair  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime import ApproxConfig  # noqa: E402
from repro_torch.serving import Engine, ServingConfig, workload  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def tiny_cfg(repair_cfg=None):
    return dataclasses.replace(
        get_config("qwen2-1.5b").reduced(),
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=97, repair=repair_cfg or ApproxConfig(mode="off"),
    )


@pytest.fixture(scope="module")
def models():
    jm, jp = tiny_transformer()
    jp = jax.tree.map(np.asarray, jp)
    return jm, jp, convert.params_from_jax(jp, tiny_cfg(), device="cpu")


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(1, 96, size=shape).astype(np.int32)


def _jcache(tree):
    return {"layers": {n: jnp.asarray(a) for n, a in tree["layers"].items()}}


# ------------------------------------------------------------ the model
def test_forward_matches_reference(models):
    jm, jp, tm = models
    tokens = _tokens((2, 24), 0)
    want = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    got = tm(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("blocks", [(8, 8), (16, 8)])
def test_chunked_attention_matches_reference(models, blocks):
    """The online-softmax form with small tiles (top-left causal mask) and
    the direct form, on one layer's attention."""
    jm, jp, tm = models
    qb, kb = blocks
    x = np.random.default_rng(1).standard_normal((2, 32, 64)).astype(np.float32)
    p = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    jattn = dataclasses.replace(jm.attn, q_block=qb, kv_block=kb)
    attn = tm.layers[0].attn
    attn.q_block, attn.kv_block = qb, kb
    for impl in ("chunked", "direct"):
        want = jattn(p, jnp.asarray(x), impl=impl)
        got = attn(torch.from_numpy(x), impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_serve_step_and_prefill_match_reference(models):
    """A batched prefill at scalar pos 0, then decode at per-request
    positions; a NaN parked in row 1's cache past its position reaches its
    output through 0 · NaN on both sides, row 0 stays finite."""
    jm, jp, tm = models
    B, T = 2, 16
    jc = jm.init_cache(B, T)
    tc = tm.init_cache(B, T)
    prompt = _tokens((B, 6), 2)
    jl, jc = jm.prefill(jp, jc, {"tokens": jnp.asarray(prompt)}, jnp.int32(0))
    tl, tc = tm.prefill(tc, torch.from_numpy(prompt), 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    tree = jax.tree.map(np.array, jc)
    tree["layers"]["v"][1, 1, 12, 0, 3] = np.nan
    jc = _jcache(tree)
    convert.cache_from_jax(tc, tree)
    pos = np.array([6, 9], np.int32)
    tok = _tokens((B, 1), 3)
    jl, jc = jm.serve_step(jp, jc, {"tokens": jnp.asarray(tok)}, jnp.asarray(pos))
    tl, tc = tm.serve_step(tc, torch.from_numpy(tok), torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert np.isfinite(tl[0].numpy()).all() and not np.isfinite(tl[1].numpy()).any()
    got = convert.cache_to_numpy(tc)
    for name in ("k", "v"):
        np.testing.assert_allclose(got["layers"][name],
                                   np.asarray(jc["layers"][name]), **TOL)


def test_dense_cache_carries_across_both_ways(models):
    jm, _, tm = models
    rng = np.random.default_rng(4)
    tree = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.tree.map(np.asarray, jm.init_cache(3, 8)))
    cache = tm.init_cache(3, 8)
    assert sorted(cache) == ["layers/k", "layers/v"]
    convert.cache_from_jax(cache, tree)
    back = convert.cache_to_numpy(cache)
    for name in ("k", "v"):
        np.testing.assert_array_equal(back["layers"][name], tree["layers"][name])


# -------------------------------------------------------- use-site repair
def _on_read(mod):
    """A memory-mode config whose one on-read rule binds layer weights."""
    return mod.ApproxConfig(mode="memory", rules=(
        (r"layers/mlp/w_up", mod.RepairRule(trigger="on-read", fill="zero")),))


def test_on_read_rule_repairs_only_its_weight(models, monkeypatch):
    """An on-read rule bound to ``layers/mlp/w_up`` repairs that weight at
    every read and nothing else: a NaN there leaves the logits finite and
    equal to the reference's, a NaN in ``w_down`` poisons both."""
    import repro.runtime as jruntime
    import repro_torch.runtime as truntime

    jm, jp, _ = models
    jmod = jbuild_model(dataclasses.replace(jm.cfg, repair=_on_read(jruntime)))
    tokens = _tokens((1, 12), 5)
    calls = []
    real_use = repair.use
    monkeypatch.setattr(repair, "use",
                        lambda x, cfg, *a, **k: calls.append(k.get("path"))
                        or real_use(x, cfg, *a, **k))
    for name, finite in (("w_up", True), ("w_down", False)):
        params = jax.tree.map(np.array, jp)
        params["layers"]["mlp"][name][1, 7, 2] = np.nan
        tm = convert.params_from_jax(params, tiny_cfg(_on_read(truntime)),
                                     device="cpu")
        want = np.asarray(jmod.forward(params, {"tokens": jnp.asarray(tokens)}))
        calls.clear()
        got = tm(torch.from_numpy(tokens)).numpy()
        assert calls == ["layers/mlp/w_up"] * 2
        assert np.isfinite(got).all() == finite == np.isfinite(want).all()
        np.testing.assert_allclose(got, want, **TOL)


def test_paged_engine_makes_no_use_calls(models, monkeypatch):
    """Outside register mode and with no on-read rule, no read site of
    the paged engine's model calls ``core.repair.use``; a register-mode
    model's sites all do."""
    _, jp, tm = models
    calls = []
    real_use = repair.use
    monkeypatch.setattr(repair, "use",
                        lambda *a, **k: calls.append(1) or real_use(*a, **k))
    cfg = ServingConfig(page_size=4, n_pages=10, max_batch=2,
                        max_pages_per_request=4)
    eng = Engine(tm, cfg, device="cpu")
    assert eng.paged_plan is not None
    for i in range(2):
        eng.add_request([3 + i, 9, 27, 4], max_new=3)
    eng.run()
    assert calls == [] and eng.metrics()["pool_gathers"] == 0
    reg = convert.params_from_jax(jp, tiny_cfg(ApproxConfig(mode="register")),
                                  device="cpu")
    eng = Engine(reg, cfg, device="cpu")
    assert eng.paged_plan is None
    eng.add_request([3, 9, 27, 4], max_new=2)
    eng.run()
    # a step (prefill, then one decode) reads per layer 12 weights (norms,
    # q/k/v weights and biases, wo, the MLP) and the K and V caches, then
    # the final norm and the table twice (embedding, tied readout)
    assert len(calls) == 2 * (2 * (12 + 2) + 1 + 2)


# ------------------------------------------------------------- generate
def _plant_before_scrub(space, which, plant):
    """Wrap ``space.scrub`` so ``plant(cache)`` runs before scrub ``which``."""
    real, seen = space.scrub, [0]

    def scrub(cache, stats=None, *, trigger="forced", **kw):
        seen[0] += 1
        if seen[0] == which:
            cache = plant(cache)
        return real(cache, stats, trigger=trigger, **kw)

    space.scrub = scrub


def test_generate_matches_reference_with_interval_scrub(models):
    """Batched prefill with the scrub due at step 0, then decode with a
    scrub every 4 steps; a NaN planted before the second scrub is found
    there on both sides."""
    jm, jp, tm = models
    prompt = _tokens((2, 6), 6)
    jspace = jserve.serve_space(jm, 4, memoize=False)
    tspace = serve.serve_space(tm, 4, memoize=False)

    def jplant(cache):
        tree = jax.tree.map(np.array, cache)
        tree["layers"]["k"][1, 0, 3, 1, 5] = np.nan
        return _jcache(tree)

    def tplant(cache):
        cache["layers/k"][1, 0, 3, 1, 5] = float("nan")
        return cache

    _plant_before_scrub(jspace, 2, jplant)
    _plant_before_scrub(tspace, 2, tplant)
    jt, js = jserve.generate(jm, jp, jnp.asarray(prompt), max_new=8, max_seq=16,
                             scrub_every=4, space=jspace)
    tt, ts = serve.generate(tm, torch.from_numpy(prompt).long(), max_new=8,
                            max_seq=16, scrub_every=4, space=tspace)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert ts == js and ts["nan_found"] == 1 and ts["events"] == 1


def test_generate_paged_matches_reference(models):
    jm, jp, tm = models
    prompt = _tokens((2, 5), 7)
    jt, js = jserve.generate(jm, jp, jnp.asarray(prompt), max_new=4, max_seq=12,
                             paged=True, page_size=4, scrub_every=3)
    tt, ts = serve.generate(tm, torch.from_numpy(prompt).long(), max_new=4,
                            max_seq=12, paged=True, page_size=4, scrub_every=3)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert ts == js


# ------------------------------------------------------------- workload
@pytest.mark.parametrize("seed", [0, 21, 77])
def test_arrivals_match_reference(seed):
    kw = dict(n_requests=9, arrival_rate=0.7, prompt_len=(2, 6),
              long_prompt_len=(8, 12), long_frac=0.3, output_len=(2, 5),
              burst_at=2, burst_n=3, seed=seed)
    got = workload.generate_arrivals(workload.WorkloadConfig(**kw))
    want = jworkload.generate_arrivals(jworkload.WorkloadConfig(**kw))
    assert [dataclasses.astuple(a) for a in got] == [
        dataclasses.astuple(a) for a in want]


# ------------------------------------------------- the desynchronized drain
def _cfg(**kw):
    base = dict(page_size=4, n_pages=10, max_batch=4, max_pages_per_request=4,
                prefill_chunk=4, seed=7)
    base.update(kw)
    return ServingConfig(**base)


def _bits(engine):
    return [leaf.view(torch.int32).numpy().copy() for leaf in engine.pool.tree.values()]


def test_desync_interval1_bit_replays_lockstep(models):
    """One request, identical flips: drain_interval=1 scrubs the pages the
    lockstep engine scrubbed one step earlier, before the next flips land,
    so tokens, stats, counts, the page ledger and the pool bits replay."""
    tm = models[2]
    engines = []
    for di in (0, 1):
        eng = Engine(tm, _cfg(ber=2e-3, prefill_chunk=0, drain_interval=di,
                              n_pages=7), device="cpu")
        eng.add_request([5, 9, 2, 14, 3, 7], max_new=8)
        eng.run()
        engines.append(eng)
    lock, desync = engines
    assert not lock._desync and desync._desync
    assert lock.stats_dict()["events"] > 0
    assert desync.results == lock.results
    assert desync.stats_dict() == lock.stats_dict()
    np.testing.assert_array_equal(desync.kernel_counts, lock.kernel_counts)
    np.testing.assert_array_equal(desync.pool.page_events, lock.pool.page_events)
    for a, b in zip(_bits(desync), _bits(lock)):
        np.testing.assert_array_equal(a, b)
    assert desync.n_host_syncs < lock.n_host_syncs


def _replay(engine, arrivals):
    """Submit each arrival at its trace step, step while there is work."""
    pending = list(arrivals)
    streams, step = {}, 0
    while pending or engine.has_work:
        while pending and pending[0].step <= step:
            a = pending.pop(0)
            streams[engine.add_request(list(a.prompt), a.max_new)] = []
        if engine.has_work:
            for rid, toks in engine.step()["emitted"].items():
                streams[rid].extend(toks)
        step += 1
    engine.drain()
    return streams


def test_desync_wide_interval_keeps_tokens_under_traffic(models):
    """drain_interval=3 under a mixed chunked-prefill and decode trace with
    flips: the lockstep tokens, strictly fewer host syncs."""
    tm = models[2]
    wl = workload.WorkloadConfig(n_requests=5, arrival_rate=0.9,
                                 prompt_len=(2, 5), long_prompt_len=(6, 10),
                                 long_frac=0.4, output_len=(2, 5), seed=21)
    runs = {}
    for di in (0, 3):
        eng = Engine(tm, _cfg(ber=1e-3, drain_interval=di), device="cpu")
        runs[di] = (_replay(eng, workload.generate_arrivals(wl)), eng)
    assert runs[3][0] == runs[0][0] and sum(map(len, runs[0][0].values())) > 0
    assert runs[3][1].n_host_syncs < runs[0][1].n_host_syncs
