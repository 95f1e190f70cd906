"""Port parity of the prefix cache: the JAX engine (Pallas kernels in
interpret mode) and the PyTorch engine (plain versions on the CPU) serve the
same scripted requests from the same weights in f32, step for step.  The
emitted tokens, ``cache_stats()``, ``prefill_tokens_saved``, the stats, rule
stats, page events, scrubbed bytes, host syncs and every page's refcount
must be equal, on the paged lane and on the gathered path; at BER 0 the
cache-on tokens equal the port's cache-off tokens.  The pool-level cases
hold the refcount, dwell, copy-on-write and reference-repair primitives,
the last bit for bit against the snapshot (through ``detect.bits_of``)."""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import tiny_transformer  # noqa: E402
from repro.core import stats as jstats  # noqa: E402
from repro.runtime import ApproxConfig as JApproxConfig  # noqa: E402
from repro.runtime import ApproxSpace as JApproxSpace  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import PagedKVPool as JPagedKVPool  # noqa: E402
from repro.serving import ServingConfig as JServingConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import detect  # noqa: E402
from repro_torch.core import stats as stats_lib  # noqa: E402
from repro_torch.runtime import ApproxConfig, ApproxSpace  # noqa: E402
from repro_torch.serving import Engine, PagedKVPool, ServingConfig  # noqa: E402

SHARED = [1, 2, 3, 4, 5, 6, 7, 8]
LANES = {"paged": {}, "gathered": dict(paged_decode="off")}


def tiny_cfg():
    return dataclasses.replace(
        get_config("qwen2-1.5b").reduced(),
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=97, repair=ApproxConfig(mode="off"),
    )


@pytest.fixture(scope="module")
def models():
    jm, jp = tiny_transformer()
    tm = convert.params_from_jax(jax.tree.map(np.asarray, jp), tiny_cfg(), device="cpu")
    return jm, jp, tm


def serving_kw(**kw):
    base = dict(page_size=4, n_pages=16, max_batch=4, max_pages_per_request=5,
                seed=3)
    base.update(kw)
    return base


def engine_pair(models, **kw):
    """The JAX engine and the port's on one configuration."""
    jm, jp, tm = models
    kw = serving_kw(**kw)
    return (JEngine(jm, jp, JServingConfig(**kw)),
            Engine(tm, ServingConfig(**kw), device="cpu"))


def lockstep(je, te):
    """Step both engines until the reference has no work; every step's
    emitted tokens and finished requests must be equal."""
    n = 0
    while je.has_work:
        a, b = je.step(), te.step()
        assert a == b, n
        n += 1
    assert not te.has_work
    je.drain()
    te.drain()


def add_both(je, te, prompt, max_new):
    rid = je.add_request(prompt, max_new)
    assert te.add_request(prompt, max_new) == rid
    return rid


def assert_engines_equal(je, te):
    assert te.results == je.results
    assert te.cache_stats() == je.cache_stats()
    assert te.tier_stats() == je.tier_stats()
    assert te.stats_dict() == je.stats_dict()
    assert te.rule_stats() == je.rule_stats()
    np.testing.assert_array_equal(te.pool.page_events, je.pool.page_events)
    np.testing.assert_array_equal(te.pool._refcount, je.pool._refcount)
    assert te.pool.scrubbed_bytes == je.pool.scrubbed_bytes
    assert te.space.scrubbed_bytes == je.space.scrubbed_bytes
    assert te.n_host_syncs == je.n_host_syncs
    jm_, tm_ = je.metrics(), te.metrics()
    for key in ("tokens_emitted", "prefill_tokens_saved",
                "prefill_tokens_recomputed", "n_preemptions",
                "n_swap_preemptions", "scrub_calls", "reactive_scrubs",
                "pool_gathers", "pool_scatters", "paged_kernel_events"):
        assert tm_[key] == jm_[key], key
    for name in ("k", "v"):
        np.testing.assert_allclose(
            te.pool.tree[f"layers/{name}"].numpy(),
            np.asarray(je.pool.tree["layers"][name]), rtol=1e-5, atol=1e-5)


def cache_off_tokens(models, script, **kw):
    """The port's cache-off engine on the same script: rid -> tokens."""
    _, _, tm = models
    eng = Engine(tm, ServingConfig(**serving_kw(**kw)), device="cpu")
    for batch in script:
        for prompt, max_new in batch:
            eng.add_request(prompt, max_new)
        eng.run()
    return {rid: r["tokens"] for rid, r in eng.results.items()}


def serve_script(je, te, script):
    """Each batch of (prompt, max_new) is added, then served to the end."""
    for batch in script:
        for prompt, max_new in batch:
            add_both(je, te, prompt, max_new)
        lockstep(je, te)


# ------------------------------------------------------------------ engine
def _hits_script():
    prompt = list(range(20, 31))           # 2 full pages + 3 rows
    return [
        [(SHARED + [9], 4)],
        [(SHARED + [10], 4), (SHARED + [9, 11, 12], 4)],
        [(SHARED + [9], 4)],
        [(prompt, 4)],
        [(prompt[:9] + [90], 4)],          # inside the forked tail: a fragment
    ]


@pytest.mark.parametrize("lane", sorted(LANES))
def test_cache_hits_cow_and_fragments_match_reference(models, lane):
    """Hits on full pages and on partial tails, a copy-on-write fork, a
    fragment hit; then the cache drained: every page comes back."""
    je, te = engine_pair(models, prefix_cache=True, **LANES[lane])
    assert (te.paged_plan is not None) == (lane == "paged")
    script = _hits_script()
    serve_script(je, te, script)
    assert_engines_equal(je, te)
    s = te.cache_stats()
    assert s["hits"] == 4 and s["misses"] == 2
    assert s["cow_forks"] == 2 and s["fragment_hits"] == 1
    assert s["reuse_skips"] > 0 and te.prefill_tokens_saved == s["hit_tokens"] > 0
    off = cache_off_tokens(models, script, **LANES[lane])
    assert {rid: r["tokens"] for rid, r in te.results.items()} == off
    # refcounts balance: each cached page holds the cache's one reference
    assert te.pool.n_free == te.cfg.n_pages - te.cache.cached_pages
    for e in te.cache._entries.values():
        assert te.pool.refcount(e.page) == 1
    assert te.cache.evict(te.cfg.n_pages) == je.cache.evict(je.cfg.n_pages) > 0
    assert te.cache.cached_pages == 0 and te.cache._fragments == {}
    assert te.pool.n_free == te.cfg.n_pages
    np.testing.assert_array_equal(te.pool._refcount[:-1], 0)
    assert te.cache_stats() == je.cache_stats()


@pytest.mark.parametrize("case", [
    # an 8-page pool: cached prefixes are evicted to admit new requests
    dict(n_pages=8),
    # the cap: never more than 3 cached pages
    dict(max_cached_pages=3),
])
def test_lru_eviction_and_cap_match_reference(models, case):
    je, te = engine_pair(models, prefix_cache=True, **case)
    script = [[([i + j for j in range(6)], 4)] for i in range(1, 70, 10)]
    serve_script(je, te, script)
    assert_engines_equal(je, te)
    assert te.cache_stats()["evictions"] > 0
    assert te.cache.cached_pages <= case.get("max_cached_pages", te.cfg.n_pages)
    assert te.pool.n_free == te.cfg.n_pages - te.cache.cached_pages


def test_shared_pages_survive_a_preemption_storm(models):
    """Demand ~3x the pool over a shared prefix: preemptions fire, shared
    pages are never reclaimed from under the cache, and the tokens are the
    cache-off engine's."""
    je, te = engine_pair(models, n_pages=10, prefix_cache=True)
    script = [[(SHARED + [9 + i], 6) for i in range(8)]]
    serve_script(je, te, script)
    assert_engines_equal(je, te)
    assert te.metrics()["n_preemptions"] > 0
    for e in te.cache._entries.values():
        assert te.pool.refcount(e.page) == 1
    off = cache_off_tokens(models, script, n_pages=10)
    assert {rid: r["tokens"] for rid, r in te.results.items()} == off


def _plant_in_cached_page(je, te):
    """A NaN in one lane of the first cached full page, in both pools.
    Returns (page, the port's snapshot of it, the planted index)."""
    e = next(e for e in te.cache._entries.values() if not e.partial)
    assert not je.cache._entries[e.key].partial
    at = (e.page, 1, 2, 1, 5)
    jtree = jax.tree.map(np.array, je.pool.tree)
    jtree["layers"]["k"][at] = np.nan
    je.pool.tree = jax.tree.map(jnp.asarray, jtree)
    te.pool.tree["layers/k"][at] = float("nan")
    return e.page, e.snapshot, at


@pytest.mark.parametrize("threshold", [0.0, 1e9])
def test_dwell_gate_arms_and_snapshot_repair(models, threshold):
    """``dwell_threshold=0`` scrubs every hit: the NaN planted in a cached
    full page takes the snapshot's exact bits back.  A threshold no dwell
    reaches skips the scrub on reuse: the prefill kernel's read finds the
    NaN and the reactive scrub zero-fills it instead."""
    je, te = engine_pair(models, prefix_cache=True, dwell_threshold=threshold)
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    add_both(je, te, prompt, 4)
    lockstep(je, te)
    for _ in range(3):                      # the cached pages dwell
        assert je.step() == te.step()
    page, snap, at = _plant_in_cached_page(je, te)
    cont = te.results[0]["tokens"]
    add_both(je, te, cont + [17], 4)
    lockstep(je, te)
    assert_engines_equal(je, te)
    s = te.cache_stats()
    got = detect.bits_of(te.pool.tree["layers/k"][page])
    want = detect.bits_of(snap["layers/k"][0])
    if threshold == 0.0:
        assert s["reuse_skips"] == 0 and s["reuse_ref_repairs"] > 0
        assert s["reuse_scrubs"] > 0          # the partial tail, by detector
        assert torch.equal(got, want)
    else:
        assert s["reuse_skips"] > 0
        assert s["reuse_ref_repairs"] == s["reuse_scrubs"] == 0
        assert te.stats_dict()["nan_found"] == 1
        assert te.pool.tree["layers/k"][at].item() == 0.0
        diff = (got != want).nonzero().tolist()
        assert diff == [list(at[1:])]


def test_drain_interval_4_with_the_cache_matches_reference(models):
    """The desynchronized drain over chunked prefill with cache hits and
    a planted fault in a cached page under the always-scrub arm."""
    je, te = engine_pair(models, prefix_cache=True, dwell_threshold=0.0,
                         drain_interval=4, prefill_chunk=3)
    assert te._desync and je._desync
    add_both(je, te, SHARED + [9], 4)
    lockstep(je, te)
    _plant_in_cached_page(je, te)
    for prompt in (SHARED + [10], SHARED + [9, 11, 12], SHARED + [9]):
        add_both(je, te, prompt, 4)
    lockstep(je, te)
    assert_engines_equal(je, te)
    assert te.cache_stats()["hits"] == 3 and te.cache_stats()["reuse_ref_repairs"] > 0


def test_cache_off_reports_disabled(models):
    _, _, tm = models
    eng = Engine(tm, ServingConfig(**serving_kw()), device="cpu")
    eng.add_request([1, 2, 3], 2)
    eng.run()
    assert eng.cache_stats() == {"enabled": False, "prefill_tokens_saved": 0}


# -------------------------------------------------------------------- pool
def _pools(models, **kw):
    jm, _, tm = models
    cfg = serving_kw(**kw)
    return (JPagedKVPool(jm, JApproxSpace(mode="memory"), JServingConfig(**cfg)),
            PagedKVPool(tm, ApproxSpace(mode="memory"), ServingConfig(**cfg),
                        device="cpu"))


def test_pool_refcounts_share_and_double_free(models):
    _, pool = _pools(models)
    pages = pool.alloc(2)
    pool.share(pages[:1])                 # rc 2
    pool.free(pages)                      # rc 1, 0
    assert not pool.is_free(pages[0]) and pool.is_free(pages[1])
    assert pool.refcount(pages[0]) == 1
    pool.free(pages[:1])
    with pytest.raises(RuntimeError, match="double free"):
        pool.free(pages[:1])
    with pytest.raises(RuntimeError, match="sharing free page"):
        pool.share(pages[:1])
    with pytest.raises(ValueError, match="bad page"):
        pool.share([pool.null_page])


def test_pool_dwell_clock_and_copy_page(models):
    _, pool = _pools(models)
    src, dst = pool.alloc(2)
    pool.tree["layers/k"][src].normal_(generator=torch.Generator().manual_seed(0))
    pool.now = 5
    assert pool.dwell(src) == 5
    pool.copy_page(src, dst)              # the clone inherits the dwell stamp
    assert pool.dwell(dst) == 5
    pool.mark_clean([src])
    assert pool.dwell(src) == 0 and pool.dwell(dst) == 5
    for leaf in pool.tree.values():
        assert torch.equal(detect.bits_of(leaf[src]), detect.bits_of(leaf[dst]))
    assert pool.page_bytes * (pool.cfg.n_pages + 1) == pool.total_bytes


def test_expected_faults_is_linear_in_dwell():
    cfg = ApproxConfig(mode="memory", ber=1e-6)
    ref = JApproxConfig(mode="memory", ber=1e-6)
    for n, w, ber in ((1024, 1.0, None), (1024, 3.0, None), (4096, 0.0, None),
                      (1024, 2.0, 0.0), (2048, 5.0, 2e-4), (64, -1.0, None)):
        assert cfg.expected_faults(n, w, ber=ber) == ref.expected_faults(n, w, ber=ber)
    assert cfg.expected_faults(1024, 3.0) == pytest.approx(3 * 1024 * 8 * 1e-6)


def test_reference_repair_restores_snapshot_bits(models):
    """Fatal lanes of every leaf take the snapshot's exact bits (a NaN with
    a payload, -Inf, and a NaN in V); the page is stamped clean and charged
    one page row; counts, stats and bits equal the reference pool's."""
    jpool, pool = _pools(models)
    (page,) = pool.alloc(1)
    assert jpool.alloc(1) == [page]
    rng = np.random.default_rng(7)
    rows = {n: rng.standard_normal(pool.tree[f"layers/{n}"].shape[1:]).astype(np.float32)
            for n in ("k", "v")}
    for n, r in rows.items():
        pool.tree[f"layers/{n}"][page] = torch.from_numpy(r)
    jpool.tree = {"layers": {n: jnp.asarray(jpool.tree["layers"][n]).at[page].set(r)
                             for n, r in rows.items()}}
    snap, jsnap = pool.snapshot_page(page), jpool.snapshot_page(page)
    plants = {("k", (0, 1, 0, 3)): np.float32(np.nan).view(np.uint32) | 0x1234,
              ("k", (1, 2, 1, 0)): np.float32(-np.inf).view(np.uint32),
              ("v", (1, 3, 0, 15)): np.float32(np.nan).view(np.uint32)}
    jtree = jax.tree.map(np.array, jpool.tree)
    for (n, at), bits in plants.items():
        val = np.uint32(bits).view(np.float32)
        jtree["layers"][n][(page,) + at] = val
        pool.tree[f"layers/{n}"][(page,) + at] = torch.tensor(val)
    jpool.tree = jax.tree.map(jnp.asarray, jtree)
    for p in (pool, jpool):
        p.now = 9
    stats = pool.reference_repair_page(page, snap, stats_lib.zeros())
    jstat = jpool.reference_repair_page(page, jsnap, jstats.zeros())
    assert stats == {k: int(v) for k, v in jstats.as_dict(jstat).items()}
    assert stats["nan_found"] == 2 and stats["inf_found"] == 1
    assert pool.dwell(page) == 0
    assert pool.scrubbed_bytes == jpool.scrubbed_bytes == pool.page_bytes
    assert pool.space.scrubbed_bytes == jpool.space.scrubbed_bytes
    assert pool.space.rule_stats() == jpool.space.rule_stats()
    for n, r in rows.items():
        got = detect.bits_of(pool.tree[f"layers/{n}"][page])
        assert torch.equal(got, detect.bits_of(snap[f"layers/{n}"][0]))
        assert torch.equal(got, detect.bits_of(torch.from_numpy(r)))


def test_snapshot_is_a_host_copy_that_survives_recycling(models):
    _, pool = _pools(models)
    (page,) = pool.alloc(1)
    pool.tree["layers/v"][page] = 3.0
    snap = pool.snapshot_page(page)
    pool.free([page])
    again = pool.alloc(pool.cfg.n_pages)          # zeroes every page
    assert page in again
    assert snap["layers/v"].device.type == "cpu"
    assert bool((snap["layers/v"] == 3.0).all())
    assert not bool(pool.tree["layers/v"][page].any())


def test_serving_config_keeps_the_references_checks():
    with pytest.raises(ValueError, match="max_cached_pages"):
        ServingConfig(n_pages=8, max_cached_pages=9)
    with pytest.raises(ValueError, match="max_cached_pages"):
        ServingConfig(max_cached_pages=-1)
    ours, ref = ServingConfig(), JServingConfig()
    for field in ("prefix_cache", "max_cached_pages", "dwell_threshold",
                  "host_pages", "swap_policy"):
        assert getattr(ours, field) == getattr(ref, field), field
    assert ServingConfig(prefix_cache=True, host_pages=4).prefix_cache
