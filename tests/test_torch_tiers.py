"""Port parity of the host KV tier: swap round trips are bit-identical at
BER 0; under planted faults a swapped-in page equals the page the detector
scrubbed, and the crossing is charged to the tier's ledger and the space's;
the host copy survives recycling of the device page; the store's and the
pool's guards raise.  On the engine, in f32 against the JAX engine step for
step: a preemption storm with swap gives the recompute arm's tokens and the
reference's ``tier_stats()``, a full host store falls back to recompute,
and prefix-cache entries demote to the tier and promote back."""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import detect  # noqa: E402
from repro_torch.core import stats as stats_lib  # noqa: E402
from repro_torch.runtime import ApproxSpace  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    Engine, PagedKVPool, ServingConfig, TierManager,
)
from test_torch_prefix_cache import (  # noqa: E402, F401 (models: a fixture)
    assert_engines_equal, cache_off_tokens, engine_pair, models, serve_script,
    serving_kw,
)


def _tiers(models, host_pages=6, **kw):
    _, _, tm = models
    space = ApproxSpace(mode="memory")
    cfg = ServingConfig(**serving_kw(n_pages=10, host_pages=host_pages, **kw))
    pool = PagedKVPool(tm, space, cfg, device="cpu")
    return pool, space, TierManager(pool, space, cfg)


def _random_views(pool, n, seed):
    g = torch.Generator().manual_seed(seed)
    return {path: torch.randn((n,) + tuple(leaf.shape[1:]), generator=g)
            for path, leaf in pool.tree.items()}


def _assert_bits_equal(a, b):
    assert a.keys() == b.keys()
    for path in a:
        assert torch.equal(detect.bits_of(a[path]), detect.bits_of(b[path])), path


def test_swap_round_trip_is_bit_identical(models):
    pool, _, tiers = _tiers(models)
    pages = pool.alloc(3)
    pool.write_pages(pages, _random_views(pool, 3, seed=1))
    before = pool.pages_view(pages)
    handle = tiers.swap_out(pages)
    assert handle is not None and handle.n_pages == 3
    pool.free(pages)
    churn = pool.alloc(5)                  # the freed pages, recycled
    pool.write_pages(churn, _random_views(pool, 5, seed=2))
    pool.free(churn)
    fresh = pool.alloc(3)
    tiers.swap_in(handle, fresh)
    _assert_bits_equal(before, pool.pages_view(fresh))
    assert tiers.host.n_used == 0
    assert tiers.swap_outs == tiers.swap_ins == 1
    assert tiers.swapped_pages_out == tiers.swapped_pages_in == 3


def test_swap_in_equals_the_detector_scrubbed_page(models):
    """The same poisoned rows in two pages: one goes through the tier, the
    other is scrubbed in place; their bits are equal and finite, and the
    crossing is charged to the tier's ledger and to the space's."""
    pool, space, tiers = _tiers(models)
    p0, p1 = pool.alloc(2)
    poisoned = _random_views(pool, 1, seed=3)
    for leaf in poisoned.values():
        leaf[0, 0, 1, 0, 3] = float("nan")
        leaf[0, 1, 0, 1, 0] = float("inf")
    pool.write_pages([p0], poisoned)
    pool.write_pages([p1], poisoned)
    pool.now = 7
    assert pool.dwell(p0) == 7
    handle = tiers.swap_out([p0])
    pool.free([p0])
    fresh = pool.alloc(1)
    tiers.swap_in(handle, fresh)
    pool.scrub_pages([p1], stats_lib.zeros(), trigger="boundary")
    swapped = pool.pages_view(fresh)
    _assert_bits_equal(swapped, pool.pages_view([p1]))
    for leaf in swapped.values():
        assert bool(torch.isfinite(leaf).all())
    assert tiers.boundary_scrub_bytes == pool.page_bytes
    assert pool.scrubbed_bytes == 2 * pool.page_bytes
    assert space.scrubbed_bytes == 2 * pool.page_bytes
    d = space.stats_dict()
    assert d["nan_found"] == 2 and d["inf_found"] == 2
    assert pool.dwell(fresh[0]) == 0       # re-stamped clean


def test_host_copy_survives_recycling_and_shared_refcounts(models):
    pool, _, tiers = _tiers(models)
    (page,) = pool.alloc(1)
    pool.write_pages([page], _random_views(pool, 1, seed=5))
    expected = pool.pages_view([page])
    pool.share([page])
    handle = tiers.swap_out([page])
    pool.free([page])                      # rc 1: still resident
    assert not pool.is_free(page)
    pool.write_pages([page], _random_views(pool, 1, seed=6))
    pool.free([page])                      # rc 0: recycled
    with pytest.raises(RuntimeError, match="double free"):
        pool.free([page])
    fresh = pool.alloc(1)
    tiers.swap_in(handle, fresh)
    _assert_bits_equal(expected, pool.pages_view(fresh))


def test_host_store_and_pool_guards(models):
    pool, _, tiers = _tiers(models, host_pages=2)
    pages = pool.alloc(3)
    one = pool.pages_view([pages[2]])
    assert tiers.swap_out(pages) is None   # too big: a recompute fallback
    assert tiers.recompute_fallbacks == 1
    handle = tiers.swap_out(pages[:2])
    assert handle is not None and tiers.host.n_free == 0
    with pytest.raises(RuntimeError, match="host store full"):
        tiers.host.put(one, 1)
    assert tiers.demote_page(pages[2]) is None
    assert tiers.stash_views(one) is None
    tiers.host.free(handle.slots)
    with pytest.raises(RuntimeError, match="double free"):
        tiers.host.free(handle.slots)
    with pytest.raises(RuntimeError, match="freed host slot"):
        tiers.host.get(handle.slots)
    with pytest.raises(ValueError, match="bad host slot"):
        tiers.host.free([99])
    pool.free(pages)
    with pytest.raises(RuntimeError, match="free page"):
        pool.write_pages([pages[2]], one)
    with pytest.raises(ValueError, match="bad page"):
        pool.write_pages([pool.null_page + 1], one)


def test_host_store_layout():
    """One row per slot in the pool's leaf layout, in plain CPU tensors for
    a pool on the CPU (pinned ones for a pool on the card)."""
    from repro_torch.serving import HostPageStore

    tree = {"layers/k": torch.zeros(5, 2, 4, 2, 16),
            "layers/v": torch.zeros(5, 2, 4, 2, 16, dtype=torch.bfloat16)}
    store = HostPageStore(tree, 3)
    for path, buf in store._buffers.items():
        assert buf.shape == (3, 2, 4, 2, 16) and buf.dtype == tree[path].dtype
        assert buf.device.type == "cpu" and not buf.is_pinned()


# ------------------------------------------------------------------ engine
def _storm_script():
    """8 requests over a 10-page pool: page pressure makes preemptions."""
    rng = np.random.default_rng(0)
    return [[(rng.integers(1, 96, size=5 + i % 3).tolist(), 6) for i in range(8)]]


@pytest.mark.parametrize("arm", [
    dict(host_pages=12),                   # every victim swaps
    dict(host_pages=12, paged_decode="off"),   # the same on the gathered path
    dict(host_pages=1),                    # the store is too small: recompute
])
def test_preemption_storm_matches_reference(models, arm):
    kw = dict(n_pages=10, sweep_interval=8, sweep_pages=2, prefill_chunk=3, **arm)
    je, te = engine_pair(models, **kw)
    script = _storm_script()
    serve_script(je, te, script)
    assert_engines_equal(je, te)
    ts = te.tier_stats()
    kw.pop("host_pages")
    recompute = cache_off_tokens(models, script, **kw)
    assert {rid: r["tokens"] for rid, r in te.results.items()} == recompute
    assert te.metrics()["n_preemptions"] > 0 and ts["host_used"] == 0
    if arm["host_pages"] > 1:
        assert ts["n_swap_preemptions"] > 0 and ts["recompute_fallbacks"] == 0
        assert ts["swap_outs"] == ts["swap_ins"] > 0
        assert ts["swapped_pages_out"] == ts["swapped_pages_in"] > 0
        assert te.prefill_tokens_recomputed == 0
        assert 0 < ts["boundary_scrub_bytes"] <= te.space.scrubbed_bytes
    else:
        assert ts["recompute_fallbacks"] > 0 and ts["swap_outs"] == 0
        assert te.prefill_tokens_recomputed > 0


def test_recompute_policy_and_tier_off_report_as_the_reference(models):
    _, _, tm = models
    for kw in (dict(host_pages=12, swap_policy="recompute"), {}):
        eng = Engine(tm, ServingConfig(**serving_kw(n_pages=10, **kw)), device="cpu")
        for prompt, max_new in _storm_script()[0]:
            eng.add_request(prompt, max_new)
        eng.run()
        ts = eng.tier_stats()
        assert ts["enabled"] == bool(kw) and ts["n_swap_preemptions"] == 0
        assert eng.sched.n_preemptions > 0 and eng.prefill_tokens_recomputed > 0
        if kw:
            assert ts["swap_outs"] == ts["swap_ins"] == 0
        else:
            assert ts == {"enabled": False, "swap_policy": "swap",
                          "n_swap_preemptions": 0,
                          "prefill_tokens_recomputed": eng.prefill_tokens_recomputed}


def test_cache_demotes_and_promotes_through_the_tier(models):
    """LRU eviction parks cold entries in the host tier; a later hit on the
    parked prefix promotes them back and still skips its prefill; the
    tokens are the cache-off engine's."""
    a, b = [1, 2, 3, 4, 5, 6, 7, 8], [11, 12, 13, 14, 15, 16, 17, 18]
    script = [[(a + [9], 3)], [(b + [19], 3)], [(a + [10], 3)]]
    je, te = engine_pair(models, prefix_cache=True, max_cached_pages=2,
                         host_pages=8)
    serve_script(je, te, script)
    assert_engines_equal(je, te)
    s, ts = te.cache_stats(), te.tier_stats()
    assert s["demotions"] > 0 and s["promotions"] > 0 and s["evictions"] > 0
    assert te.prefill_tokens_saved > 0
    assert ts["demotions"] == s["demotions"] and ts["promotions"] == s["promotions"]
    assert {rid: r["tokens"] for rid, r in te.results.items()} == \
        cache_off_tokens(models, script)
