"""Port parity of the serving engine: the JAX engine (Pallas kernels in
interpret mode) and the PyTorch engine (plain versions on the CPU) serve
identical requests from identical weights, with identical faults planted in
both pools mid-run.  Tokens, ``page_events``, ``stats_dict()``,
``rule_stats()``, ``scrubbed_bytes``, the kernel counter totals and the
host-sync count must be identical; the pools stay within rtol = atol = 1e-5
(f32; the two sum in different orders).  The cases cover the paged paths,
the gathered-view fallback (decode and prefill, ``repair="off"``, a
``neighbor_mean`` space, a register-mode model) and the desynchronized
stats drain."""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import tiny_transformer  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.runtime import ApproxConfig as JApproxConfig  # noqa: E402
from repro.runtime import ApproxSpace as JApproxSpace  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServingConfig as JServingConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.runtime import ApproxConfig, ApproxSpace  # noqa: E402
from repro_torch.serving import Engine, ServingConfig  # noqa: E402


def tiny_cfg(repair=None):
    return dataclasses.replace(
        get_config("qwen2-1.5b").reduced(),
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=97, repair=repair or ApproxConfig(mode="off"),
    )


@pytest.fixture(scope="module")
def models():
    jm, jp = tiny_transformer()
    tm = convert.params_from_jax(jax.tree.map(np.asarray, jp), tiny_cfg(), device="cpu")
    return jm, jp, tm


CASES = {
    # 6 requests over a 10-page pool: admission control and preemption live
    "preempt": dict(page_size=4, n_pages=10, max_batch=4, max_pages_per_request=5,
                    seed=3),
    # an 8-page block table resolves to 4 split-K cells (a fixed prefill
    # chunk width keeps the reference to one compiled prefill)
    "splitk": dict(page_size=2, n_pages=24, max_batch=3, max_pages_per_request=8,
                   prefill_chunk=4),
    # chunked prefill interleaved with decode, plus the background sweep
    "chunked_sweep": dict(page_size=4, n_pages=12, max_batch=3,
                          max_pages_per_request=4, prefill_chunk=3,
                          sweep_interval=3, sweep_pages=2),
    "whole": dict(page_size=4, n_pages=10, max_batch=4, max_pages_per_request=4,
                  repair="whole", prefill_chunk=4),
    # the gathered-view fallback: probe, scrub, then Model.serve_step over
    # pool.gather / pool.scatter (prefill and decode), with the sweep
    "gathered": dict(page_size=4, n_pages=10, max_batch=4, max_pages_per_request=4,
                     paged_decode="off", sweep_interval=3, sweep_pages=2),
    # gathered prefill (with its admission probe), paged decode
    "gathered_prefill": dict(page_size=4, n_pages=12, max_batch=3,
                             max_pages_per_request=4, paged_prefill="off"),
    # the no-repair arm: nothing probes, scrubs or repairs on read
    "repair_off": dict(page_size=4, n_pages=10, max_batch=4,
                       max_pages_per_request=4, repair="off"),
    # a fill with no kernel form: the engine's space forces the fallback
    "neighbor_mean": dict(page_size=4, n_pages=10, max_batch=4,
                          max_pages_per_request=4),
    # a register-mode model (NaN planted in one weight): use-site repair of
    # every weight and of the gathered cache
    "register": dict(page_size=4, n_pages=10, max_batch=4, max_pages_per_request=4),
    # the desynchronized drain over chunked prefill and split-K decode
    "desync2": dict(page_size=4, n_pages=12, max_batch=3, max_pages_per_request=4,
                    prefill_chunk=3, drain_interval=2),
}
# the engine's runtime where it is not the default engine_space
SPACES = {"neighbor_mean": dict(mode="memory", policy="neighbor_mean")}
# which pool each case's first decode takes: paged (kernels) or gathered
PAGED = {"preempt", "splitk", "chunked_sweep", "whole", "gathered_prefill",
         "desync2"}


def _engines(models, case):
    """The JAX engine and the port's for ``case``: for "register", both
    models in register mode with a NaN in layer 1's ``w_up``."""
    jm, jp, tm = models
    kw = CASES[case]
    if case == "register":
        jm = jbuild_model(dataclasses.replace(
            jm.cfg, repair=JApproxConfig(mode="register")))
        jp = jax.tree.map(np.array, jp)
        jp["layers"]["mlp"]["w_up"][1, 3, 5] = np.nan
        tm = convert.params_from_jax(
            jp, tiny_cfg(ApproxConfig(mode="register")), device="cpu")
    jspace = tspace = None
    if case in SPACES:
        jspace, tspace = JApproxSpace(**SPACES[case]), ApproxSpace(**SPACES[case])
    return (JEngine(jm, jp, JServingConfig(**kw), space=jspace),
            Engine(tm, ServingConfig(**kw), space=tspace, device="cpu"))


def _plant(je, te, step):
    """The same faults in both pools: a K NaN and a V Inf in the first
    running request's pages, a NaN in the null page, and one in a cold
    page only the sweep (or the whole-pool scrub) can see."""
    tree = convert.cache_to_numpy(te.pool.tree)
    jtree = jax.tree.map(np.array, je.pool.tree)
    for name in ("k", "v"):
        np.testing.assert_allclose(tree["layers"][name], jtree["layers"][name],
                                   rtol=1e-5, atol=1e-5)
    run = sorted(je.sched.running, key=lambda r: r.rid)
    page = run[0].pages[0] if run else 0
    null = je.pool.null_page
    jtree["layers"]["k"][page, 0, 1, 0, 3] = np.nan
    jtree["layers"]["v"][page, 1, 0, 1, 5] = np.inf
    jtree["layers"]["v"][null, 1, 1, 0, 0] = np.nan
    used = {p for r in je.sched.running for p in r.pages}
    cold = [p for p in range(je.cfg.n_pages) if p not in used]
    if cold:
        jtree["layers"]["k"][cold[-1], 1, 0, 0, step] = -np.inf
    je.pool.tree = jax.tree.map(jnp.asarray, jtree)
    convert.cache_from_jax(te.pool.tree, jtree)


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_reference_under_planted_faults(models, case):
    kw = CASES[case]
    je, te = _engines(models, case)
    assert (te.paged_plan is not None) == (je._paged_fn is not None) == (case in PAGED)
    assert te._paged_prefill == (je._prefill_fn is not None)
    assert te._desync == je._desync
    rng = np.random.default_rng(0)
    max_seq = kw["page_size"] * kw["max_pages_per_request"]
    for i in range(6):
        prompt = rng.integers(1, 96, size=4 + i % 4)
        max_new = min(6, max_seq - len(prompt))
        assert je.add_request(prompt, max_new) == te.add_request(prompt, max_new)
    step = 0
    while je.has_work:
        a, b = je.step(), te.step()
        assert a == b, (case, step)
        if step in (1, 4):
            _plant(je, te, step)
        if step == 2:        # an externally run kernel's counters, routed back
            counts = np.array([1, 0, 1, 0, 2, 1, 2, 0], np.int32)
            je.record_kernel(jnp.asarray(counts))
            te.record_kernel(counts)
        step += 1
    assert not te.has_work
    assert te.results.keys() == je.results.keys()
    for rid, res in je.results.items():
        assert te.results[rid] == res
    np.testing.assert_array_equal(te.pool.page_events, je.pool.page_events)
    assert te.stats_dict() == je.stats_dict()
    assert te.rule_stats() == je.rule_stats()
    assert te.pool.scrubbed_bytes == je.pool.scrubbed_bytes
    np.testing.assert_array_equal(te.kernel_counts, je.kernel_counts)
    assert te.n_host_syncs == je.n_host_syncs
    jm_, tm_ = je.metrics(), te.metrics()
    for key in ("tokens_emitted", "n_preemptions", "scrub_calls", "split_k",
                "prefill_tokens_recomputed", "reactive_scrubs", "sweep_scrubs",
                "hot_pages", "paged_kernel_events", "paged_decode",
                "paged_prefill", "pool_gathers", "pool_scatters",
                "drain_interval", "n_host_syncs"):
        assert tm_[key] == jm_[key], key
    assert (tm_["pool_gathers"] > 0) == (case not in PAGED or case == "gathered_prefill")
    if case == "repair_off":     # only the routed counter vector's NaN
        assert tm_["scrub_calls"] == 0 and te.stats_dict()["nan_found"] == 1
    else:
        assert te.stats_dict()["nan_found"] > 0
    if case == "preempt":
        assert tm_["n_preemptions"] > 0
    if case == "splitk":
        assert tm_["split_k"] == 4


def test_injection_counts_flips_and_serves(models):
    """The injection arm: flips land in the stats, the run completes.  The
    flip stream differs from the reference's (another PRNG), so nothing is
    compared bit for bit here."""
    _, _, tm = models
    te = Engine(tm, ServingConfig(page_size=4, n_pages=10, max_batch=2,
                                  max_pages_per_request=4, ber=1e-3), device="cpu")
    for i in range(3):
        te.add_request(list(range(1, 6 + i)), max_new=4)
    te.run()
    assert te.stats_dict()["flips"] > 0
    assert all(len(r["generated"]) == 4 for r in te.results.values())


def test_default_device_is_the_card(models, monkeypatch):
    """Entry points default to CUDA and raise, never fall back, without it."""
    from repro_torch.models import TransformerLM
    from repro_torch.serving import PagedKVPool

    _, _, tm = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(tm, ServingConfig(page_size=4, n_pages=8, max_batch=2,
                                 max_pages_per_request=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TransformerLM(tiny_cfg())
    space = ApproxSpace(mode="memory", policy="zero")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedKVPool(tm, space, ServingConfig(page_size=4, n_pages=8, max_batch=2,
                                             max_pages_per_request=4))


def test_configurations_needing_the_gathered_fallback_raise(models):
    """The gathered fallback serves ``repair="off"`` and fills without a
    kernel form (the parity cases above); a mesh-native space still
    raises."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ApproxSpace(mesh=object())
