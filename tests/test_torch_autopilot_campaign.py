"""Port parity of the autopilot's runs against the JAX reference on the
CPU: ``run_campaign`` (serve and train episodes, f32) under one planting
function patched into ``ApproxSpace.inject`` of both packages, the
campaign at a real BER (Poisson flip counts, a repeated campaign
identical), the serving engine's online guard against the JAX engine under
identical planted faults on the gathered path, the paged lane and the
desynchronized drain, and ``train_loop``'s guard.

The planting function replaces the injection window in both packages:
window ``c`` (the c-th call in the run) draws, from ``numpy`` seeded by
``c``, two lanes of every approximate float leaf the mask leaves
approximate (sorted by path), each set to NaN, ±Inf, a value the range
guard catches (3e3) or a legal drift value (40.0), and reports the lanes
as the window's flips.  The two campaigns then see the same faults at
the same paths, and the port's prompt and batch helpers are patched with
the reference's ``jax.random`` arrays.

Tolerance: integer outputs and serve ``quality`` (a token-agreement rate)
are equal; the train ``loss_delta`` within ``LOSS_ATOL`` (both packages sum
the f32 losses and gradients in different orders; measured ~1e-7)."""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import tiny_transformer  # noqa: E402
from repro import autopilot as jauto  # noqa: E402
from repro.configs import get_preset as jget_preset  # noqa: E402
from repro.core import regions as jregions  # noqa: E402
from repro.core import stats as jstats  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.runtime import ApproxConfig as JApproxConfig  # noqa: E402
from repro.runtime import ApproxSpace as JApproxSpace  # noqa: E402
from repro.runtime import AutopilotConfig as JAutopilotConfig  # noqa: E402
from repro.core.rules import Detector as JDetector  # noqa: E402
from repro.core.rules import RepairRule as JRepairRule  # noqa: E402
from repro.core.rules import RuleSet as JRuleSet  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServingConfig as JServingConfig  # noqa: E402
from repro_torch import autopilot as tauto  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.autopilot import campaign as tcampaign  # noqa: E402
from repro_torch.configs import get_preset  # noqa: E402
from repro_torch.core import stats as tstats  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.runtime import ApproxConfig, ApproxSpace, AutopilotConfig  # noqa: E402
from repro_torch.runtime import Detector, RepairRule, RuleSet  # noqa: E402
from repro_torch.serving import Engine, ServingConfig  # noqa: E402
from test_torch_engine import _plant, tiny_cfg  # noqa: E402

LOSS_ATOL = 1e-5
VALUES = (np.nan, np.inf, -np.inf, 3e3, 40.0)


@pytest.fixture(scope="module")
def models():
    jm, jp = tiny_transformer()
    tm = convert.params_from_jax(jax.tree.map(np.asarray, jp), tiny_cfg(), device="cpu")
    return jm, jp, tm


# ------------------------------------------------------- the planting
def _lanes(call, shapes):
    """[(path, flat index, value)]: two lanes per leaf of ``shapes``."""
    rng = np.random.default_rng(call)
    return [(path, int(rng.integers(int(np.prod(shape)))),
             VALUES[int(rng.integers(len(VALUES)))])
            for path, shape in sorted(shapes.items()) for _ in range(2)]


def _is_float(v):
    if isinstance(v, torch.Tensor):
        return v.is_floating_point()
    return v.dtype.kind == "f"


def _planting(pkg, calls):
    """An ``ApproxSpace.inject`` for ``pkg`` ("jax" | "torch") that plants
    ``_lanes(len(calls))`` where the mask is approximate; each call's
    lanes are appended to ``calls``."""

    def inject(self, tree, key, ber=None, *, stats=None, record=True,
               regions=None, **_):
        if pkg == "torch":
            flat, masks = tree, regions if regions is not None else self.regions_for(tree)
        else:
            leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
            masks = regions if regions is not None else self.regions_for(tree)
            flat = {jregions.path_str(p): np.array(v) for p, v in leaves}
            masks = dict(zip(flat, jax.tree.leaves(masks)))
        shapes = {p: tuple(v.shape) for p, v in flat.items()
                  if masks[p].value == "approx" and _is_float(v)}
        lanes = _lanes(len(calls), shapes)
        calls.append(lanes)
        with torch.no_grad():
            for path, i, value in lanes:
                flat[path].reshape(-1)[i] = value
        if pkg == "jax":
            tree = jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(tree),
                [jnp.asarray(flat[jregions.path_str(p)]) for p, _ in leaves])
        n = len(lanes)
        lib = tstats if pkg == "torch" else jstats
        if stats is not None:
            return tree, lib.record_flips(stats, n)
        if record:
            self.stats = lib.record_flips(self.stats, n)
        return tree, n

    return inject


def _campaign_cfg(auto, episode, preset_groups):
    groups = preset_groups
    if episode == "train":      # the weights, and moments under a zero fill
        groups = (groups[0], auto.RegionGroup(name="attn_moments",
                                              pattern=r"opt/(mu|nu)/layers/attn/"))
    if episode == "serve":
        return auto.CampaignConfig(groups=groups, refresh_points=(1.0, 4.0),
                                   steps=4, batch=2, prompt_len=4, seed=0)
    return auto.CampaignConfig(groups=groups, refresh_points=(4.0,),
                               episode="train", steps=3, batch=2, seq_len=8,
                               seed=0)


@pytest.mark.parametrize("episode", ["serve", "train"])
def test_campaign_matches_the_reference_under_planted_faults(models, episode,
                                                             monkeypatch):
    jm, jp, tm = models
    jcfg = _campaign_cfg(jauto, episode, jget_preset("transformer").campaign.groups)
    tcfg = _campaign_cfg(tauto, episode, get_preset("transformer").campaign.groups)
    vocab = jm.cfg.vocab
    prompts = np.asarray(jax.random.randint(
        jax.random.PRNGKey(jcfg.seed + 7), (jcfg.batch, jcfg.prompt_len), 1, vocab))
    batches = [np.asarray(jax.random.randint(
        jax.random.fold_in(jax.random.PRNGKey(jcfg.seed + 11), i),
        (jcfg.batch, jcfg.seq_len), 1, vocab)) for i in range(jcfg.steps)]
    monkeypatch.setattr(tcampaign, "_prompts", lambda cfg, v, device: torch.tensor(
        prompts, dtype=torch.int64, device=device))
    monkeypatch.setattr(tcampaign, "_train_batch", lambda cfg, v, i, device: {
        "tokens": torch.tensor(batches[i], dtype=torch.int64, device=device)})
    jcalls, tcalls = [], []
    monkeypatch.setattr(JApproxSpace, "inject", _planting("jax", jcalls))
    monkeypatch.setattr(ApproxSpace, "inject", _planting("torch", tcalls))

    before = {p: t.clone() for p, t in tm.param_tree().items()}
    jprof = jauto.run_campaign(jm, jcfg, params=jp)
    tprof = tauto.run_campaign(tm, tcfg)
    assert tcalls == jcalls and len(tcalls) > 0
    for p, t in tm.param_tree().items():         # the weights restored
        assert torch.equal(t, before[p]), p

    assert tprof.metric == jprof.metric and tprof.model == jprof.model
    assert len(tprof.cells) == len(jprof.cells) == len(tcfg.groups) * len(
        tcfg.refresh_points)
    for tc, jc in zip(tprof.cells, jprof.cells):
        for field in ("group", "refresh_s", "ber", "energy_saving", "flips",
                      "faults_per_step", "approx_bytes"):
            assert getattr(tc, field) == getattr(jc, field), (tc.group, field)
        if episode == "serve":
            assert tc.quality == jc.quality, tc
        else:
            assert abs(tc.quality - jc.quality) <= LOSS_ATOL, (tc, jc)
    assert all(c.faults_per_step > 0 for c in tprof.cells if c.approx_bytes)
    if episode == "serve":
        assert max(c.quality for c in tprof.cells) > 0
    # the port's profile and frontier as the reference writes them
    assert tauto.ToleranceProfile.from_json(tprof.to_json()) == tprof
    budget = get_preset("transformer").budget
    frontier = tauto.solve_frontier(tprof, budget)
    jfrontier = jauto.solve_frontier(
        jauto.ToleranceProfile.from_json(tprof.to_json()), budget)
    assert frontier.to_json() == jfrontier.to_json()


def test_campaign_at_a_real_ber_is_poisson_and_repeatable():
    """Unpatched: each cell's flips within 6 sigma of Poisson(windows x
    bits x BER) over its approximate bytes, and the campaign repeated
    (with the weights left as found) gives identical cells."""
    preset = get_preset("transformer", steps=3)
    cfg = dataclasses.replace(preset.campaign, refresh_points=(2.0, 4.0),
                              prompt_len=4)
    model = preset.build_model(device="cpu")
    p1 = tauto.run_campaign(model, cfg)
    p2 = tauto.run_campaign(model, cfg)
    assert p1.cells == p2.cells
    windows = cfg.prompt_len + cfg.steps - 1
    for c in p1.cells:
        lam = windows * c.approx_bytes * 8 * c.ber
        assert abs(c.flips - lam) <= 6 * np.sqrt(lam) + 1, c
    assert p1.cell("ffn_weights", 4.0).flips > 0
    # params= copies a tree into the model's tensors before profiling
    own = model.param_tree()
    params = {p: t.clone() for p, t in own.items()}
    with torch.no_grad():
        for t in own.values():
            t.zero_()
    assert tauto.run_campaign(model, cfg, params=params).cells == p1.cells
    assert all(torch.equal(own[p], params[p]) for p in own)


# -------------------------------------------------- the engine's guard
ENGINE_CASES = {
    "gathered": dict(paged_decode="off"),
    "paged": dict(paged_decode="auto"),
    "drain2": dict(paged_decode="auto", drain_interval=2),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_guard_matches_the_reference(models, case):
    """Faults planted after steps 1 and 4 (``_plant``) strike two windows
    of 2 steps: the guard trips stricter, then exact, in both engines,
    with the same tokens, page events, stats and rule stats."""
    jm, jp, tm = models
    kw = dict(page_size=4, n_pages=10, max_batch=4, max_pages_per_request=4,
              **ENGINE_CASES[case])
    auto = dict(window=2, tolerance=1.0, floor=0.0, patience=1, cooldown=0,
                expected=(("default", 0.0),))
    je = JEngine(jm, jp, JServingConfig(**kw, autopilot=JAutopilotConfig(**auto)))
    te = Engine(tm, ServingConfig(**kw, autopilot=AutopilotConfig(**auto)),
                device="cpu")
    assert te.guard is not None and te._desync == je._desync
    rng = np.random.default_rng(0)
    for i in range(4):
        prompt = rng.integers(1, 96, size=4 + i % 4)
        max_new = min(6, 16 - len(prompt))
        assert je.add_request(prompt, max_new) == te.add_request(prompt, max_new)
    step = 0
    while je.has_work:
        a, b = je.step(), te.step()
        assert a == b, (case, step)
        assert (te.paged_plan is not None) == (je._paged_fn is not None), step
        assert te._paged_prefill == (je._prefill_fn is not None), step
        assert te._desync == je._desync, step
        assert te.guard.trips == je.guard.trips, step
        if step in (1, 4):
            _plant(je, te, step)
        step += 1
    assert not te.has_work
    assert [t["action"] for t in te.guard.trips] == ["stricter", "exact"]
    assert te.space.ruleset.entries[0][1].exact
    for rid, res in je.results.items():
        assert te.results[rid] == res
    np.testing.assert_array_equal(te.pool.page_events, je.pool.page_events)
    assert te.stats_dict() == je.stats_dict()
    assert te.rule_stats() == je.rule_stats()
    assert te.pool.scrubbed_bytes == je.pool.scrubbed_bytes
    np.testing.assert_array_equal(te.kernel_counts, je.kernel_counts)
    tm_, jm_ = te.metrics(), je.metrics()
    for key in ("autopilot_trips", "tokens_emitted", "paged_decode",
                "paged_prefill", "n_host_syncs", "scrub_calls"):
        assert tm_[key] == jm_[key], key
    assert tm_["autopilot_trips"] == 2
    assert "guard" in tm_["stage_wall_s"]


def test_engine_without_autopilot_has_no_guard(models):
    _, _, tm = models
    eng = Engine(tm, ServingConfig(page_size=4, n_pages=16, max_batch=2,
                                   max_pages_per_request=4), device="cpu")
    assert eng.guard is None
    assert eng.metrics()["autopilot_trips"] == 0


# ------------------------------------------------------ train_loop's guard
def _resident_space(pkg):
    cfg, rules, rule = ((AutopilotConfig, RuleSet, RepairRule) if pkg == "torch"
                        else (JAutopilotConfig, JRuleSet, JRepairRule))
    det = (Detector if pkg == "torch" else JDetector)(nan=True, inf=True)
    approx = (ApproxConfig if pkg == "torch" else JApproxConfig)(
        mode="memory",
        rules=rules(((r"params/|opt/", rule(detect=det, fill="zero",
                                             trigger="boundary", label="resident")),)),
        autopilot=cfg(window=2, tolerance=1.0, floor=0.0, patience=1, cooldown=0,
                      expected=(("resident", 0.0),)),
    )
    return (ApproxSpace if pkg == "torch" else JApproxSpace)(approx)


def test_train_loop_guard_tightens_under_fault_pressure(models):
    """The reference's twin: ber=2e-3 against an expectation of 0 trips
    the guard, the deployed rule is stricter than the profiled one, and the
    loop trains on."""
    _, _, tm = models
    space = _resident_space("torch")
    gen = torch.Generator().manual_seed(3)
    batches = [torch.randint(1, 97, (2, 8), generator=gen) for _ in range(6)]
    state, history = ttrain.train_loop(
        tm, ttrain.make_optimizer(warmup=1, total=6),
        lambda i: {"tokens": batches[i]}, steps=6, ber=2e-3, space=space,
        log_every=0)
    trips = [h for h in history if "autopilot" in h]
    assert trips, "guard never tripped despite ber=2e-3 vs expected 0"
    assert trips[0]["autopilot"][0]["label"] == "resident"
    deployed = dict(space.ruleset.entries)[r"params/|opt/"]
    assert deployed.exact or deployed.detect.max_magnitude is not None
    assert "rule_counts" in state
    assert all(torch.isfinite(t).all() for p, t in state.items()
               if p.startswith("params/"))


def test_train_loop_guard_matches_the_reference(models, monkeypatch):
    """The same planted windows in both loops (``_planting``): the same
    decisions at the same steps, the same rule stats and deployed rule."""
    jm, jp, _ = models
    calls = {"jax": [], "torch": []}
    monkeypatch.setattr(JApproxSpace, "inject", _planting("jax", calls["jax"]))
    monkeypatch.setattr(ApproxSpace, "inject", _planting("torch", calls["torch"]))
    tokens = np.random.default_rng(5).integers(1, 97, size=(4, 2, 8))
    jspace, tspace = _resident_space("jax"), _resident_space("torch")
    tm = convert.params_from_jax(jax.tree.map(np.asarray, jp), tiny_cfg(), device="cpu")
    _, jhist = jtrain.train_loop(
        jm, jtrain.make_optimizer(warmup=1, total=4),
        lambda i: {"tokens": jnp.asarray(tokens[i])}, steps=4,
        key=jax.random.PRNGKey(0), ber=1e-3, space=jspace, log_every=0)
    state, thist = ttrain.train_loop(
        tm, ttrain.make_optimizer(warmup=1, total=4),
        lambda i: {"tokens": torch.as_tensor(tokens[i])}, steps=4, ber=1e-3,
        space=tspace, log_every=0)
    assert calls["torch"] == calls["jax"]
    assert thist == jhist
    assert [d["action"] for h in thist for d in h["autopilot"]] == ["stricter", "exact"]
    assert tspace.rule_stats() == jspace.rule_stats()
    assert [(p, tcampaign.rule_to_json(r)) for p, r in tspace.ruleset.entries] == \
        [(p, jauto.campaign.rule_to_json(r)) for p, r in jspace.ruleset.entries]
    assert tstats.as_dict(state["stats"])["flips"] == sum(map(len, calls["torch"]))
