"""Port parity of the autopilot's pure parts against the JAX reference on
the CPU: ``AutopilotConfig``, ``RuleSet.with_rule``,
``ApproxSpace.set_rules``, the region masks and the masked injection
(flips confined to the group), ``count_bytes``, the frontier solver (its
JSON string-equal to the reference's), the profile's JSON read by either
package, the online guard driven by one scripted counter sequence through
a stub space in both packages (identical decisions and rulesets), and the
presets.  Campaigns, the engine and the train loop with the guard are in
``tests/test_torch_autopilot_campaign.py``."""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses
import json
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import autopilot as jauto  # noqa: E402
from repro.configs import get_preset as jget_preset  # noqa: E402
from repro.core import regions as jregions  # noqa: E402
from repro.core import rules as jrules  # noqa: E402
from repro.core.injection import ApproxMemoryModel as JMemoryModel  # noqa: E402
from repro.runtime import ApproxConfig as JApproxConfig  # noqa: E402
from repro.runtime import ApproxSpace as JApproxSpace  # noqa: E402
from repro.runtime import AutopilotConfig as JAutopilotConfig  # noqa: E402
from repro_torch import autopilot as tauto  # noqa: E402
from repro_torch.configs import get_preset, preset_names  # noqa: E402
from repro_torch.core import regions as tregions  # noqa: E402
from repro_torch.core import rules as trules  # noqa: E402
from repro_torch.core.injection import ApproxMemoryModel  # noqa: E402
from repro_torch.runtime import ApproxConfig, ApproxSpace, AutopilotConfig  # noqa: E402

PKGS = {
    "jax": dict(auto=jauto, rules=jrules, cfg=JAutopilotConfig, mm=JMemoryModel),
    "torch": dict(auto=tauto, rules=trules, cfg=AutopilotConfig, mm=ApproxMemoryModel),
}


def weight_rule(rules):
    return rules.RepairRule(
        detect=rules.Detector(nan=True, inf=True, max_magnitude=1e3),
        fill="neighbor_mean", trigger="boundary",
    )


# ----------------------------------------------------------------- configs
def test_autopilot_config_validates_and_normalizes():
    cfg = AutopilotConfig(expected={"b": 1.0, "a": 0.5})
    ref = JAutopilotConfig(expected={"b": 1.0, "a": 0.5})
    assert cfg.expected == ref.expected == (("a", 0.5), ("b", 1.0))
    for label in ("a", "b", "missing"):
        assert cfg.expected_rate(label) == ref.expected_rate(label)
        assert cfg.threshold(label) == ref.threshold(label)
    assert cfg.threshold("b") == cfg.tolerance * 1.0 * cfg.window + cfg.floor
    for bad in (dict(window=0), dict(patience=0)):
        with pytest.raises(ValueError):
            AutopilotConfig(**bad)
    # the space's config carries it, and so does from_legacy
    space = ApproxSpace(ApproxConfig(autopilot=cfg), policy="zero")
    assert space.config.autopilot is cfg
    assert ApproxConfig.from_legacy(ApproxConfig(autopilot=cfg)).autopilot is cfg


def test_campaign_config_validation():
    g = tauto.RegionGroup(name="g", pattern="params/")
    for bad in (dict(groups=(), refresh_points=(1.0,)),
                dict(groups=(g,), refresh_points=()),
                dict(groups=(g, g), refresh_points=(1.0,)),
                dict(groups=(g,), refresh_points=(1.0,), episode="eval"),
                dict(groups=(g,), refresh_points=(1.0,), steps=1)):
        with pytest.raises(ValueError):
            tauto.CampaignConfig(**bad)


def test_autopilot_exports_the_references_names():
    assert tauto.__all__ == jauto.__all__
    assert tauto.NOMINAL_REFRESH_S == jauto.NOMINAL_REFRESH_S


# --------------------------------------------------- rule-swap primitives
def test_ruleset_with_rule_replaces_in_place_keeping_label_and_order():
    rs = trules.RuleSet((
        ("params/", trules.RepairRule(detect=trules.Detector(nan=True), label="w")),
        ("cache/", trules.RepairRule(detect=trules.Detector(nan=True), label="kv")),
    ))
    swapped = rs.with_rule("kv", trules.RepairRule.exact_rule())
    assert [r.label for _, r in swapped.entries] == ["w", "kv"]
    assert [p for p, _ in swapped.entries] == ["params/", "cache/"]
    assert swapped.entries[1][1].exact
    assert not rs.entries[1][1].exact             # original untouched
    assert swapped.digest() != rs.digest()
    with pytest.raises(KeyError):
        rs.with_rule("nope", trules.RepairRule.exact_rule())


def test_space_set_rules_swaps_digest_and_keeps_or_resets_counters():
    rs = trules.RuleSet((
        ("w", trules.RepairRule(detect=trules.Detector(nan=True), label="w")),
    ))
    space = ApproxSpace(ApproxConfig(mode="memory", rules=rs))
    tree = {"w": torch.ones(4, 4)}
    plan = space.plan_for(tree)
    space.record_rule_counts(np.asarray([[3, 1, 4], [0, 0, 0]], np.int64))
    before = space.rule_stats()["w"]
    d0 = space.ruleset.digest()
    space.set_rules(rs.with_rule("w", trules.RepairRule(
        detect=trules.Detector(nan=True, inf=True, max_magnitude=10.0), label="w",
    )))
    assert space.ruleset.digest() != d0
    assert space.rule_stats()["w"] == before      # same labels: ledger kept
    assert space.config.rules is space.ruleset
    assert space.plan_for(tree) is not plan       # caches cleared
    assert space.plan_for(tree).rules["w"].detect.max_magnitude == 10.0
    # a label change resets the ledger, as the reference's does
    relabeled = trules.RuleSet((("w", trules.RepairRule(label="other")),))
    space.set_rules(relabeled)
    assert space.rule_stats() == {
        "other": {"nan_found": 0, "inf_found": 0, "events": 0},
        "default": {"nan_found": 0, "inf_found": 0, "events": 0},
    }
    jspace = JApproxSpace(JApproxConfig(mode="memory", rules=jrules.RuleSet((
        ("w", jrules.RepairRule(detect=jrules.Detector(nan=True), label="w")),
    ))))
    jspace.record_rule_counts(jnp.asarray([[3, 1, 4], [0, 0, 0]], jnp.int32))
    jspace.set_rules(jrules.RuleSet((("w", jrules.RepairRule(label="other")),)))
    assert jspace.rule_stats() == space.rule_stats()


# ------------------------------------------------------------ region masks
def _trees():
    jtree = {
        "params": {"w": jnp.ones((64, 64))},
        "cache": {"k": jnp.ones((64, 64))},
        "step": jnp.zeros((), jnp.int32),
    }
    ttree = {p: torch.as_tensor(np.array(v)) for p, v in
             tregions.flatten(jax.tree.map(np.asarray, jtree)).items()}
    return jtree, ttree


@pytest.mark.parametrize("pattern", [r"cache/", r"params/", r"w$|k$"])
def test_group_regions_and_count_bytes_match_the_reference(pattern):
    jtree, ttree = _trees()
    groups = lambda auto: (auto.RegionGroup(name="g", pattern=pattern),)  # noqa: E731
    jspace, tspace = jauto.campaign_space(groups(jauto)), tauto.campaign_space(groups(tauto))
    jmask = jauto.group_regions(jspace, jtree, pattern)
    tmask = tauto.group_regions(tspace, ttree, pattern)
    flat = {
        jregions.path_str(p): r
        for (p, _), r in zip(jax.tree_util.tree_flatten_with_path(jtree)[0],
                             jax.tree.leaves(jmask))
    }
    assert {p: r.value for p, r in tmask.items()} == {p: r.value for p, r in flat.items()}
    assert tmask["step"] is tregions.Region.EXACT
    assert tregions.count_bytes(ttree, tmask) == jregions.count_bytes(jtree, jmask)
    assert tspace.region_bytes(ttree) == jspace.region_bytes(jtree)


def test_masked_injection_confines_flips_to_the_group():
    _, tree = _trees()
    clean = {p: t.clone() for p, t in tree.items()}
    space = tauto.campaign_space((
        tauto.RegionGroup(name="w", pattern=r"params/"),
        tauto.RegionGroup(name="k", pattern=r"cache/"),
    ))
    flips = {}
    for name, pattern in (("k", r"cache/"), ("w", r"params/")):
        mask = tauto.group_regions(space, tree, pattern)
        gen = torch.Generator().manual_seed(0)
        _, flips[name] = space.inject(tree, gen, 1e-3, record=False, regions=mask)
        assert flips[name] > 0
        for path, region in mask.items():
            changed = not torch.equal(tree[path], clean[path])
            assert changed == (region is tregions.Region.APPROX), (name, path)
            tree[path].copy_(clean[path])
    # one plan per mask: the second group's window did not reuse the first's
    assert len([k for k in space._plan_cache if k[0] == "inject"]) == 2
    assert space.stats_dict()["flips"] == 0       # record=False
    _, n = space.inject(tree, torch.Generator().manual_seed(0), 1e-3)
    assert space.stats_dict()["flips"] == n > 0


# ------------------------------------------------------------- the solver
def _profile(pkg, cells):
    auto, mm = PKGS[pkg]["auto"], PKGS[pkg]["mm"]
    groups = tuple(auto.RegionGroup(name=n, pattern=f"{n}/")
                   for n in sorted({c[0] for c in cells}))
    return auto.ToleranceProfile(
        model="m", episode="serve", metric="token_divergence",
        steps=4, seed=0, groups=groups,
        refresh_points=tuple(sorted({c[1] for c in cells})),
        cells=tuple(
            auto.ProfileCell(
                group=g, refresh_s=r, ber=mm.from_refresh(r).ber,
                energy_saving=mm.from_refresh(r).energy_saving, quality=q,
                flips=7, faults_per_step=f, approx_bytes=b,
            )
            for g, r, q, f, b in cells
        ),
    )


PROFILES = {
    "within_budget": ([("a", 0.256, 0.0, 0.5, 1024), ("a", 1.0, 0.1, 0.5, 1024),
                       ("a", 4.0, 0.9, 0.5, 1024)], 0.25),
    "collapsed": ([("a", 0.256, 0.0, 0.5, 1024), ("a", 1.0, 0.05, 0.5, 1024),
                   ("s", 0.256, 0.6, 0.5, 2048), ("s", 1.0, float("nan"), 0.5, 2048)],
                  0.25),
    "nonfinite": ([("a", 1.0, float("inf"), 1.5, 512), ("a", 2.0, float("nan"), 3.0, 512),
                   ("s", 1.0, 0.1, 0.25, 4096), ("s", 2.0, 0.3, 0.75, 4096)], 0.3),
}


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_frontier_matches_the_reference(name):
    cells, budget = PROFILES[name]
    tfr = tauto.solve_frontier(_profile("torch", cells), budget)
    jfr = jauto.solve_frontier(_profile("jax", cells), budget)
    assert tfr.to_json() == jfr.to_json()
    assert tfr.refresh_map() == jfr.refresh_map()
    assert tfr.energy_saving == jfr.energy_saving
    assert tfr.autopilot(window=3, floor=1.0) == AutopilotConfig(
        **dataclasses.asdict(jfr.autopilot(window=3, floor=1.0)))
    assert [(p, tauto.campaign.rule_to_json(r)) for p, r in tfr.ruleset().entries] == \
        [(p, jauto.campaign.rule_to_json(r)) for p, r in jfr.ruleset().entries]
    rt = tauto.FrontierAssignment.from_json(jfr.to_json())
    assert rt.to_json() == jfr.to_json()
    for a in tfr.assignments:
        if not a.collapsed:
            assert math.isfinite(a.quality) and a.quality <= budget
    if name == "collapsed":
        s = tfr.assignment("s")
        assert s.collapsed and s.refresh_s == tauto.NOMINAL_REFRESH_S
        assert dict(tfr.ruleset().entries)["s/"].exact
        assert 0.0 < tfr.energy_saving < tfr.assignment("a").energy_saving
    if name == "nonfinite":
        assert tfr.assignment("a").collapsed
        assert tfr.assignment("s").refresh_s == 2.0


def test_profile_json_loads_in_both_packages():
    cells = [("a", 1.0, 0.1, 0.5, 1024), ("s", 4.0, float("nan"), 0.0, 64)]
    tprof, jprof = _profile("torch", cells), _profile("jax", cells)
    groups = (tauto.RegionGroup(name="ffn", pattern=r"params/layers/mlp/",
                                rule=weight_rule(trules)),)
    tprof = dataclasses.replace(tprof, groups=tprof.groups + groups)
    jgroups = (jauto.RegionGroup(name="ffn", pattern=r"params/layers/mlp/",
                                 rule=weight_rule(jrules)),)
    jprof = dataclasses.replace(jprof, groups=jprof.groups + jgroups)
    assert tprof.to_json() == jprof.to_json()
    from_ref = tauto.ToleranceProfile.from_json(jprof.to_json())
    assert from_ref.to_json() == jprof.to_json()
    assert from_ref.groups[-1].rule == groups[0].rule
    assert jauto.ToleranceProfile.from_json(tprof.to_json()).to_json() == tprof.to_json()
    assert json.loads(tprof.to_json())["cells"][1]["group"] == "s"


# ------------------------------------------------------------- the guard
class _StubSpace:
    """A scripted ``rule_stats`` stream over one package's RuleSet."""

    def __init__(self, ruleset):
        self.ruleset = ruleset
        self.faults = {r.label: 0 for _, r in ruleset.entries}
        self.swaps = []

    def rule_stats(self):
        return {label: {"nan_found": n, "inf_found": n // 3, "events": n}
                for label, n in self.faults.items()}

    def set_rules(self, ruleset):
        self.ruleset = ruleset
        self.swaps.append(ruleset)
        return self


# (faults added to each label before a call, "tick" or "observe")
SCRIPTS = {
    # patience 2: one strike, a reset by a clean window, two strikes trip
    "patience_reset": (dict(window=2, patience=2, cooldown=1, floor=0.5), [
        ({"g": 5}, "observe"), ({}, "observe"), ({"g": 5}, "observe"),
        ({"g": 5}, "observe"), ({"g": 50}, "observe"), ({"g": 5}, "observe"),
        ({"g": 5}, "observe"), ({"g": 9, "h": 40}, "observe"),
    ]),
    # patience 1, cooldown 2: a trip, two ignored windows, armed again
    "cooldown": (dict(window=2, patience=1, cooldown=2, floor=0.5), [
        ({"g": 5}, "observe"), ({"g": 50}, "observe"), ({"g": 50}, "observe"),
        ({"g": 50}, "observe"), ({"g": 50, "h": 3}, "observe"),
    ]),
    # the ladder: stricter, stricter (range guard), exact, nothing left
    "ladder": (dict(window=2, patience=1, cooldown=0, floor=0.0), [
        ({"g": 1}, "observe"), ({"g": 1}, "observe"), ({"g": 1, "h": 2}, "observe"),
        ({"g": 1, "h": 2}, "observe"), ({"g": 1, "h": 2}, "observe"),
    ]),
    # tick observes every third call
    "tick": (dict(window=3, patience=1, cooldown=0, floor=0.5), [
        ({"g": 5}, "tick"), ({}, "tick"), ({"h": 4}, "tick"), ({"h": 13}, "tick"),
        ({}, "tick"), ({"h": 1}, "tick"), ({"h": 30}, "tick"), ({}, "tick"),
        ({}, "tick"),
    ]),
    # h's threshold is 2.0 x 1.0 x 2 + 0.5 = 4.5: 4 a window never trips
    "within": (dict(window=2, patience=1, cooldown=0, floor=0.5, tolerance=2.0),
               [({"h": 3}, "observe")] * 5),
}


def _guard_run(pkg, kw, script):
    rules, auto = PKGS[pkg]["rules"], PKGS[pkg]["auto"]
    ruleset = rules.RuleSet((
        ("g/", rules.RepairRule(detect=rules.Detector(nan=True, inf=False),
                                fill="zero", trigger="reactive", label="g")),
        ("h/", rules.RepairRule(detect=rules.Detector(nan=True, inf=True),
                                fill=0.5, trigger="boundary", label="h")),
    ))
    space = _StubSpace(ruleset)
    cfg = PKGS[pkg]["cfg"](**{"tolerance": 1.0, **kw},
                           expected={"h": 1.0, "g": 0.0})
    guard = auto.OnlineGuard(space, cfg)
    decisions, rulesets = [], []
    for add, call in script:
        for label, n in add.items():
            space.faults[label] += n
        decisions.append(getattr(guard, call)())
        rulesets.append([(p, auto.campaign.rule_to_json(r))
                         for p, r in space.ruleset.entries])
    return decisions, rulesets, guard.summary(), guard.trips


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_guard_decisions_match_the_reference(name):
    kw, script = SCRIPTS[name]
    got = _guard_run("torch", kw, script)
    want = _guard_run("jax", kw, script)
    assert got == want
    decisions, rulesets, summary, trips = got
    if name == "patience_reset":
        assert [len(d) for d in decisions[:4]] == [0, 0, 0, 1]
    if name == "cooldown":
        assert [len(d) for d in decisions] == [1, 0, 0, 1, 1]
    if name == "ladder":
        assert [d["action"] for d in trips if d["label"] == "g"] == ["stricter", "exact"]
        assert rulesets[-1][0][1]["exact"]
        assert summary["stages"]["g"] == 2
        # h, already NaN+Inf at boundary, takes the 1e3 range guard first
        h = [r[1][1] for r in rulesets]
        assert h[3]["detect"]["max_magnitude"] == 1e3 and not h[3]["exact"]
        assert h[-1]["exact"] and h[-1]["label"] == "h"
    if name == "tick":
        assert [i for i, d in enumerate(decisions) if d] == [2, 5]   # h exact after 5
    if name == "within":
        assert trips == [] and rulesets[-1] == rulesets[0]


# ------------------------------------------------------------- the presets
@pytest.mark.parametrize("name", ["transformer", "recurrent"])
def test_presets_match_the_reference(name):
    assert set(preset_names()) >= {"transformer", "recurrent"}
    p, jp = get_preset(name, steps=5, seed=3), jget_preset(name, steps=5, seed=3)
    assert p.budget == jp.budget
    for field in ("family", "n_layers", "d_model", "n_heads", "n_kv", "d_ff",
                  "vocab", "head_dim", "slstm_every", "dtype_name"):
        assert getattr(p.arch, field) == getattr(jp.arch, field), field
    assert p.arch.repair.mode == "off"
    assert [g.to_json() for g in p.campaign.groups] == \
        [g.to_json() for g in jp.campaign.groups]
    for field in ("refresh_points", "episode", "steps", "batch", "prompt_len",
                  "seq_len", "seed"):
        assert getattr(p.campaign, field) == getattr(jp.campaign, field)
    with pytest.raises(KeyError):
        get_preset("nope")
