"""Port parity of the tensor-level repair: the ``neighbor_mean`` policy,
``core/repair.py`` (``RepairConfig``, ``fatal_masks``, ``repair_tensor``,
``use``) and ``ApproxSpace.use``, against the reference on the same numpy
inputs.  Repaired tensors must be bit-equal (``neighbor_mean`` included:
both sum each tile with the same order-fixed pairwise f32 fold) and the
counts and stats equal."""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import policies as jpolicies  # noqa: E402
from repro.core import repair as jrepair  # noqa: E402
from repro.core import rules as jrules  # noqa: E402
from repro.core import stats as jstats  # noqa: E402
from repro.runtime import ApproxConfig as JConfig  # noqa: E402
from repro.runtime import ApproxSpace as JSpace  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import policies, repair, rules, stats  # noqa: E402
from repro_torch.runtime import ApproxConfig, ApproxSpace  # noqa: E402

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(x, dtype="float32"):
    j = jnp.asarray(x).astype(JDT[dtype])
    return j, convert.to_torch(np.asarray(j))


def _same_bits(t, j):
    want = np.asarray(j)
    udt = {2: np.uint16, 4: np.uint32}[want.dtype.itemsize]
    np.testing.assert_array_equal(convert.to_numpy(t).view(udt), want.view(udt))


def _faulty(shape, seed, n_bad=6):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, min(n_bad, flat.size), replace=False)
    flat[idx] = np.array([np.nan, np.inf, -np.inf, 2.0e4, np.nan, -7.0e3])[
        np.arange(idx.size) % 6]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (512, 1024),        # 2 x 2 tiles of 256 x 512
    (300, 96),          # 75 tiles of 4 x 96: 384 lanes, padded to 512
    (7, 40),            # one 280-lane tile
    (100,),
    (6, 10, 48),
])
def test_neighbor_mean_is_bit_equal_to_the_reference(shape, dtype):
    x = _faulty(shape, seed=sum(shape))
    if shape == (7, 40):
        x[:] = np.nan                       # a tile with no finite lane
    jx, tx = _pair(x, dtype)
    jf, jn, ji = jrepair.repair_tensor(jx, policy=jpolicies.neighbor_mean)
    tf, tn, ti = repair.repair_tensor(tx, policy=policies.neighbor_mean)
    _same_bits(tf, jf)
    assert (int(tn), int(ti)) == (int(jn), int(ji))
    jm = jnp.isnan(jx) | jnp.isinf(jx)
    tm = torch.isnan(tx) | torch.isinf(tx)
    _same_bits(policies.neighbor_mean(tx, tm), jpolicies.neighbor_mean(jx, jm))


@pytest.mark.parametrize("knobs", [
    dict(include_inf=True), dict(include_inf=False),
    dict(max_magnitude=1e3), dict(include_inf=False, max_magnitude=5e3),
])
@pytest.mark.parametrize("fill", ["zero", "clamp_finite_max", 0.5, "neighbor_mean"])
def test_repair_tensor_and_fatal_masks_match_the_reference(knobs, fill):
    jx, tx = _pair(_faulty((64, 96), seed=3))
    jn, ji = jrepair.fatal_masks(jx, **knobs)
    tn, ti = repair.fatal_masks(tx, **knobs)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jf, jnc, jic = jrepair.repair_tensor(jx, policy=jpolicies.get(fill), **knobs)
    tf, tnc, tic = repair.repair_tensor(tx, policy=policies.get(fill), **knobs)
    _same_bits(tf, jf)
    assert (int(tnc), int(tic)) == (int(jnc), int(jic))


def test_repair_config_matches_the_reference():
    for kw in (dict(), dict(mode="register", policy=0.25),
               dict(mode="off", include_inf=False, max_magnitude=1e4)):
        j, t = jrepair.RepairConfig(**kw), repair.RepairConfig(**kw)
        assert (t.mode, t.policy, t.include_inf, t.max_magnitude) == (
            j.mode, j.policy, j.include_inf, j.max_magnitude)
        assert t.resolved_policy().name == j.resolved_policy().name
    with pytest.raises(ValueError):
        repair.RepairConfig(mode="sometimes")


def _rule_configs():
    """(reference, port) config pairs: scalar knobs, and a rule set with an
    on-read rule bound by path, an exact island and a catch-all."""
    out = []
    for mode in ("off", "register", "memory"):
        out.append((JConfig(mode=mode, policy="neighbor_mean"),
                    ApproxConfig(mode=mode, policy="neighbor_mean")))

        def rs(lib):
            return lib.RuleSet((
                (r"attn/wq$", lib.RepairRule(fill="zero", trigger="on-read",
                                             label="wq")),
                (r"^exact/", lib.RepairRule.exact_rule()),
                (r".*", lib.RepairRule(
                    detect=lib.Detector(max_magnitude=1e3), fill=-1.5)),
            ))

        out.append((JConfig(mode=mode, rules=rs(jrules)),
                    ApproxConfig(mode=mode, rules=rs(rules))))
    return out


@pytest.mark.parametrize("cfgs", _rule_configs(),
                         ids=lambda c: f"{c[1].mode}-{'rules' if c[1].rules else 'knobs'}")
def test_space_use_matches_the_reference(cfgs):
    jcfg, tcfg = cfgs
    jspace, tspace = JSpace(jcfg), ApproxSpace(tcfg)
    jx, tx = _pair(_faulty((32, 64), seed=9))
    before = tx.clone()
    js, ts = jstats.zeros(), stats.zeros()
    for path in ("", "layers/attn/wq", "layers/mlp/w_up", "exact/step_scale"):
        jf, js = jspace.use(jx, js, path=path)
        tf, ts = tspace.use(tx, ts, path=path)
        _same_bits(tf, jf)
        assert stats.as_dict(ts) == jstats.as_dict(js), path
        _same_bits(tspace.use(tx, path=path), jspace.use(jx, path=path))
        _same_bits(repair.use(tx, tcfg, path=path), jrepair.use(jx, jcfg, path=path))
    assert tspace.stats_dict() == jspace.stats_dict()
    np.testing.assert_array_equal(              # use() returns a copy
convert.to_numpy(tx).view(np.uint32),
                                  convert.to_numpy(before).view(np.uint32))
    jf, js = jrepair.use(jx, jcfg, jstats.zeros())
    tf, ts = repair.use(tx, tcfg, stats.zeros())
    _same_bits(tf, jf)
    assert stats.as_dict(ts) == jstats.as_dict(js)


def test_read_rule_matches_the_reference():
    for lib, out in ((jrules, []), (rules, [])):
        entries = [
            (r"a", lib.RepairRule.exact_rule()),
            (r"b", lib.RepairRule(fill="zero", label="b")),
            (r"c", lib.RepairRule(fill=1.0, trigger="on-read", label="c")),
        ]
        for cut in (3, 2, 1):
            out.append(lib.RuleSet(tuple(entries[:cut])).read_rule().label)
        if lib is jrules:
            want = out
    assert out == want == ["c", "b", "default"]


def test_default_config_scrubs_with_neighbor_mean_like_the_reference():
    """``ApproxConfig()``'s default fill is ``neighbor_mean``: the tree
    scrub now runs on the tensor path, bit-equal to the reference's."""
    x = _faulty((256, 512), seed=4)
    jx, tx = _pair(x)
    jspace, tspace = JSpace(JConfig()), ApproxSpace(ApproxConfig())
    jout = jspace.scrub({"w": jx})
    tout = tspace.scrub({"w": tx})
    _same_bits(tout["w"], jout["w"])
    assert tspace.stats_dict() == jspace.stats_dict()
