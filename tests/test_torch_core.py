"""Port parity of the core: bit-pattern detection, tiling, detector
constants and masks, rule binding and gating, fills, the refresh→BER model,
injection and the counter stream — the same inputs (numpy, from a seed)
through the JAX reference and the PyTorch port.  Integer and bit outputs
must be identical; no float tolerance is needed here (every compared value
is a bit pattern, a count, or computed with the same IEEE operations)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import detect as jdetect  # noqa: E402
from repro.core import injection as jinjection  # noqa: E402
from repro.core import regions as jregions  # noqa: E402
from repro.core import rules as jrules  # noqa: E402
from repro.core import stats as jstats  # noqa: E402
from repro.core import tiling as jtiling  # noqa: E402
from repro.kernels import common as jcommon  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import detect, injection, policies, regions, rules  # noqa: E402
from repro_torch.core import stats, tiling  # noqa: E402
from repro_torch.kernels import common  # noqa: E402

# (torch dtype, jax dtype, numpy unsigned view, numpy signed view)
DTYPES = {
    "float32": (torch.float32, jnp.float32, np.uint32, np.int32),
    "bfloat16": (torch.bfloat16, jnp.bfloat16, np.uint16, np.int16),
    "float16": (torch.float16, jnp.float16, np.uint16, np.int16),
}


def _both(bits_u, name):
    """The same bit patterns as a JAX array and a torch tensor."""
    tdt, jdt, _, sdt = DTYPES[name]
    jx = jax.lax.bitcast_convert_type(jnp.asarray(bits_u), jdt)
    tx = torch.from_numpy(bits_u.view(sdt).copy()).view(tdt)
    return jx, tx


def _random_bits(name, n=4096, seed=0):
    _, _, udt, _ = DTYPES[name]
    width = np.dtype(udt).itemsize * 8
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 1 << width, size=n, dtype=np.uint64).astype(udt)
    lay = detect.layout_of(DTYPES[name][0])
    special = np.array([
        0, lay.sign_mask, lay.exp_mask, lay.exp_mask | lay.sign_mask,
        lay.exp_mask | 1, lay.exp_mask | lay.man_mask, 1, lay.exp_mask - 1,
    ], dtype=udt)
    return np.concatenate([special, bits])


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_nan_inf_masks_match_reference(name):
    jx, tx = _both(_random_bits(name), name)
    np.testing.assert_array_equal(detect.nan_mask(tx).numpy(), np.asarray(jdetect.nan_mask(jx)))
    np.testing.assert_array_equal(detect.inf_mask(tx).numpy(), np.asarray(jdetect.inf_mask(jx)))
    for include_inf in (True, False):
        np.testing.assert_array_equal(
            detect.nonfinite_mask(tx, include_inf=include_inf).numpy(),
            np.asarray(jdetect.nonfinite_mask(jx, include_inf=include_inf)),
        )


@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_16bit_pattern_space_exhaustive(name):
    """All 2^16 patterns (the reference samples slices of this space)."""
    bits = np.arange(1 << 16, dtype=np.uint16)
    jx, tx = _both(bits, name)
    tbits = detect.bits_of(tx)
    x64 = np.asarray(jx, np.float64)
    nan_m = detect.is_nan_bits(tbits, tx.dtype).numpy()
    inf_m = detect.is_inf_bits(tbits, tx.dtype).numpy()
    np.testing.assert_array_equal(nan_m, np.isnan(x64))
    np.testing.assert_array_equal(inf_m, np.isinf(x64))


def test_bits_roundtrip_and_layouts():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(64).astype(np.float32))
    assert torch.equal(detect.from_bits(detect.bits_of(x), torch.float32), x)
    for name, (tdt, jdt, _, _) in DTYPES.items():
        a, b = detect.layout_of(tdt), jdetect.layout_of(jdt)
        assert (a.width, a.exp_bits, a.man_bits, a.exp_mask, a.man_mask) == (
            b.width, b.exp_bits, b.man_bits, b.exp_mask, b.man_mask)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("threshold", [1e-3, 1.0, 1e3, 6.0e4])
def test_range_guard_matches_reference(name, threshold):
    tdt, jdt, _, _ = DTYPES[name]
    assert detect.exp_field_of(threshold, tdt) == jdetect.exp_field_of(threshold, jdt)
    jx, tx = _both(_random_bits(name, seed=2), name)
    np.testing.assert_array_equal(
        detect.is_extreme_bits(detect.bits_of(tx), tdt, threshold).numpy(),
        np.asarray(jdetect.is_extreme_bits(jdetect.bits_of(jx), jdt, threshold)),
    )


def test_tiling_fit_matches_reference():
    for dim in [0, 1, 3, 7, 8, 96, 128, 250, 256, 384, 896, 1792, 3584, 58240]:
        for cap in [1, 8, 128, 256, 512]:
            assert tiling.fit(dim, cap) == jtiling.fit(dim, cap)
        assert tiling.fit_blocks(dim, dim + 5) == jtiling.fit_blocks(dim, dim + 5)
    # the full-width page scrub: one page is 896 rows of 128 columns
    assert tiling.fit_blocks(896, 128) == (128, 128)
    assert tiling.fit_blocks(2 * 896, 128) == (256, 128)


def _detectors(name):
    _, _, udt, _ = DTYPES[name]
    width = np.dtype(udt).itemsize * 8
    top = (1 << width) - 1
    return [
        ("default", jrules.Detector(), rules.Detector()),
        ("nan_only", jrules.Detector(inf=False), rules.Detector(inf=False)),
        ("range", jrules.Detector(max_magnitude=1e3), rules.Detector(max_magnitude=1e3)),
        ("bitpattern", jrules.Detector(bitpatterns=((None, top, top - 1),)),
         rules.Detector(bitpatterns=((None, top, top - 1),))),
        ("typed", jrules.Detector(inf=False, bitpatterns=((name, 0x7, 0x5),)),
         rules.Detector(inf=False, bitpatterns=((name, 0x7, 0x5),))),
    ]


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_detector_constants_and_masks_match_reference(name):
    tdt, jdt, _, _ = DTYPES[name]
    jx, tx = _both(_random_bits(name, seed=3), name)
    for label, jd, td in _detectors(name):
        assert td.constants(tdt) == jd.constants(jdt), label
        want = np.asarray(jcommon.detector_operand(jd, jdt, 96))
        got = np.asarray(common.detector_operand(td, tdt, 96), np.int32)
        np.testing.assert_array_equal(got, want)
        jn, ji = jd.masks(jx)
        tn, ti = td.masks(tx)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn), err_msg=label)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji), err_msg=label)
        # the kernels' operand decoding agrees with the tensor-level masks
        cn, ci = common.fatal_masks(tx, common.detector_operand(td, tdt))
        np.testing.assert_array_equal(cn.numpy(), np.asarray(jn), err_msg=label)
        np.testing.assert_array_equal(ci.numpy(), np.asarray(ji), err_msg=label)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_masks_from_consts_two_complement_and_widening(name):
    """Operands with bit 31 set (two's complement in int32) and a 16-bit
    view widened as the reference widens it (zero extension)."""
    tdt, jdt, _, _ = DTYPES[name]
    jx, tx = _both(_random_bits(name, seed=4), name)
    lay = detect.layout_of(tdt)
    for mask, value in [(0xFFFF0000, 0), (0x80000001, 0x80000001),
                        (0xFFFFFFFF, 0x0000FFFF), (0x8000, 0x8000)]:
        consts = [lay.exp_mask, lay.man_mask, 1 | 2 | 8, 0, mask, value, 0, 0]
        signed = [detect.signed(c, 32) for c in consts]
        jn, ji = jcommon.masks_from_consts(
            jdetect.bits_of(jx), jnp.asarray(np.asarray(signed, np.int32)))
        tn, ti = common.masks_from_consts(detect.bits_of(tx), signed, lay.width)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_constants_reject_wide_dtypes_and_two_bitpatterns():
    with pytest.raises(TypeError):
        rules.Detector().constants(torch.float64)
    two = rules.Detector(bitpatterns=((None, 1, 1), (None, 2, 2)))
    with pytest.raises(ValueError):
        two.constants(torch.float32)


def _ruleset_pair():
    kv = dict(detect=dict(inf=False), fill="zero", trigger="reactive")
    opt = dict(detect=dict(max_magnitude=1e3), fill=0.5, trigger="interval")
    entries = [(r"(^|/)layers/(k|v)$", kv), (r"opt/", opt),
               (r"embed", None), (r"opt/", kv)]

    def build(mod):
        out = []
        for pattern, spec in entries:
            if spec is None:
                rule = mod.RepairRule.exact_rule("island")
            else:
                rule = mod.RepairRule(
                    detect=mod.Detector(**spec["detect"]), fill=spec["fill"],
                    trigger=spec["trigger"], label="dup" if pattern == "opt/" else "",
                )
            out.append((pattern, rule))
        return mod.RuleSet(tuple(out))

    return build(jrules), build(rules)


def test_ruleset_binding_labels_and_gating_match_reference():
    jrs, trs = _ruleset_pair()
    assert trs.labels() == jrs.labels()
    assert trs.n_rules == jrs.n_rules
    for path in ["layers/k", "layers/v", "xlayers/k", "embed/table", "opt/mu/w",
                 "layers/attn/wq", "final_norm/scale"]:
        ti, tr = trs.rule_for(path)
        ji, jr = jrs.rule_for(path)
        assert ti == ji and tr.label == jr.label and tr.exact == jr.exact, path
        for tag in rules.PASSES:
            assert tr.fires(tag) == jr.fires(tag), (path, tag)
    tree = {"layers": {"k": np.zeros(2), "v": np.zeros(2)}, "embed": {"table": np.zeros(2)}}
    _, jidx = jrs.assign(tree)
    _, tidx = trs.assign(regions.flatten(tree))
    assert list(tidx.values()) == jax.tree.leaves(jidx)
    legacy = rules.RuleSet.from_legacy(
        type("Cfg", (), dict(include_inf=False, policy="zero", max_magnitude=None)))
    assert legacy.labels() == ("default", "default#1")
    assert legacy.entries[0][1].detect == rules.Detector(inf=False)


def test_regions_annotate_matches_reference():
    tree = {"layers": {"k": np.zeros(2), "v": np.zeros(2)}, "step": np.zeros(1),
            "rng_key": np.zeros(1), "router": {"w": np.zeros(1)},
            "opt": {"count": np.zeros(1), "mu": np.zeros(1)}}
    want = [r.value for r in jax.tree.leaves(jregions.annotate(tree))]
    got = [r.value for r in regions.annotate(regions.flatten(tree)).values()]
    assert got == want


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("fill", ["zero", 0.5, "clamp_finite_max"])
def test_fills_match_reference(name, fill):
    tdt, jdt, udt, _ = DTYPES[name]
    lay = detect.layout_of(tdt)
    pats = np.array([0, lay.sign_mask, lay.exp_mask, lay.exp_mask | lay.sign_mask,
                     lay.exp_mask | 3, lay.exp_mask | lay.sign_mask | 1, 0x10, 0x20],
                    dtype=udt)
    jx, tx = _both(pats, name)
    jr = jrules.RepairRule(fill=fill)
    tr = rules.RepairRule(fill=fill)
    jf, jn, ji = jr.apply(jx)
    tf, tn, ti = tr.apply(tx)
    np.testing.assert_array_equal(detect.bits_of(tf).numpy().view(udt),
                                  np.asarray(jdetect.bits_of(jf)))
    assert (int(tn), int(ti)) == (int(jn), int(ji))
    if fill != "clamp_finite_max":
        assert common.kernel_fill(fill) == jcommon.kernel_fill(fill)


def test_neighbor_mean_kernel_fill_matches_the_reference_oracle():
    """The tensor-level policy is the same object as before; ``kernel_fill``
    still maps ``neighbor_mean`` to None in both packages (the engine and
    the plan keep the tensor-level path for it); and the kernels' in-tile
    fill, in its plain form, matches the reference oracle tile for tile."""
    assert policies.get("neighbor_mean") is policies.neighbor_mean
    assert common.kernel_fill("neighbor_mean") is None
    assert jcommon.kernel_fill("neighbor_mean") is None
    assert "neighbor_mean" in common.KERNEL_POLICIES
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    x[1, 3], x[9, 20], x[12, 0] = np.nan, np.inf, -np.inf
    x[8:16, 8:16] = np.nan                       # a tile with no finite lane
    consts = common.detector_operand(rules.Detector(), torch.float32)
    got, nan_m, inf_m = common.repair_tile(torch.from_numpy(x), consts,
                                           "neighbor_mean", 0.0, (8, 8))
    want = jref.repair_array_ref(jnp.asarray(x), policy="neighbor_mean",
                                 block=(8, 8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), rtol=1e-6,
                               atol=1e-6)
    assert int(nan_m.sum()) == int(want[1]) and int(inf_m.sum()) == int(want[2])


@pytest.mark.parametrize("t", [0.01, 0.064, 0.1, 0.256, 0.5, 1.0, 2.0, 4.0, 10.0])
def test_from_refresh_matches_reference(t):
    a = injection.ApproxMemoryModel.from_refresh(t)
    b = jinjection.ApproxMemoryModel.from_refresh(t)
    assert (a.refresh_interval_s, a.ber, a.energy_saving) == (
        b.refresh_interval_s, b.ber, b.energy_saving)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_xor_fold_of_given_positions_matches_reference(name):
    """Duplicate (position, bit) pairs fold by XOR, bit for bit."""
    tdt, jdt, udt, _ = DTYPES[name]
    lay = detect.layout_of(tdt)
    rng = np.random.default_rng(5)
    base = rng.integers(0, 1 << lay.width, size=64, dtype=np.uint64).astype(udt)
    positions = rng.integers(0, 64, size=200)
    bit_idx = rng.integers(0, lay.width, size=200)
    jx, tx = _both(base, name)
    jbits = jdetect.bits_of(jx)
    masks = jnp.asarray((np.uint64(1) << bit_idx.astype(np.uint64)).astype(udt))
    want = np.asarray(jinjection._scatter_xor(jbits, jnp.asarray(positions), masks))
    got, n_changed = injection.xor_fold(tx, torch.from_numpy(positions),
                                        torch.from_numpy(bit_idx))
    np.testing.assert_array_equal(detect.bits_of(got).numpy().view(udt), want)
    popcount = sum(bin(int(a) ^ int(b)).count("1") for a, b in zip(base, want))
    assert n_changed == popcount


def test_flip_bits_count_is_poisson():
    """The flip count over many windows matches Poisson(n_bits · ber) in
    mean (the reference's distribution; its PRNG stream differs)."""
    x = torch.zeros(4096, dtype=torch.float32)
    ber = 2e-4
    lam = x.numel() * 32 * ber                       # 26.2 flips per window
    gen = torch.Generator().manual_seed(0)
    counts = [injection.flip_bits_counted(x, ber, gen)[1] for _ in range(200)]
    mean = float(np.mean(counts))
    assert abs(mean - lam) < 4 * np.sqrt(lam / 200), (mean, lam)
    flipped = injection.flip_bits(x, ber, gen)
    assert flipped.shape == x.shape and flipped.dtype == x.dtype


def test_inject_nan_tag_matches_reference():
    for name in sorted(DTYPES):
        tdt, jdt, udt, _ = DTYPES[name]
        x = torch.ones(32, dtype=tdt)
        got = injection.inject_nan(x, n=3, generator=torch.Generator().manual_seed(0))
        want = jinjection.inject_nan(jax.random.PRNGKey(0), jnp.ones(32, jdt), n=3)
        gb = detect.bits_of(got).numpy().view(udt)
        wb = np.asarray(jdetect.bits_of(want))
        assert int(detect.nan_mask(got).sum()) == 3
        assert set(gb[detect.nan_mask(got).numpy()]) == set(wb[np.isnan(np.asarray(want, np.float32))])


def test_stats_stream_matches_reference():
    counts = [1, 2, 1, 3, 0, 1, 2, 0]
    j = jstats.record_kernel_counts(jstats.record_repair(jstats.zeros(), 2, 1), counts)
    j = jstats.record_flips(j, 7)
    t = stats.record_kernel_counts(stats.record_repair(stats.zeros(), 2, 1), counts)
    t = stats.record_flips(t, 7)
    assert stats.as_dict(t) == jstats.as_dict(j)
    assert stats.merge(t, t) == {k: 2 * v for k, v in stats.as_dict(t).items()}


def test_policy_table_values():
    x = torch.tensor([float("nan"), -2.0, 3.0], dtype=torch.float32)
    mask = torch.tensor([True, True, False])
    assert policies.get(0.25)(x, mask).tolist() == [0.25] * 3
    assert policies.get("zero")(x, mask).tolist() == [0.0] * 3
    big = torch.finfo(torch.float32).max
    assert policies.get("clamp_finite_max")(x, mask).tolist() == [big, -big, big]
    with pytest.raises(KeyError):
        policies.get("nope")
