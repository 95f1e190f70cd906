"""Port parity of the kernels' in-tile ``neighbor_mean`` fill: every kernel
wrapper (its plain version, the CPU path) against the reference's Pallas
kernel in interpret mode, on the same numpy-seeded inputs, in f32 and
bf16, under the default detector and a range-guarded one.

A fatal lane takes the f32 mean of the non-fatal lanes of its logical tile,
rounded to the storage dtype (reference ``kernels/common.py::repair_value``).
The bar: counts, ``slot_counts`` and events bit-equal; every lane that is
not repaired bit-equal; repaired lanes within the reference scrub tests'
tolerance (rtol 1e-2 for bf16, 1e-6 for f32, atol 1e-6:
``tests/test_kernels.py``); products within the tolerances the port's
parity tests hold them to for the other fills (the two sum in different
orders).  Each case plants NaN, ±Inf, a lane only the range guard catches
and one logical tile that is fatal in every lane (its fill is 0).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import rules as jrules  # noqa: E402
from repro.kernels import common as jcommon  # noqa: E402
from repro.kernels import mlstm_chunk as jmc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import paged_attention as jpa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.scrub import scrub as j_scrub  # noqa: E402
from repro.kernels.scrub import scrub_pages as j_scrub_pages  # noqa: E402
from repro_torch.convert import to_numpy, to_torch  # noqa: E402
from repro_torch.core import rules  # noqa: E402
from repro_torch.kernels import common, mlstm_chunk as mc, ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa, ref  # noqa: E402
from repro_torch.kernels import scrub, tile_fill  # noqa: E402

NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
UINT = {"float32": np.uint32, "bfloat16": np.uint16}
FILL_TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
            "bfloat16": dict(rtol=1e-2, atol=1e-6)}
MM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AT_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# y is f32 from f32 operands after the repair in both dtypes: the reference
# kernel test's bound (tests/test_mlstm_kernel.py)
MLSTM_TOL = dict(rtol=5e-4, atol=5e-4)
DETS = ["default", "range"]


def _det(kind):
    """(reference, port) detectors; None is each package's default."""
    if kind == "default":
        return None, None
    return jrules.Detector(max_magnitude=1e3), rules.Detector(max_magnitude=1e3)


def _plant(x, seed, tile=None):
    """NaN, +Inf, -Inf and a range-only lane at seeded spots of the 2-D
    view of ``x`` (f32 numpy), and, with ``tile`` = (r0, c0, br, bc), every
    lane of that tile NaN."""
    rng = np.random.default_rng(seed)
    flat = x.reshape(-1)
    spots = rng.choice(flat.size, 4, replace=False)
    flat[spots] = [np.nan, np.inf, -np.inf, 4.0e3]
    if tile is not None:
        r0, c0, br, bc = tile
        x.reshape(-1, x.shape[-1])[r0:r0 + br, c0:c0 + bc] = np.nan
    return x


def _both(x, dtype):
    x = np.ascontiguousarray(x.astype(NP[dtype]))
    return jnp.asarray(x), to_torch(x)


def _fatal(x_np, kind):
    """The fatal mask of numpy ``x`` under the port's detector of ``kind``."""
    t = to_torch(np.ascontiguousarray(x_np))
    det = common.resolve_detector(_det(kind)[1], True)
    nan_m, inf_m = common.fatal_masks(t, common.detector_operand(det, t.dtype))
    return (nan_m | inf_m).numpy()


def _check_repaired(got, want, fatal, dtype):
    """Lanes that were not fatal bit-equal; repaired lanes within the fill
    tolerance."""
    got = to_numpy(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    g, w = got.view(UINT[dtype]), want.view(UINT[dtype])
    np.testing.assert_array_equal(g[~fatal], w[~fatal])
    assert fatal.any()
    np.testing.assert_allclose(got[fatal].astype(np.float32),
                               want[fatal].astype(np.float32), **FILL_TOL[dtype])


# ------------------------------------------------------------------ scrub
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", DETS)
@pytest.mark.parametrize("block", [(8, 16), None])
def test_scrub_matches_pallas(dtype, kind, block):
    rng = np.random.default_rng(1)
    x = _plant(rng.standard_normal((32, 64)).astype(np.float32) + 0.5, 2,
               tile=(8, 16, 8, 16))
    jx, tx = _both(x, dtype)
    jd, td = _det(kind)
    jfixed, jc = j_scrub(jx, policy="neighbor_mean", block=block, detector=jd)
    fatal = _fatal(np.asarray(jx), kind)
    _, tc = scrub.scrub(tx, policy="neighbor_mean", block=block, detector=td)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _check_repaired(tx, jfixed, fatal, dtype)
    if block is not None:       # the all-fatal tile takes 0
        assert not to_numpy(tx)[8:16, 16:32].astype(np.float32).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", DETS)
def test_scrub_pages_with_n_valid_matches_pallas(dtype, kind):
    """Unique ids, the last one past ``n_valid``: it is repaired, with the
    gathered view's tiles, and not counted."""
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((6, 4, 16)).astype(np.float32) - 0.25
    for page, seed in ((1, 4), (4, 5), (2, 6)):
        _plant(pool[page], seed)
    jx, tx = _both(pool, dtype)
    ids = np.array([4, 1, 2], np.int32)
    jd, td = _det(kind)
    kw = dict(policy="neighbor_mean", block=(6, 8), n_valid=2)
    jfixed, jc = j_scrub_pages(jx, jnp.asarray(ids), detector=jd, **kw)
    fatal = _fatal(np.asarray(jx), kind)
    _, tc = scrub.scrub_pages(tx, ids, detector=td, **kw)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _check_repaired(tx, jfixed, fatal, dtype)


def test_tile_fill_plain_matches_reference_repair_value():
    """The plain table against the reference's ``repair_value`` on each
    tile, and the paged pools' layer view (one row per page) against the
    gathered page."""
    rng = np.random.default_rng(7)
    x = _plant(rng.standard_normal((16, 24)).astype(np.float32), 8,
               tile=(4, 8, 4, 8))
    consts = common.detector_operand(rules.Detector(), torch.float32)
    table = tile_fill.tile_fill(to_torch(x), 16, 24, (4, 8), consts)
    want = []
    for r in range(0, 16, 4):
        for c in range(0, 24, 8):
            t = jnp.asarray(x[r:r + 4, c:c + 8])
            m = ~jnp.isfinite(t)
            want.append(float(jcommon.repair_value(t, m, "neighbor_mean", 0.0)[0, 0]))
    np.testing.assert_allclose(tile_fill.values(table, torch.float32).numpy(),
                               want, **FILL_TOL["float32"])
    assert tile_fill.values(table, torch.float32)[4] == 0.0   # all-fatal tile
    P, L, pg, Kh, Dh = 5, 3, 2, 2, 4
    pool = rng.standard_normal((P, L, pg, Kh, Dh)).astype(np.float32)
    pool[3, 1, 0, 1, 2] = np.nan
    cols = pg * Kh * Dh
    layer = tile_fill.tile_fill(to_torch(pool), P, cols, (1, cols), consts,
                                row_stride=L * cols, offset=cols)
    rows = pool[:, 1].reshape(P, cols)
    want = [np.nanmean(r).astype(np.float32) for r in rows]
    np.testing.assert_allclose(tile_fill.values(layer, torch.float32).numpy(),
                               want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------- repair_matmul
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", DETS)
@pytest.mark.parametrize("blocks", [(32, 32, 64), (64, 16, 32)])
def test_repair_matmul_memory_mode_matches_pallas(dtype, kind, blocks):
    rng = np.random.default_rng(11)
    bm, bn, bk = blocks
    a = _plant(rng.standard_normal((64, 128)).astype(np.float32) + 0.25, 12,
               tile=(bm, bk, bm, bk))
    b = _plant(rng.standard_normal((128, 64)).astype(np.float32) - 0.25, 13,
               tile=(0, bn, bk, bn))
    (ja, ta), (jb, tb) = _both(a, dtype), _both(b, dtype)
    fa, fb = _fatal(np.asarray(ja), kind), _fatal(np.asarray(jb), kind)
    jd, td = _det(kind)
    kw = dict(policy="neighbor_mean", blocks=blocks)
    jr = jops.repair_matmul(ja, jb, mode="memory", detector=jd, **kw)
    reg = ops.repair_matmul(ta, tb, mode="register", detector=td, **kw)
    np.testing.assert_array_equal(reg.counts.numpy(), np.asarray(jr.counts))
    tol = MM_TOL[dtype]
    np.testing.assert_allclose(reg.c.float().numpy(),
                               np.asarray(jr.c.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    mem = ops.repair_matmul(ta, tb, mode="memory", detector=td, **kw)
    assert torch.equal(mem.c, reg.c)
    # the origin scrub repairs with the scrub's default tiles, not blocks
    _check_repaired(mem.a, jr.a, fa, dtype)
    _check_repaired(mem.b, jr.b, fb, dtype)
    if kind == "default":   # the oracle twin
        oc, ocounts = ref.repair_matmul_ref(to_torch(np.asarray(ja)),
                                            to_torch(np.asarray(jb)), **kw)
        assert ocounts[:6].tolist() == reg.counts[:6].tolist()
        np.testing.assert_allclose(oc.float().numpy(), reg.c.float().numpy(),
                                   rtol=tol, atol=tol)


# -------------------------------------------------------- flash_attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", DETS)
def test_flash_attention_memory_mode_matches_pallas(dtype, kind):
    rng = np.random.default_rng(21)
    B, H, Kh, S, D = 1, 4, 2, 128, 64
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = _plant(rng.standard_normal((B, Kh, S, D)).astype(np.float32) + 0.5, 22,
               tile=(64, 0, 32, D))
    v = _plant(rng.standard_normal((B, Kh, S, D)).astype(np.float32) - 0.5, 23)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    fk, fv = _fatal(np.asarray(jk), kind), _fatal(np.asarray(jv), kind)
    jd, td = _det(kind)
    kw = dict(policy="neighbor_mean", blocks=(64, 32))
    jr = jops.flash_attention(jq, jk, jv, mode="memory", detector=jd, **kw)
    reg = ops.flash_attention(tq, tk, tv, mode="register", detector=td, **kw)
    np.testing.assert_array_equal(reg.counts.numpy(), np.asarray(jr.counts))
    np.testing.assert_allclose(reg.out.float().numpy(),
                               np.asarray(jr.out.astype(jnp.float32)),
                               rtol=AT_TOL[dtype], atol=AT_TOL[dtype])
    mem = ops.flash_attention(tq, tk, tv, mode="memory", detector=td, **kw)
    assert torch.equal(mem.out, reg.out)
    _check_repaired(mem.k, jr.k, fk, dtype)
    _check_repaired(mem.v, jr.v, fv, dtype)
    if kind == "default":   # the oracle twin at S == T
        oracle = ref.flash_attention_ref(tq, to_torch(np.asarray(jk)),
                                         to_torch(np.asarray(jv)),
                                         policy="neighbor_mean", kv_block=32)
        np.testing.assert_allclose(oracle.float().numpy(),
                                   reg.out.float().numpy(),
                                   rtol=AT_TOL[dtype], atol=AT_TOL[dtype])


# ------------------------------------------------------------ paged family
P, L, PG, KH, DH, H = 9, 2, 4, 2, 16, 4
NULL = P - 1
BT = np.array([[0, 2, 8, 8], [5, 3, 1, 8], [8, 8, 8, 8]], np.int32)
POS = np.array([9, 13, 0], np.int32)
QSTART = np.array([4, 8, 0], np.int32)
PAGED_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _pool(dtype, seed=31):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((P, L, PG, KH, DH)).astype(np.float32) + 0.5
    v = rng.standard_normal((P, L, PG, KH, DH)).astype(np.float32) - 0.5
    for page, s in ((2, 32), (NULL, 33), (3, 34)):
        _plant(k[page, 1], s)
        _plant(v[page, 1], s + 10)
    k[5, 1] = np.nan                   # a page fatal in every lane
    return _both(k, dtype), _both(v, dtype)


def _paged_kw(kind):
    jd, td = _det(kind)
    jd = "default" if jd is None else jd
    td = "default" if td is None else td
    return dict(detector_k=jd, detector_v=jd), dict(detector_k=td, detector_v=td)


PAGED_FILLS = {
    "both": dict(policy="neighbor_mean"),
    "k_only": dict(policy_k="neighbor_mean", policy_v="zero"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", DETS)
@pytest.mark.parametrize("fills", ["both", "k_only"])
@pytest.mark.parametrize("splits", [1, 2])
def test_paged_decode_matches_pallas(dtype, kind, fills, splits):
    (jk, tk), (jv, tv) = _pool(dtype)
    q = np.random.default_rng(35).standard_normal((3, H, DH)).astype(np.float32)
    jq, tq = _both(q, dtype)
    jkw, tkw = _paged_kw(kind)
    args = (jnp.asarray(BT), jnp.asarray(POS), jnp.asarray(1, jnp.int32))
    if splits == 1:
        jout, jslot, jcnt = jpa.paged_attention_raw(
            jq, jk, jv, *args, **jkw, **PAGED_FILLS[fills])
        tout, tslot, tcnt = pa.paged_attention_raw(
            tq, tk, tv, to_torch(BT), to_torch(POS), 1, **tkw, **PAGED_FILLS[fills])
    else:
        jout, jslot, jcnt = jpa.paged_attention_splitk_raw(
            jq, jk, jv, *args, splits=splits, **jkw, **PAGED_FILLS[fills])
        tout, tslot, tcnt = pa.paged_attention_splitk_raw(
            tq, tk, tv, to_torch(BT), to_torch(POS), 1, splits=splits, **tkw,
            **PAGED_FILLS[fills])
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    assert int(tcnt[6]) > 0
    tol = PAGED_TOL[dtype]
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    # the fused route's plain twin and the gather-then-softmax oracle
    twin = pa.paged_decode_fused_plain(tq, tk, tv, to_torch(BT), to_torch(POS),
                                       1, **tkw, **PAGED_FILLS[fills])
    assert torch.equal(twin[1], tslot) and torch.equal(twin[2], tcnt)
    np.testing.assert_allclose(twin[0].float().numpy(), tout.float().numpy(),
                               rtol=tol, atol=tol)
    oracle, oslot = ref.paged_attention_ref(tq, tk, tv, to_torch(BT),
                                            to_torch(POS), layer=1, **tkw,
                                            **PAGED_FILLS[fills])
    assert torch.equal(oslot, tslot)
    np.testing.assert_allclose(oracle.float().numpy(), tout.float().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", DETS)
@pytest.mark.parametrize("fills", ["both", "k_only"])
def test_paged_prefill_matches_pallas(dtype, kind, fills):
    (jk, tk), (jv, tv) = _pool(dtype, seed=41)
    q = np.random.default_rng(42).standard_normal((3, 6, H, DH)).astype(np.float32)
    jq, tq = _both(q, dtype)
    jkw, tkw = _paged_kw(kind)
    jout, jslot, jcnt = jpa.paged_prefill_raw(
        jq, jk, jv, jnp.asarray(BT), jnp.asarray(QSTART),
        jnp.asarray(1, jnp.int32), **jkw, **PAGED_FILLS[fills])
    tout, tslot, tcnt = pa.paged_prefill_raw(
        tq, tk, tv, to_torch(BT), to_torch(QSTART), 1, **tkw, **PAGED_FILLS[fills])
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    tol = PAGED_TOL[dtype]
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    # the wgmma route's scan twin: the V flags see the page's mean
    fill_v = PAGED_FILLS[fills].get("policy_v", "neighbor_mean")
    sc, cnt, flags = pa.prefill_scan_plain(
        tk, tv, to_torch(BT), 1, detector_k=tkw["detector_k"],
        detector_v=tkw["detector_v"], policy_v=fill_v)
    assert torch.equal(sc, tslot) and torch.equal(cnt, tcnt)
    assert int(flags[..., 1].max()) == 1      # every V fill here is finite


# ------------------------------------------------------------- mlstm_chunk
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("include_inf", [True, False])
def test_mlstm_chunk_matches_pallas(dtype, include_inf):
    Q, B, Hm, nc, Pm = 16, 2, 2, 3, 16
    rng = np.random.default_rng(51)
    q, k, v = (rng.standard_normal((B, Hm, nc, Q, Pm)).astype(np.float32) + 0.3
               for _ in range(3))
    q /= 4.0
    for x, s in ((q, 52), (k, 53), (v, 54)):
        _plant(x, s)
    v[1, 0, 2] = np.nan                 # one (b, h, c) tile fatal in every lane
    li = (rng.standard_normal((B, Hm, nc, Q)) * 0.5).astype(np.float32)
    lf = (-np.log1p(np.exp(-(rng.standard_normal((B, Hm, nc, Q)) + 2.0)))
          ).astype(np.float32)
    arrs = [_both(x, dtype) for x in (q, k, v)]
    j = [a[0] for a in arrs] + [jnp.asarray(li), jnp.asarray(lf)]
    t = [a[1] for a in arrs] + [to_torch(li), to_torch(lf)]
    kw = dict(policy="neighbor_mean", include_inf=include_inf)
    jy, jc = jmc.mlstm_chunk_raw(*j, **kw)
    ty, tc = mc.mlstm_chunk_raw(*t, **kw)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tc[mc.EV_TOTAL]) > 0
    jy = np.asarray(jy)
    np.testing.assert_array_equal(np.isnan(ty.numpy()), np.isnan(jy))
    np.testing.assert_allclose(ty.numpy(), jy, equal_nan=True, **MLSTM_TOL)
    # the wgmma route's plain twin: the tile's fill goes in before the split
    sy, sc = mc.mlstm_chunk_split_plain(*t, **kw)
    assert torch.equal(sc, tc)
    np.testing.assert_allclose(sy.numpy(), ty.numpy(), equal_nan=True,
                               **MLSTM_TOL)
