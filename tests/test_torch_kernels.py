"""Port parity of the kernels' plain versions against the reference's
Pallas kernels (interpret mode on the CPU, as the reference's own tests run
them), at the reference tests' shapes (tests/test_paged_attention.py:29):
integer outputs (slot counts, AT counts, scrub counts, repaired bits) must
be identical; f32 outputs agree within rtol = atol = 1e-5 (the two sum in
different orders).  The kernels themselves are held against these plain
versions on the card by ``tests/test_torch_cuda.py``."""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import rules as jrules  # noqa: E402
from repro.kernels import paged_attention as jpa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.scrub import scrub as j_scrub  # noqa: E402
from repro.kernels.scrub import scrub_pages as j_scrub_pages  # noqa: E402
from repro_torch.core import rules  # noqa: E402
from repro_torch.kernels import common, paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref, scrub  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
P, L, PG, KH, DH, H = 9, 2, 4, 2, 16, 4
NULL = P - 1
BT = np.array([[0, 2, 8, 8], [5, 3, 1, 8], [8, 8, 8, 8]], np.int32)
POS = np.array([9, 13, 0], np.int32)
QSTART = np.array([4, 8, 0], np.int32)


def _pool(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((P, L, PG, KH, DH)).astype(dtype)
    v = rng.standard_normal((P, L, PG, KH, DH)).astype(dtype)
    k[2, 1, 1, 0, 3] = np.nan          # referenced pages
    v[5, 1, 0, 1, 0] = np.inf
    k[3, 1, 2, 1, 7] = -np.inf
    v[NULL, 1, 0, 0, 1] = np.nan       # the null page
    k[NULL, 1, 3, 1, 2] = 4.0e3        # range guard only
    v[1, 1, 1, 0, 4] = 3.0             # bit pattern only
    k[7, 1, 0, 0, 0] = np.nan          # unreferenced page
    return k, v


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _detector_pair(kind):
    if kind == "default":
        return "default", "default"
    if kind == "off_k":
        return None, "default"
    three = int(np.float32(3.0).view(np.uint32))
    spec = dict(max_magnitude=1e3, bitpatterns=((None, 0xFFFFFFFF, three),))
    return jrules.Detector(**spec), rules.Detector(**spec)


FILLS = {
    "zero": dict(policy="zero"),
    "const": dict(policy="constant", constant=0.5),
    "mixed": dict(policy_k="zero", policy_v="constant", constant_v=-1.25),
}


def _dets(kind):
    if kind in ("default", "off_k"):
        jd = td = _detector_pair(kind)
        return dict(detector_k=jd[0], detector_v=jd[1]), dict(detector_k=td[0], detector_v=td[1])
    jd, td = _detector_pair(kind)
    return dict(detector_k=jd, detector_v=jd), dict(detector_k=td, detector_v=td)


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("kind,fill", [("default", "zero"), ("custom", "mixed"),
                                       ("off_k", "const")])
def test_decode_plain_matches_pallas(splits, kind, fill):
    k, v = _pool()
    q = np.random.default_rng(1).standard_normal((3, H, DH)).astype(np.float32)
    jkw, tkw = _dets(kind)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(BT),
            jnp.asarray(POS), jnp.asarray(1, jnp.int32))
    if splits == 1:
        jout, jslot, jcnt = jpa.paged_attention_raw(*args, **jkw, **FILLS[fill])
    else:
        jout, jslot, jcnt = jpa.paged_attention_splitk_raw(
            *args, splits=splits, **jkw, **FILLS[fill])
    fn = pa.paged_attention_raw if splits == 1 else pa.paged_attention_splitk_raw
    kw = {} if splits == 1 else dict(splits=splits)
    tout, tslot, tcnt = fn(_t(q), _t(k), _t(v), _t(BT), _t(POS), 1,
                           **kw, **tkw, **FILLS[fill])
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("kind,fill", [("default", "zero"), ("custom", "mixed")])
def test_prefill_plain_matches_pallas(kind, fill):
    k, v = _pool(seed=2)
    q = np.random.default_rng(3).standard_normal((3, 6, H, DH)).astype(np.float32)
    jkw, tkw = _dets(kind)
    jout, jslot, jcnt = jpa.paged_prefill_raw(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(BT),
        jnp.asarray(QSTART), jnp.asarray(1, jnp.int32), **jkw, **FILLS[fill])
    tout, tslot, tcnt = pa.paged_prefill_raw(
        _t(q), _t(k), _t(v), _t(BT), _t(QSTART), 1, **tkw, **FILLS[fill])
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_oracles_match_reference_oracles():
    """``kernels.ref`` (gather then softmax) against the reference's."""
    k, v = _pool(seed=4)
    rng = np.random.default_rng(5)
    q = rng.standard_normal((3, H, DH)).astype(np.float32)
    qc = rng.standard_normal((3, 5, H, DH)).astype(np.float32)
    jk, jv, jbt = jnp.asarray(k), jnp.asarray(v), jnp.asarray(BT)
    cases = [
        (jref.paged_attention_ref(jnp.asarray(q), jk, jv, jbt, jnp.asarray(POS), layer=1),
         ref.paged_attention_ref(_t(q), _t(k), _t(v), _t(BT), _t(POS), layer=1)),
        (jref.paged_splitk_ref(jnp.asarray(q), jk, jv, jbt, jnp.asarray(POS), splits=2,
                               layer=1, policy="constant", constant=0.5),
         ref.paged_splitk_ref(_t(q), _t(k), _t(v), _t(BT), _t(POS), splits=2,
                              layer=1, policy="constant", constant=0.5)),
        (jref.paged_prefill_ref(jnp.asarray(qc), jk, jv, jbt, jnp.asarray(QSTART), layer=1),
         ref.paged_prefill_ref(_t(qc), _t(k), _t(v), _t(BT), _t(QSTART), layer=1)),
    ]
    for (jo, js), (to, ts) in cases:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    x = k.reshape(-1, DH)
    for block in [None, (8, 16), (4, 8)]:
        jf, jc = jref.scrub_ref(jnp.asarray(x), block=block)
        tf, tc = ref.scrub_ref(_t(x), block=block)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_plain_walk_matches_oracle_for_every_split():
    """The page-walk plain version against the gather-then-softmax oracle."""
    k, v = _pool(seed=6)
    q = _t(np.random.default_rng(7).standard_normal((3, H, DH)).astype(np.float32))
    want, wslot = ref.paged_attention_ref(q, _t(k), _t(v), _t(BT), _t(POS), layer=1)
    for splits in (1, 2, 4):
        got, slot, _ = pa.paged_decode_plain(q, _t(k), _t(v), _t(BT), _t(POS), 1,
                                             splits=splits)
        assert torch.equal(slot, wslot)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("kind", ["default", "custom"])
@pytest.mark.parametrize("fill", ["zero", "const"])
def test_scrub_pages_plain_matches_pallas(dtype, kind, fill):
    """Bucketed ids with a padding duplicate and ``n_valid``: counts and the
    pool's bits identical to the reference's page-view scrub."""
    import ml_dtypes

    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype
    k, _ = _pool(seed=8, dtype=np.float32)
    k = k.astype(np_dtype)
    ids = np.array([2, 3, NULL, 2], np.int32)
    jd, td = _detector_pair(kind) if kind == "custom" else (None, None)
    if kind == "custom" and dtype == "bfloat16":
        three = int(np.float32(3.0).view(np.uint32)) >> 16
        spec = dict(max_magnitude=1e3, bitpatterns=((None, 0xFFFF, three),))
        jd, td = jrules.Detector(**spec), rules.Detector(**spec)
    pol = dict(policy="zero") if fill == "zero" else dict(policy="constant", constant=0.5)
    jfixed, jc = j_scrub_pages(jnp.asarray(k), jnp.asarray(ids), detector=jd,
                                    n_valid=3, **pol)
    from repro_torch.convert import to_numpy, to_torch

    tk = to_torch(k)
    _, tc = scrub.scrub_pages(tk, ids, detector=td, n_valid=3, **pol)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(to_numpy(tk).view(np.uint8),
                                  np.asarray(jfixed).view(np.uint8))


@pytest.mark.parametrize("block", [None, (8, 16)])
def test_scrub_plain_matches_pallas(block):
    k, _ = _pool(seed=9)
    x = k.reshape(-1, DH)
    jfixed, jc = j_scrub(jnp.asarray(x), block=block, n_valid_rows=40)
    tx = _t(x).clone()
    _, tc = scrub.scrub(tx, block=block, n_valid_rows=40)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jfixed))


def test_wrappers_reject_bad_inputs():
    k, v = _pool()
    q = _t(np.zeros((3, H, DH), np.float32))
    with pytest.raises(ValueError):
        pa.paged_attention_splitk_raw(q, _t(k), _t(v), _t(BT), _t(POS), 1, splits=3)
    with pytest.raises(IndexError):
        scrub.scrub_pages(_t(k), [P + 1])
    with pytest.raises(ValueError, match="kernel policy"):
        pa.paged_attention_raw(q, _t(k), _t(v), _t(BT), _t(POS), 1,
                               policy="nearest")
    # neighbor_mean is a kernel fill now: the page's mean, as the reference's
    qn = np.random.default_rng(12).standard_normal((3, H, DH)).astype(np.float32)
    jout, jslot, jcnt = jpa.paged_attention_raw(
        jnp.asarray(qn), jnp.asarray(k), jnp.asarray(v), jnp.asarray(BT),
        jnp.asarray(POS), jnp.asarray(1, jnp.int32), policy="neighbor_mean")
    tout, tslot, tcnt = pa.paged_attention_raw(
        _t(qn), _t(k), _t(v), _t(BT), _t(POS), 1, policy="neighbor_mean")
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_cpu_path_launches_no_kernel():
    common.reset_launches()
    k, v = _pool()
    q = _t(np.zeros((3, H, DH), np.float32))
    pa.paged_attention_raw(q, _t(k), _t(v), _t(BT), _t(POS), 1)
    scrub.scrub_pages(_t(k), [2, 3])
    assert sum(common.LAUNCHES.values()) == 0
