"""Port parity of the chunked mLSTM: ``kernels.mlstm_chunk`` (its plain
version, the CPU path of the wrapper) against the reference's Pallas
kernel in interpret mode, and the port's ``_chunked_mlstm`` oracle twin
against the reference's oracle, on the same numpy-seeded inputs.

Counts must be identical.  Tolerances: kernel against kernel 2e-5
(rtol and atol) in f32 and bf16 alike, since both take f32 operands after
the repair and differ only in summation order; the oracle twins 2e-5 in
f32 and 3e-2 in bf16 (``tests/test_mlstm_kernel.py``'s bound: the oracle
rounds ``W`` to bf16, where a last-place difference flips roundings).
Under ``include_inf=False`` the Inf lanes pass into the state and the
outputs are poisoned; NaN and Inf must then sit in the same places.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import mlstm_chunk as jmc  # noqa: E402
from repro.nn import xlstm as jxl  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.kernels import mlstm_chunk as mc  # noqa: E402
from repro_torch.nn import xlstm as txl  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def make(B, S, H, P, seed, dtype="float32"):
    """q, k, v (B, S, H, P) in ``dtype`` and f32 gates (B, S, H), as
    ``tests/test_mlstm_kernel.py`` draws them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, P)).astype(np.float32) / np.sqrt(P)
    k = rng.standard_normal((B, S, H, P)).astype(np.float32)
    v = rng.standard_normal((B, S, H, P)).astype(np.float32)
    li = (rng.standard_normal((B, S, H)) * 0.5).astype(np.float32)
    x = rng.standard_normal((B, S, H)) + 2.0
    lf = (-np.log1p(np.exp(-x))).astype(np.float32)
    dt = DTYPES[dtype]
    return q.astype(dt), k.astype(dt), v.astype(dt), li, lf


def plant(q, k, v):
    """NaN, +Inf and -Inf lanes in q, k and v, across chunks and heads;
    the Inf lanes are fatal only under ``include_inf``."""
    B, S, H, P = q.shape
    spots = [
        (q, (0, 1, 0, 3), np.nan), (q, (B - 1, S - 2, H - 1, 0), np.inf),
        (k, (0, S // 2, H - 1, 5), np.nan), (k, (B - 1, 3, 0, P - 1), -np.inf),
        (v, (0, S - 1, 0, 2), np.nan), (v, (B - 1, S // 2 + 1, H - 1, 7), np.inf),
        (v, (0, 2, H - 1, 1), -np.inf),
    ]
    for arr, idx, val in spots:
        arr[idx] = val
    return q, k, v


def both(*arrays):
    """The same arrays as jax arrays and as torch tensors."""
    return [jnp.asarray(a) for a in arrays], [to_torch(a) for a in arrays]


def to5(x, Q):
    B, S, H, P = x.shape
    return np.ascontiguousarray(
        x.reshape(B, S // Q, Q, H, P).transpose(0, 3, 1, 2, 4))


def gates5(x, Q):
    B, S, H = x.shape
    return np.ascontiguousarray(x.reshape(B, S // Q, Q, H).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims,chunk", [
    ((2, 64, 2, 16), 16),
    ((2, 32, 1, 16), 128),     # single chunk (Q = S): no carried state
])
def test_mlstm_chunked_matches_reference(dims, chunk, dtype):
    q, k, v, li, lf = make(*dims, seed=sum(dims), dtype=dtype)
    j, t = both(*plant(q, k, v), li, lf)
    jy, jc = jmc.mlstm_chunked(*j, chunk=chunk)
    ty, tc = mc.mlstm_chunked(*t, chunk=chunk)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tc[mc.EV_TOTAL]) > 0
    assert ty.dtype == torch.float32 and ty.shape == tuple(dims)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("include_inf", [True, False])
@pytest.mark.parametrize("policy,constant", [("zero", 0.0), ("constant", 0.5)])
def test_mlstm_chunk_raw_policies_and_detectors(dtype, include_inf, policy,
                                                constant):
    Q = 16
    q, k, v, li, lf = make(2, 64, 2, 16, seed=11, dtype=dtype)
    q, k, v = plant(q, k, v)
    arrays = [to5(x, Q) for x in (q, k, v)] + [gates5(x, Q) for x in (li, lf)]
    j, t = both(*arrays)
    kw = dict(policy=policy, constant=constant, include_inf=include_inf)
    jy, jc = jmc.mlstm_chunk_raw(*j, **kw)
    ty, tc = mc.mlstm_chunk_raw(*t, **kw)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    if include_inf:
        assert int(tc[mc.INF_Q]) == 1 and int(tc[mc.INF_KV]) == 3
        assert bool(torch.isfinite(ty).all())
    else:
        assert int(tc[mc.INF_Q]) == 0 and int(tc[mc.INF_KV]) == 0
    assert int(tc[mc.NAN_Q]) == 1 and int(tc[mc.NAN_KV]) == 2
    np.testing.assert_array_equal(np.isnan(ty.numpy()), np.isnan(np.asarray(jy)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), equal_nan=True, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_oracle_twin_matches_reference(dtype):
    q, k, v, li, lf = make(2, 64, 2, 16, seed=5, dtype=dtype)
    j, t = both(q, k, v, li, lf)
    want = np.asarray(jxl._chunked_mlstm(*j, chunk=16))
    got = txl._chunked_mlstm(*t, chunk=16).numpy()
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # the kernel path against the twin: only W's bf16 rounding differs
    ky, _ = mc.mlstm_chunked(*t, chunk=16)
    np.testing.assert_allclose(ky.numpy(), got, rtol=tol, atol=tol)


def test_repairs_poisoned_kv_state_stays_clean():
    """A NaN in k reaches the carried state and poisons every later chunk
    of the unrepaired oracle (the temporal Fig. 1); the kernel path
    repairs it before it is consumed."""
    q, k, v, li, lf = make(2, 64, 2, 16, seed=3)
    k[0, 5, 1, 2] = k[1, 20, 0, 9] = k[1, 33, 1, 0] = np.nan
    _, t = both(q, k, v, li, lf)
    poisoned = txl._chunked_mlstm(*t, chunk=16)
    assert bool(torch.isnan(poisoned).any())
    assert bool(torch.isnan(poisoned[:, -16:]).any())     # the last chunk
    y, counts = mc.mlstm_chunked(*t, chunk=16)
    assert bool(torch.isfinite(y).all())
    assert int(counts[mc.EV_TOTAL]) > 0 and int(counts[mc.NAN_KV]) == 3


def test_unported_fill_and_bad_shapes_raise():
    """An unknown fill and bad shapes raise; ``neighbor_mean``, ported now,
    matches the reference kernel."""
    q, k, v, li, lf = make(1, 16, 1, 8, seed=0)
    q, k, v = plant(q, k, v)
    arrays = [to5(x, 16) for x in (q, k, v)] + [gates5(x, 16) for x in (li, lf)]
    j, tg = both(*arrays)
    t, g = tg[:3], tg[3:]
    with pytest.raises(ValueError, match="kernel policy"):
        mc.mlstm_chunk_raw(*t, *g, policy="nearest")
    jy, jc = jmc.mlstm_chunk_raw(*j, policy="neighbor_mean")
    ty, tc = mc.mlstm_chunk_raw(*t, *g, policy="neighbor_mean")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    with pytest.raises(ValueError, match="gates"):
        mc.mlstm_chunk_raw(*t, g[0][..., :8], g[1])
