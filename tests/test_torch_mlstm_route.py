"""The route rule of the chunked mLSTM, the hi/lo split and the wgmma
route's plain twin, on the CPU.

``route`` is a pure function of the operands' dtypes, shapes, contiguity
and data pointers, so it is held here on CPU tensors.  The wgmma route
computes W v, q C and the C update on the tensor cores from bf16 terms of
its f32 operands (W in three terms, C and src ∘ v in two), so its plain
twin ``mlstm_chunk_split_plain`` is held against the reference's Pallas
kernel (``src/repro/kernels/mlstm_chunk.py::mlstm_chunk_raw``) in
interpret mode, as ``tests/test_torch_mlstm.py`` runs it: counts equal,
NaN and Inf in the same places, y within 1e-4 (rtol and atol; a hi/lo
pair keeps x to 2⁻¹⁷ relative, against f32's 2⁻²⁴, and the kernels'
outputs are ratios of sums that cancel; the largest error here is about a
fifth of it).  The kernel itself is held against both plain versions on
the card (``tests/test_torch_cuda.py``).
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import mlstm_chunk as jmc  # noqa: E402
from repro_torch.convert import to_torch  # noqa: E402
from repro_torch.kernels import mlstm_chunk as mc  # noqa: E402

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
TOL = dict(rtol=1e-4, atol=1e-4)


def _view(shape, dtype, off=0):
    """A contiguous tensor of ``shape`` starting ``off`` elements into its
    storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + off, dtype=dtype)[off:].view(shape)


XL = (1, 4, 16, 128, 1024)     # xlstm-1.3b: one block's mLSTM over 2,048 tokens


@pytest.mark.parametrize("shape,dtypes,offs,want", [
    (XL, (BF16,) * 3, (0, 0, 0), "wgmma"),
    ((1, 2, 3, 32, 64), (BF16,) * 3, (0, 0, 0), "wgmma"),
    ((2, 2, 3, 48, 96), (BF16,) * 3, (0, 0, 0), "wgmma"),     # Q = 48: M padded to 64
    ((1, 1, 1, 16, 8), (BF16,) * 3, (0, 0, 0), "wgmma"),      # the smallest
    ((2, 2, 5, 32, 96), (BF16,) * 3, (0, 0, 0), "wgmma"),
    ((1, 2, 1, 128, 64), (BF16,) * 3, (0, 0, 0), "wgmma"),
    (XL, (F32,) * 3, (0, 0, 0), "ffma"),
    (XL, (F16,) * 3, (0, 0, 0), "ffma"),
    (XL, (BF16, BF16, F16), (0, 0, 0), "ffma"),
    (XL, (BF16, F32, BF16), (0, 0, 0), "ffma"),
    ((2, 2, 3, 48, 100), (BF16,) * 3, (0, 0, 0), "ffma"),     # P % 8 != 0
    ((1, 2, 3, 32, 1032), (BF16,) * 3, (0, 0, 0), "ffma"),    # P > 1024
    ((1, 2, 3, 40, 64), (BF16,) * 3, (0, 0, 0), "ffma"),      # Q % 16 != 0
    ((1, 2, 3, 8, 64), (BF16,) * 3, (0, 0, 0), "ffma"),       # Q < 16
    ((1, 2, 3, 144, 64), (BF16,) * 3, (0, 0, 0), "ffma"),     # Q > MAX_CHUNK
    ((0, 2, 3, 32, 64), (BF16,) * 3, (0, 0, 0), "ffma"),      # empty
    (XL, (BF16,) * 3, (1, 0, 0), "ffma"),      # q 2 bytes off
    (XL, (BF16,) * 3, (0, 4, 0), "ffma"),      # k 8 bytes off
    (XL, (BF16,) * 3, (0, 0, 2), "ffma"),      # v 4 bytes off
    (XL, (BF16,) * 3, (8, 16, 24), "wgmma"),   # 16, 32, 48 bytes off
])
def test_route_rule(shape, dtypes, offs, want):
    q, k, v = (_view(shape, d, o) for d, o in zip(dtypes, offs))
    assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
    assert mc.route(q, k, v) == want


def test_route_needs_contiguous_operands_of_one_shape():
    q = _view((1, 2, 3, 64, 32), BF16).transpose(-1, -2)    # (1, 2, 3, 32, 64)
    k = _view((1, 2, 3, 32, 64), BF16)
    assert mc.route(q, k, k) == "ffma"
    assert mc.route(q.contiguous(), k, k) == "wgmma"
    assert mc.route(k, k, _view((1, 2, 3, 32, 128), BF16)) == "ffma"
    assert mc.route(k[0], k[0], k[0]) == "ffma"             # not 5-D


def test_split_rebuilds_x():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.integers(-30, 30, 4096)).astype(np.float32))
    hi, lo = mc.split_bf16(x, 2)
    for part in (hi, lo):
        assert torch.equal(part, part.to(BF16).float())    # bf16 values
    rel = ((hi + lo) - x).abs() / x.abs()
    assert float(rel.max()) <= 2.0 ** -16
    assert torch.equal(hi, x.to(BF16).float())
    three = mc.split_bf16(x, 3)
    assert torch.equal((three[0] + three[1]) + three[2], x)  # exact in f32


def test_split_carries_non_finite_lanes_in_hi_alone():
    x = torch.tensor([float("inf"), -float("inf"), float("nan"), 1.0 + 2 ** -20,
                      0.0, -3.0])
    for terms in (2, 3):
        parts = mc.split_bf16(x, terms)
        assert torch.equal(parts[0][:2], x[:2]) and bool(parts[0][2].isnan())
        for part in parts[1:]:
            assert torch.equal(part[:3], torch.zeros(3))   # lo = 0, never NaN
        assert float(parts[1][3]) == 2 ** -20
        assert torch.equal(parts[0][4:], x[4:])


def _inputs(B, H, nc, Q, P, seed):
    """q, k, v (B, H, nc, Q, P) bf16 with NaN, +Inf and -Inf planted in
    each, across chunks and heads; f32 gates (B, H, nc, Q)."""
    rng = np.random.default_rng(seed)
    shape = (B, H, nc, Q, P)
    q = rng.standard_normal(shape).astype(np.float32) / np.sqrt(P)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    li = (rng.standard_normal(shape[:4]) * 0.5).astype(np.float32)
    lf = (-np.log1p(np.exp(-(rng.standard_normal(shape[:4]) + 2.0)))).astype(np.float32)
    for arr, idx, val in [
        (q, (0, 1, 0, 3, 5), np.nan), (q, (B - 1, 0, nc - 1, Q - 2, P - 1), np.inf),
        (k, (0, H - 1, nc // 2, 5, 2), np.nan), (k, (B - 1, 0, 1, Q - 1, 7), -np.inf),
        (v, (0, 0, nc - 1, 2, 9), np.nan), (v, (B - 1, H - 1, 1, 4, 3), np.inf),
        (v, (0, H - 1, 0, 1, P - 2), -np.inf),
    ]:
        arr[idx] = val
    bf = ml_dtypes.bfloat16
    return [q.astype(bf), k.astype(bf), v.astype(bf), li, lf]


@pytest.mark.parametrize("dims", [(1, 2, 3, 32, 64), (2, 2, 2, 48, 40)])
@pytest.mark.parametrize("include_inf", [True, False])
@pytest.mark.parametrize("policy,constant", [("zero", 0.0), ("constant", 0.5)])
def test_split_twin_matches_reference(dims, include_inf, policy, constant):
    arrays = _inputs(*dims, seed=sum(dims))
    kw = dict(policy=policy, constant=constant, include_inf=include_inf)
    jy, jc = jmc.mlstm_chunk_raw(*[jnp.asarray(a) for a in arrays], **kw)
    t = [to_torch(a) for a in arrays]
    assert mc.route(*t[:3]) == "wgmma"
    ty, tc = mc.mlstm_chunk_split_plain(*t, **kw)
    jy = torch.from_numpy(np.array(jy))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tc[mc.NAN_Q]) == 1 and int(tc[mc.NAN_KV]) == 2
    assert int(tc[mc.INF_Q] + tc[mc.INF_KV]) == (4 if include_inf else 0)
    assert ty.dtype == torch.float32 and ty.shape == tuple(dims)
    fin = jy.isfinite()
    assert bool(fin.all()) == include_inf
    assert torch.equal(ty.isfinite(), fin) and torch.equal(ty.isnan(), jy.isnan())
    assert torch.equal(ty[jy.isinf()], jy[jy.isinf()])
    torch.testing.assert_close(ty[fin], jy[fin], **TOL)


@pytest.mark.parametrize("include_inf", [True, False])
def test_split_twin_under_strong_forget_gates(include_inf):
    """Forget gates of log f ≈ −0.69 a step, as strong as the random-weight
    xLSTM-1.3b's (≈ −0.70), take src, resc and the clamp of a chunk's first
    rows just into f32's subnormal range within 128 steps: still exact
    enough in f32, but below what a bf16 term keeps.  The twin scales each
    row by its power of two before splitting, and must agree with the plain
    version there.  The plain version, not the reference: XLA's CPU backend
    flushes subnormals to zero, so the reference kernel's first rows come
    out 0 / 0 in this regime."""
    q, k, v, li, lf = _inputs(1, 2, 2, 128, 64, seed=21)
    rng = np.random.default_rng(22)
    g = rng.standard_normal((2,) + li.shape) * 0.01
    t = [to_torch(a) for a in (q, k, v)] + [
        torch.from_numpy(g[0].astype(np.float32)),
        torch.from_numpy((g[1] - 0.69).astype(np.float32))]
    b = t[3][0, 0, 0] - torch.cumsum(t[4][0, 0, 0], 0)
    src = torch.exp(b - b.max())
    assert 1e-40 < float(src.min()) < 1.2e-38          # the regime is reached
    kw = dict(include_inf=include_inf)
    (ty, tc), (py, pc) = (mc.mlstm_chunk_split_plain(*t, **kw),
                          mc.mlstm_chunk_plain(*t, **kw))
    assert torch.equal(tc, pc)
    fin = py.isfinite()
    assert bool(fin.all()) == include_inf
    assert torch.equal(ty.isfinite(), fin) and torch.equal(ty.isnan(), py.isnan())
    assert torch.equal(ty[py.isinf()], py[py.isinf()])
    torch.testing.assert_close(ty[fin], py[fin], **TOL)


def test_split_twin_matches_plain_version_on_clean_operands():
    """Without faults the twin differs from the plain version only by the
    split (f32 operands in both otherwise)."""
    arrays = _inputs(1, 2, 4, 64, 128, seed=3)
    t = [to_torch(a) for a in arrays]
    for x in t[:3]:
        x[~x.float().isfinite()] = 0.5
    got, want = mc.mlstm_chunk_split_plain(*t), mc.mlstm_chunk_plain(*t)
    assert torch.equal(got[1], want[1]) and got[1].tolist() == [0] * 8
    assert bool(got[0].isfinite().all())
    torch.testing.assert_close(got[0], want[0], **TOL)
