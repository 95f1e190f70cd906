"""Port parity of ``kernels/ops.py`` (``repair_matmul``, ``flash_attention``)
against the reference's Pallas kernels, run in interpret mode on the CPU as
the reference's own tests run them (tests/test_kernels.py:53-57,128-132).

Inputs come from a numpy seed and cross to the port with
``convert.to_torch``.  The seven counters of both ops must be equal in
every case, causal S != T included (the port follows the reference
kernel's top-left causal alignment, not its oracle's); memory mode's
post-call operands must be bit-equal; float outputs agree within
rtol = atol = 1e-5 (f32 matmul), 2e-5 (f32 attention), 2e-2 (bf16 matmul)
and 3e-2 (bf16 attention), the two summing in different orders.  The CUDA
kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import rules as jrules  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.runtime import ApproxSpace as JSpace  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import detect, rules  # noqa: E402
from repro_torch.kernels import common, ops, ref  # noqa: E402
from repro_torch.runtime import ApproxSpace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AT_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
THREE = int(np.float32(3.0).view(np.uint32))
BF16_THREE = THREE >> 16


def _plant(x, rng, n_bad, value):
    flat = x.reshape(-1)
    flat[rng.choice(flat.size, n_bad, replace=False)] = value
    return x


def _both(x, dtype):
    """(jax array, torch tensor) of one numpy array in ``dtype``."""
    j = jnp.asarray(x).astype(DTYPES[dtype])
    return j, convert.to_torch(np.asarray(j))


def _bits_equal(t, j):
    want = np.asarray(j)
    width = want.dtype.itemsize * 8
    got = convert.to_numpy(t)
    udt = {16: np.uint16, 32: np.uint32}[width]
    np.testing.assert_array_equal(got.view(udt), want.view(udt))


def _detector(kind):
    """(reference, port) detectors of one kind."""
    if kind == "default":
        return None, None
    if kind == "range":
        spec = dict(max_magnitude=1e3)
    else:                                   # one bit pattern per dtype
        spec = dict(bitpatterns=(("float32", 0xFFFFFFFF, THREE),
                                 ("bfloat16", 0xFFFF, BF16_THREE)))
    return jrules.Detector(**spec), rules.Detector(**spec)


def _check_matmul(a, b, blocks, det_kind="default", out=None):
    """One reference memory-mode call against the port's register and
    memory calls on the same operands."""
    jd, td = _detector(det_kind)
    ja, ta = a
    jb, tb = b
    jr = jops.repair_matmul(ja, jb, mode="memory", blocks=blocks,
                            detector=jd, out_dtype=out and DTYPES[out])
    want_counts = np.asarray(jr.counts).tolist()
    out_t = out and getattr(torch, out)
    ta0, tb0 = ta.clone(), tb.clone()
    reg = ops.repair_matmul(ta, tb, mode="register", blocks=blocks,
                            detector=td, out_dtype=out_t)
    assert reg.a is ta and torch.equal(detect.bits_of(ta), detect.bits_of(ta0))
    assert torch.equal(detect.bits_of(tb), detect.bits_of(tb0))
    assert reg.counts.tolist() == want_counts
    tol = MM_TOL[out or str(ta.dtype).split(".")[-1]]
    np.testing.assert_allclose(reg.c.float().numpy(),
                               np.asarray(jr.c.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    mem = ops.repair_matmul(ta, tb, mode="memory", blocks=blocks,
                            detector=td, out_dtype=out_t)
    assert mem.counts.tolist() == want_counts
    assert torch.equal(mem.c, reg.c)
    _bits_equal(mem.a, jr.a)
    _bits_equal(mem.b, jr.b)
    if det_kind == "default":     # the oracle twin, ev_total by closed form
        assert ref.repair_matmul_ref(ta0, tb0, blocks=blocks)[1].tolist() == want_counts
    return want_counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mnk,blocks", [
    ((128, 128, 256), (64, 64, 128)),
    ((256, 128, 128), (128, 128, 128)),
    ((64, 512, 256), (64, 128, 256)),
])
@pytest.mark.parametrize("n_bad", [0, 1, 4])
def test_repair_matmul_matches_reference(mnk, blocks, dtype, n_bad):
    M, N, K = mnk
    rng = np.random.default_rng(M + N + K + n_bad)
    a = _plant(rng.standard_normal((M, K)).astype(np.float32), rng, n_bad, np.nan)
    b = _plant(rng.standard_normal((K, N)).astype(np.float32), rng, n_bad, -np.inf)
    counts = _check_matmul(_both(a, dtype), _both(b, dtype), blocks)
    assert (counts[6] > 0) == (n_bad > 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("det_kind", ["range", "bitpattern"])
def test_repair_matmul_detectors_match_reference(dtype, det_kind):
    rng = np.random.default_rng(7)
    a = rng.standard_normal((128, 256)).astype(np.float32)
    b = rng.standard_normal((256, 128)).astype(np.float32)
    _plant(a, rng, 3, 4.0e3)
    _plant(a, rng, 2, 3.0)
    _plant(b, rng, 2, -2.5e3)
    _plant(b, rng, 3, 3.0)
    _plant(b, rng, 1, np.nan)
    counts = _check_matmul(_both(a, dtype), _both(b, dtype), (64, 64, 128),
                           det_kind)
    assert counts[6] > 0


@pytest.mark.parametrize("case", ["blocks_none", "mixed_dtype"])
def test_repair_matmul_default_blocks_and_mixed_dtypes(case):
    rng = np.random.default_rng(11)
    a = _plant(rng.standard_normal((256, 256)).astype(np.float32), rng, 2, np.nan)
    b = _plant(rng.standard_normal((256, 128)).astype(np.float32), rng, 2, np.inf)
    if case == "blocks_none":
        _check_matmul(_both(a, "float32"), _both(b, "float32"), None)
    else:                    # A bf16, B f32: one detector row per operand
        _check_matmul(_both(a, "bfloat16"), _both(b, "float32"), (64, 64, 128),
                      out="float32")


AT_DIMS = [
    # (B, H, Kh, S, T, D), blocks
    ((2, 4, 2, 256, 256, 64), (64, 64)),
    ((1, 8, 8, 128, 128, 128), (64, 128)),
    ((2, 4, 1, 128, 256, 64), (128, 64)),          # S < T
    ((1, 4, 2, 256, 128, 64), (64, 32)),           # S > T
]


@pytest.mark.parametrize("dtype,causal", [
    ("float32", True), ("float32", False), ("bfloat16", True),
])
@pytest.mark.parametrize("dims,blocks", AT_DIMS)
def test_flash_attention_matches_reference(dims, blocks, dtype, causal):
    B, H, Kh, S, T, D = dims
    rng = np.random.default_rng(sum(dims) + causal)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = _plant(rng.standard_normal((B, Kh, T, D)).astype(np.float32), rng, 2, np.nan)
    v = _plant(rng.standard_normal((B, Kh, T, D)).astype(np.float32), rng, 2, np.inf)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    jr = jops.flash_attention(jq, jk, jv, mode="memory", causal=causal,
                              blocks=blocks)
    want = np.asarray(jr.counts).tolist()
    tk0 = tk.clone()
    reg = ops.flash_attention(tq, tk, tv, mode="register", causal=causal,
                              blocks=blocks)
    assert torch.equal(detect.bits_of(tk), detect.bits_of(tk0))
    assert reg.counts.tolist() == want
    np.testing.assert_allclose(reg.out.float().numpy(),
                               np.asarray(jr.out.astype(jnp.float32)),
                               rtol=AT_TOL[dtype], atol=AT_TOL[dtype])
    mem = ops.flash_attention(tq, tk, tv, mode="memory", causal=causal,
                              blocks=blocks)
    assert mem.counts.tolist() == want and torch.equal(mem.out, reg.out)
    _bits_equal(mem.k, jr.k)
    _bits_equal(mem.v, jr.v)
    again = ops.flash_attention(tq, mem.k, mem.v, mode="memory", causal=causal,
                                blocks=blocks)
    assert again.counts.tolist() == [0] * 8
    if S == T or not causal:                # where the two oracles agree
        oracle = ref.flash_attention_ref(tq, tk0, tv, causal=causal,
                                         kv_block=blocks[1])
        np.testing.assert_allclose(oracle.float().numpy(),
                                   reg.out.float().numpy(),
                                   rtol=AT_TOL[dtype], atol=AT_TOL[dtype])


def test_flash_attention_oracle_matches_reference_oracle():
    """The oracle twin keeps the reference oracle's bottom-right causal
    alignment, S != T included."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 64, 32)).astype(np.float32)
    k = _plant(rng.standard_normal((1, 2, 128, 32)).astype(np.float32), rng, 2, np.nan)
    v = rng.standard_normal((1, 2, 128, 32)).astype(np.float32)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), kv_block=32)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), kv_block=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_table3_loop_matches_reference_call_by_call():
    """Table 3 at n = 128, blocks 64: register re-fires every call, memory
    once; each call's counts and the unified stats equal the reference's."""
    rng = np.random.default_rng(5)
    a = _plant(rng.standard_normal((128, 128)).astype(np.float32), rng, 1, np.nan)
    b = rng.standard_normal((128, 128)).astype(np.float32)
    blocks = (64, 64, 64)
    jb = jnp.asarray(b)
    tb = torch.from_numpy(b)
    j_reg, j_mem = jnp.asarray(a), jnp.asarray(a)
    t_reg, t_mem = torch.from_numpy(a.copy()), torch.from_numpy(a.copy())
    spaces = {m: (JSpace(mode=m, policy="zero"), ApproxSpace(mode=m, policy="zero"))
              for m in ("register", "memory")}
    reg_events, mem_events = [], []
    for _ in range(3):
        jr = jops.repair_matmul(j_reg, jb, mode="register", blocks=blocks)
        jm = jops.repair_matmul(j_mem, jb, mode="memory", blocks=blocks)
        tr = ops.repair_matmul(t_reg, tb, mode="register", blocks=blocks)
        tm = ops.repair_matmul(t_mem, tb, mode="memory", blocks=blocks)
        assert tr.counts.tolist() == np.asarray(jr.counts).tolist()
        assert tm.counts.tolist() == np.asarray(jm.counts).tolist()
        j_reg, j_mem, t_reg, t_mem = jr.a, jm.a, tr.a, tm.a
        for mode, (js, ts) in spaces.items():
            res = (jr, tr) if mode == "register" else (jm, tm)
            js.record_kernel(res[0].counts)
            ts.record_kernel(res[1].counts)
        reg_events.append(int(tr.counts[ops.MM_EV_TOTAL]))
        mem_events.append(int(tm.counts[ops.MM_EV_TOTAL]))
    assert reg_events == [2, 2, 2] and mem_events == [2, 0, 0]
    for js, ts in spaces.values():
        assert ts.stats_dict() == js.stats_dict()


def test_register_mode_never_changes_its_operands():
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((64, 128), generator=gen)
    b = torch.randn((128, 64), generator=gen)
    a[3, 5], b[7, 1] = float("nan"), float("-inf")
    k = torch.randn((1, 2, 64, 64), generator=gen)
    k[0, 1, 9, 3] = float("nan")
    before = [detect.bits_of(t).clone() for t in (a, b, k)]
    res = ops.repair_matmul(a, b, mode="register", blocks=(32, 32, 64))
    att = ops.flash_attention(k.new_ones((1, 4, 64, 64)), k, k, mode="register")
    assert torch.isfinite(res.c).all() and torch.isfinite(att.out).all()
    for t, bits in zip((a, b, k), before):
        assert torch.equal(detect.bits_of(t), bits)


def test_ops_reject_bad_arguments():
    a, b = torch.zeros((64, 32)), torch.zeros((32, 48))
    with pytest.raises(ValueError, match="mode"):
        ops.repair_matmul(a, b, mode="sometimes")
    with pytest.raises(ValueError, match="divide"):
        ops.repair_matmul(a, b, blocks=(64, 32, 48))
    with pytest.raises(ValueError):
        ops.repair_matmul(a, a)
    with pytest.raises(ValueError, match="kernel policy"):
        ops.repair_matmul(a, b, policy="nearest")
    # neighbor_mean is a kernel fill now: the same product as the reference's
    rng = np.random.default_rng(2)
    an = rng.standard_normal((64, 32)).astype(np.float32)
    bn = rng.standard_normal((32, 48)).astype(np.float32)
    an[5, 7], bn[3, 40] = np.nan, np.inf
    jr = jops.repair_matmul(jnp.asarray(an), jnp.asarray(bn), mode="register",
                            policy="neighbor_mean")
    tr = ops.repair_matmul(torch.from_numpy(an), torch.from_numpy(bn),
                           mode="register", policy="neighbor_mean")
    assert tr.counts.tolist() == np.asarray(jr.counts).tolist()
    np.testing.assert_allclose(tr.c.numpy(), np.asarray(jr.c),
                               rtol=MM_TOL["float32"], atol=MM_TOL["float32"])
    q = torch.zeros((1, 4, 32, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros((1, 3, 32, 16)), torch.zeros((1, 3, 32, 16)))
    common.reset_launches()
    ops.repair_matmul(a, b)
    assert sum(common.LAUNCHES.values()) == 0       # CPU: plain versions only


def test_quickstart_twin_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", ROOT / "examples" / "torch_quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(device="cpu")
    assert out["register"] == [4, 4, 4, 4] and out["memory"] == [4, 0, 0, 0]
    assert out["nan_outputs"] == 512
    assert out["stats"]["flips"] == out["flips"] > 0
    assert "paper Table 3" in capsys.readouterr().out
