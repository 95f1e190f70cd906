"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one.  The file imports neither JAX nor the reference, so it also
runs on a machine without JAX; there, skip the JAX-importing conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: f32 1e-4 (kernel and plain version sum in different orders);
bf16 2e-2 (bf16 outputs, and softmax weights rounded to bf16 before the
value product, where a last-place f32 difference can flip one rounding);
f16 1e-2 (f16 matmul outputs: exact products summed in f32 in different
orders, then one rounding to f16, whose ulp is 2^-10 relative).
The mLSTM kernel takes 1e-4 for both input dtypes: on the FFMA route its
arithmetic is f32 after the repair, so only the summation order differs;
on the wgmma route (bf16) the f32 state C and src * v reach the tensor
cores as bf16 hi/lo pairs (2^-17 relative) and W as three bf16 terms.  Integer outputs
(slot counts, AT, MM and mLSTM counts, scrub counts, repaired bits) must be
identical.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import detect  # noqa: E402
from repro_torch.core.rules import Detector  # noqa: E402
from repro_torch.kernels import common, ops, paged_attention as pa, scrub  # noqa: E402
from repro_torch.kernels import repair_attention as ra  # noqa: E402
from repro_torch.kernels import mlstm_chunk as mc  # noqa: E402
from repro_torch.kernels import repair_matmul as rm  # noqa: E402
from repro_torch.kernels import tile_fill  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import TransformerLM, XLSTMLM  # noqa: E402
from repro_torch.runtime import ApproxConfig  # noqa: E402
from repro_torch.serving import Engine, ServingConfig  # noqa: E402

P, L, PG, KH, DH, H = 9, 2, 4, 2, 16, 4
NULL = P - 1
BT = [[0, 2, 8, 8], [5, 3, 1, 8], [8, 8, 8, 8]]
POS = [9, 13, 0]
QSTART = [4, 8, 0]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _pool(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(0)
    k = torch.randn((P, L, PG, KH, DH), generator=gen, device=dev)
    v = torch.randn((P, L, PG, KH, DH), generator=gen, device=dev)
    k[2, 1, 1, 0, 3] = float("nan")
    v[5, 1, 0, 1, 0] = float("inf")
    k[3, 1, 2, 1, 7] = float("-inf")
    v[NULL, 1, 0, 0, 1] = float("nan")
    return k.to(dtype), v.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions(cuda, dtype):
    tol = TOL[dtype]
    k, v = _pool(cuda, dtype)
    bt = torch.tensor(BT, dtype=torch.int32, device=cuda)
    pos = torch.tensor(POS, dtype=torch.int32, device=cuda)
    qs = torch.tensor(QSTART, dtype=torch.int32, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((3, H, DH), generator=gen, device=cuda).to(dtype)
    qc = torch.randn((3, 6, H, DH), generator=gen, device=cuda).to(dtype)
    common.reset_launches()
    for splits in (1, 2, 4):
        got = pa.paged_attention_splitk_raw(q, k, v, bt, pos, 1, splits=splits,
                                            policy_v="constant", constant_v=0.5)
        want = pa.paged_decode_plain(q, k, v, bt, pos, 1, splits=splits,
                                     policy_v="constant", constant_v=0.5)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol, atol=tol)
    got = pa.paged_prefill_raw(qc, k, v, bt, qs, 1)
    want = pa.paged_prefill_plain(qc, k, v, bt, qs, 1)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol, atol=tol)
    a, b = k.clone(), k.clone()
    ids = [2, 3, NULL, 2]
    assert torch.equal(scrub.scrub_pages(a, ids, n_valid=3)[1],
                       scrub.scrub_pages_plain(b, ids, n_valid=3)[1])
    assert torch.equal(detect.bits_of(a), detect.bits_of(b))
    a, b = v.clone(), v.clone()
    assert torch.equal(scrub.scrub(a)[1], scrub.scrub_plain(b)[1])
    assert torch.equal(detect.bits_of(a), detect.bits_of(b))
    assert common.LAUNCHES == {"paged_decode": 3, "paged_prefill": 1, "scrub": 2}


@pytest.mark.cuda
def test_engine_on_the_card_matches_the_cpu(cuda):
    """The tiny f32 engine: kernels on the card, plain versions on the CPU,
    the same weights and planted faults — identical tokens and counters."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(
        get_config("qwen2-1.5b").reduced(), n_layers=2, d_model=64, n_heads=4,
        n_kv=2, head_dim=16, d_ff=128, vocab=97, repair=ApproxConfig(mode="off"),
    )
    gpu = TransformerLM(cfg, device=cuda, seed=0)
    cpu = TransformerLM(cfg, device="cpu", seed=1)
    cpu.load_state_dict({n: p.cpu() for n, p in gpu.state_dict().items()})
    scfg = ServingConfig(page_size=2, n_pages=24, max_batch=3, max_pages_per_request=8)
    outs = []
    for model, dev in ((gpu, cuda), (cpu, "cpu")):
        eng = Engine(model, scfg, device=dev)
        for i in range(5):
            eng.add_request(list(range(1 + i, 6 + 2 * i)), max_new=5)
        step = 0
        while eng.has_work:
            eng.step()
            step += 1
            if step == 3:
                page = eng.sched.running[0].pages[0]
                eng.pool.tree["layers/k"][page, 1, 0, 0, 2] = float("nan")
                eng.pool.tree["layers/v"][page, 0, 0, 1, 4] = float("inf")
        outs.append((
            {r: res["tokens"] for r, res in eng.results.items()},
            eng.pool.page_events.tolist(), eng.stats_dict(),
            eng.kernel_counts.tolist(),
        ))
    assert outs[0] == outs[1]
    assert outs[0][2]["nan_found"] == 1 and outs[0][2]["inf_found"] == 1


@pytest.mark.cuda
def test_prefix_cache_and_tier_on_the_card_match_the_cpu(cuda):
    """The tiny f32 engine with the prefix cache and the host tier: cache
    hits with copy-on-write forks, a NaN in a cached full page taking back
    its snapshot's bits (``dwell_threshold=0``), and preemptions swapping
    through the pinned host store — identical on the card and the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(
        get_config("qwen2-1.5b").reduced(), n_layers=2, d_model=64, n_heads=4,
        n_kv=2, head_dim=16, d_ff=128, vocab=97, repair=ApproxConfig(mode="off"),
    )
    gpu = TransformerLM(cfg, device=cuda, seed=0)
    cpu = TransformerLM(cfg, device="cpu", seed=1)
    cpu.load_state_dict({n: p.cpu() for n, p in gpu.state_dict().items()})
    scfg = ServingConfig(page_size=4, n_pages=10, max_batch=4, max_pages_per_request=5,
                         prefix_cache=True, dwell_threshold=0.0, host_pages=12)
    shared = [1, 2, 3, 4, 5, 6, 7, 8]
    outs = []
    for model, dev in ((gpu, cuda), (cpu, "cpu")):
        eng = Engine(model, scfg, device=dev)
        assert eng.tiers.host._buffers["layers/k"].is_pinned() == (dev != "cpu")
        eng.add_request(shared + [9, 10], max_new=4)
        eng.run()
        e = next(e for e in eng.cache._entries.values() if not e.partial)
        eng.pool.tree["layers/k"][e.page, 1, 2, 0, 3] = float("nan")
        for i in range(6):
            eng.add_request(shared + [9 + i, 20 + i], max_new=10)
        eng.step()              # the first hit repairs the page from its snapshot
        assert torch.equal(detect.bits_of(eng.pool.tree["layers/k"][e.page].cpu()),
                           detect.bits_of(e.snapshot["layers/k"][0]))
        eng.run()
        outs.append((
            {r: res["tokens"] for r, res in eng.results.items()},
            eng.pool.page_events.tolist(), eng.stats_dict(), eng.cache_stats(),
            eng.tier_stats(), eng.kernel_counts.tolist(), eng.n_host_syncs,
        ))
    assert outs[0] == outs[1]
    cache, tiers = outs[0][3], outs[0][4]
    assert cache["reuse_ref_repairs"] > 0 and cache["cow_forks"] > 0
    assert tiers["n_swap_preemptions"] > 0 and tiers["swap_ins"] == tiers["swap_outs"]


@pytest.mark.cuda
def test_matmul_f32_on_the_card(cuda):
    """bf16 operands on the card: one GEMM with an f32 result, equal to the
    f32 product of the same values up to the summation order, also for a
    transposed weight view (the tied readout's)."""
    from repro_torch.nn.layers import matmul_f32

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((3, 5, 256), generator=gen, device=cuda).bfloat16()
    w = torch.randn((256, 96), generator=gen, device=cuda).bfloat16()
    for b in (w, w.t().contiguous().t()):
        got = matmul_f32(a, b)
        want = torch.matmul(a.float(), b.float())
        assert got.dtype == torch.float32 and got.shape == (3, 5, 96)
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _plant(x, seed):
    """NaN, ±Inf, a range-guard value (3e4) and a bit-pattern value (3.0)
    at seeded positions of ``x`` (in place)."""
    gen = torch.Generator().manual_seed(seed)
    flat = x.view(-1)
    idx = torch.randperm(flat.numel(), generator=gen)[:5].tolist()
    for i, val in zip(idx, (float("nan"), float("inf"), float("-inf"), 3.0e4, 3.0)):
        flat[i] = val
    return x


def _detectors(dtype):
    lay = detect.layout_of(dtype)
    three = int(detect.bits_of(torch.tensor([3.0], dtype=dtype))[0])
    mask = (1 << lay.width) - 1
    return [None, Detector(max_magnitude=1e3,
                           bitpatterns=((None, mask, three & mask),))]


F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
# logical blocks that split each shape, besides the default fit
MM_SPLIT = {(96, 264, 320): (32, 64, 88), (96, 260, 324): (32, 108, 130),
            (200, 1032, 328): (50, 82, 86)}
# id: (M, K, N), (a, b, out dtypes), expected route, extra plants
MM_CASES = {
    "f32": ((96, 264, 320), (F32, F32, None), "ffma", None),
    "bf16": ((96, 264, 320), (BF16, BF16, None), "wgmma", None),
    "bf16xf32": ((96, 264, 320), (BF16, F32, F32), "ffma", None),
    "f16": ((96, 264, 320), (F16, F16, None), "wgmma", None),
    "bf16-out-f32": ((96, 264, 320), (BF16, BF16, F32), "wgmma", None),
    "bf16-unaligned": ((96, 260, 324), (BF16, BF16, None), "ffma", None),
    "ring-corners": ((200, 1032, 328), (BF16, BF16, None), "wgmma", "corners"),
    "all-fatal-tile": ((200, 1032, 328), (BF16, BF16, None), "wgmma", "tile"),
    "zero-pattern": ((200, 1032, 328), (BF16, BF16, None), "wgmma", "zeros"),
}
# corners of the wgmma route's 128 x 64 A tiles and 64 x 256 B tiles, and
# lanes of the last, partial k stage (k >= 1024 of K = 1032)
A_CORNERS = [(0, 0), (127, 63), (128, 64), (199, 1031), (5, 1030)]
B_CORNERS = [(0, 0), (63, 255), (64, 256), (1031, 327), (1028, 3)]


def _mm_operands(dev, shape, dtypes, extra, nm_blocks=None):
    """A and B of one MM_CASES entry; with ``nm_blocks`` (bm, bn, bk), the
    neighbor_mean operands (_nm_note): each logical tile's offset, and NaN
    at A[1, 2] and B[3, 4] facing NM_SPIKE at B[2, 6] and A[5, 3]."""
    M, K, N = shape
    da, db, _ = dtypes
    gen = torch.Generator(device=dev).manual_seed(2)
    a = torch.randn((M, K), generator=gen, device=dev)
    b = torch.randn((K, N), generator=gen, device=dev)
    if nm_blocks is not None:
        bm, bn, bk = nm_blocks
        a += _tile_offsets(M, K, (bm, bk), dev)
        b += _tile_offsets(K, N, (bk, bn), dev)
        a[1, 2], b[2, 6] = float("nan"), NM_SPIKE
        b[3, 4], a[5, 3] = float("nan"), NM_SPIKE
    a, b = _plant(a, 3), _plant(b, 4)
    vals = [float("nan"), float("inf"), float("-inf"), 3.0e4, 3.0]
    if extra == "corners":
        for (x, corners) in ((a, A_CORNERS), (b, B_CORNERS)):
            for (r, c), val in zip(corners, vals):
                x[r, c] = val
    elif extra == "tile":         # one whole A tile and one whole B tile
        a[:128, 64:128] = float("nan")
        b[64:128, :256] = float("-inf")
    elif extra == "zeros":        # the bit pattern of +0.0, which TMA pads with
        for (x, corners) in ((a, A_CORNERS), (b, B_CORNERS)):
            for r, c in corners:
                x[r, c] = 0.0
    return a.to(da), b.to(db)


def _mm_detectors(dtype, extra):
    """(detector, policy kwargs) pairs of one case.  The zero-pattern case
    fills with 0.5, so a padding lane repaired by mistake would show."""
    if extra == "zeros":
        mask = (1 << detect.layout_of(dtype).width) - 1
        return [(Detector(bitpatterns=((None, mask, 0),)),
                 dict(policy="constant", constant=0.5))]
    return [(det, {}) for det in _detectors(dtype)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MM_CASES))
@pytest.mark.parametrize("split", [False, True])
def test_repair_matmul_kernel_matches_plain(cuda, case, split):
    """Both routes against the plain version: ragged physical edges, the
    wgmma ring wrapped several times with ragged M, N and a partial last k
    stage, planted lanes at tile corners, a whole fatal tile, and a
    detector that matches TMA's zero padding; under both detectors (one for
    the zero-pattern case).  Memory mode leaves the operands bit-equal to
    the plain scrub, and a second call counts nothing."""
    shape, dtypes, want_route, extra = MM_CASES[case]
    da, db, out = dtypes
    tol = TOL[out or da]
    blocks = MM_SPLIT[shape] if split else None
    a, b = _mm_operands(cuda, shape, dtypes, extra)
    assert rm.route(a, b) == want_route
    for det, pkw in _mm_detectors(da, extra):
        common.reset_launches()
        kw = dict(blocks=blocks, out_dtype=out, detector=det, **pkw)
        got = rm.repair_matmul_raw(a, b, **kw)
        want = rm.repair_matmul_plain(a, b, **kw)
        assert common.LAUNCHES == {"repair_matmul": 1}
        assert torch.equal(got[1], want[1]) and int(got[1][rm.EV_TOTAL]) > 0
        torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol, atol=tol)
        ka, kb, pa_, pb = a.clone(), b.clone(), a.clone(), b.clone()
        res = ops.repair_matmul(ka, kb, mode="memory", **kw)
        assert res.a is ka and torch.equal(res.counts, want[1])
        scrub.scrub_plain(pa_, detector=det, **pkw)
        scrub.scrub_plain(pb, detector=det, **pkw)
        assert torch.equal(detect.bits_of(ka), detect.bits_of(pa_))
        assert torch.equal(detect.bits_of(kb), detect.bits_of(pb))
        again = ops.repair_matmul(ka, kb, mode="memory", **kw)
        assert again.counts.tolist() == [0] * 8


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c, v in MM_CASES.items() if v[2] == "wgmma"])
def test_repair_matmul_scan_matches_plain(cuda, case):
    """The wgmma route's scan kernel: per-logical-tile lane counts and
    per-physical-tile flags equal to its plain version's."""
    shape, dtypes, _, extra = MM_CASES[case]
    M, K, N = shape
    a, b = _mm_operands(cuda, shape, dtypes, extra)
    for det, _ in _mm_detectors(dtypes[0], extra):
        for blocks in (None, MM_SPLIT[shape]):
            blk, consts_a, consts_b, _ = rm._spec(a, b, True, blocks, None, det)
            buf, ptrs = rm._scratch(M, N, K, blk, cuda)
            rm._scan_kernel(a, b, blk, consts_a, consts_b, ptrs)
            want = rm.scan_plain(a, b, blocks=blocks, detector=det)
            got = torch.split(buf, rm._scratch_sizes(M, N, K, blk))[1:]
            for g, w in zip(got, want):
                assert torch.equal(g.view(w.shape), w)
            assert int(want[2].sum()) > 0 and int(want[3].sum()) > 0


# id: (B, H, Kh, S, T, D), blocks, causal, dtype, expected route, extra plants
FA_CASES = {
    "f32-causal": ((2, 4, 2, 128, 128, 64), (64, 32), True, F32, "ffma", None),
    "f32-S<T": ((1, 4, 2, 64, 192, 128), (32, 64), True, F32, "ffma", None),
    "f32-noncausal": ((1, 4, 1, 96, 64, 64), None, False, F32, "ffma", None),
    "bf16-causal": ((2, 4, 2, 128, 128, 64), (64, 32), True, BF16, "wgmma", None),
    "bf16-S<T": ((1, 4, 2, 64, 192, 128), (32, 64), True, BF16, "wgmma", None),
    "bf16-noncausal": ((1, 4, 1, 96, 64, 64), None, False, BF16, "wgmma", None),
    "f16-causal": ((2, 4, 2, 128, 128, 64), (64, 32), True, F16, "wgmma", None),
    "f16-S<T": ((1, 4, 2, 64, 192, 128), (32, 64), True, F16, "wgmma", None),
    "f16-noncausal": ((1, 4, 1, 96, 64, 64), None, False, F16, "wgmma", None),
    # three q tiles, the two-stage ring (D = 128) and the three-stage one
    # (D = 64) wrapped
    "bf16-causal-D128-long": ((1, 6, 2, 384, 384, 128), (128, 128), True, BF16,
                              "wgmma", None),
    "f16-causal-D64-long": ((1, 4, 2, 512, 512, 64), (64, 128), True, F16,
                            "wgmma", None),
    "f16-noncausal-D128-S<T": ((1, 4, 2, 128, 320, 128), (64, 64), False, F16,
                               "wgmma", None),
    # T = 192: the last K/V tile is ragged, and NaN fills the next KV
    # head's first rows, right past the end of this one
    "bf16-ragged-T": ((1, 4, 2, 192, 192, 128), (64, 64), True, BF16, "wgmma",
                      "next-head"),
    "f16-ragged-T-D64": ((1, 4, 2, 192, 192, 64), (64, 64), True, F16, "wgmma",
                         "next-head"),
    # S = 64 < T: keys 64..127 are loaded, masked for every row and past the
    # live prefix; a NaN in V there would still poison P . V
    "bf16-masked-key": ((1, 4, 2, 64, 384, 128), (32, 64), True, BF16, "wgmma",
                        "masked"),
    "bf16-all-fatal-tile": ((1, 4, 2, 256, 256, 128), (64, 64), True, BF16,
                            "wgmma", "tile"),
    "bf16-zero-pattern": ((1, 4, 2, 192, 192, 128), (64, 64), True, BF16,
                          "wgmma", "zeros"),
    "f16-zero-pattern-D64": ((1, 4, 2, 192, 192, 64), (64, 64), True, F16,
                             "wgmma", "zeros"),
    "bf16-clean": ((1, 4, 2, 256, 256, 128), None, True, BF16, "wgmma", "clean"),
    # contiguous views 2 and 8 bytes off 16-byte alignment: 16-bit operands
    # that only the FFMA kernel takes
    "bf16-unaligned": ((1, 4, 2, 64, 192, 128), (32, 64), True, BF16, "ffma",
                       "offset-2B"),
    "f16-unaligned-D64": ((1, 4, 2, 64, 192, 64), (32, 64), True, F16, "ffma",
                          "offset-8B"),
}
# elements into their storage at which the "offset" cases' q, k, v start
FA_OFFSETS = {"offset-2B": 1, "offset-8B": 4}


def _at_offset(x, off):
    """A contiguous copy of ``x`` that starts ``off`` elements into its
    storage."""
    buf = torch.empty(off + x.numel(), dtype=x.dtype, device=x.device)
    return buf[off:].view(x.shape).copy_(x)


def _fa_operands(dev, case, nm=False):
    """q, k, v of one FA_CASES entry: NaN, ±Inf, range and bit-pattern
    values planted in K and V (none for "clean"), the case's extra plants,
    at the case's offset into their storage.  With ``nm``, the
    neighbor_mean operands of a causal case (_nm_note): each (bk, D) tile's
    offset; in KV head 0 of batch 0, V lanes 0-3 of key 0 NaN (row 0 sees
    key 0 alone: its output there is V's fill) and K's key 1 NaN in every
    lane, with the head group's row 1 of q biased against the tile's sign
    (keys 0 and 1 score alike with the right fill; key 1 takes the row
    over with a wrong one)."""
    (B, H, Kh, S, T, D), blocks, _, dtype, _, extra = case
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((B, H, S, D), generator=gen, device=dev)
    k = torch.randn((B, Kh, T, D), generator=gen, device=dev)
    v = torch.randn((B, Kh, T, D), generator=gen, device=dev)
    if nm:
        bk = (blocks or ra._default_blocks(S, T))[1]
        for t in (k, v):
            t += _tile_offsets(B * Kh * T, D, (bk, D), dev).view(t.shape)
    if extra != "clean":
        _plant(k, 6)
        _plant(v, 7)
    nan = float("nan")
    if extra == "next-head":
        k[0, 1, :8] = nan
        v[0, 1, :8] = nan
    elif extra == "masked":
        k[0, 0, 100, 5] = nan
        v[0, 0, 100, 3] = nan
        k[0, 1, 5, 9] = float("inf")   # and one lane the live prefix counts
    elif extra == "tile":         # one whole K tile and one whole V tile
        k[0, 0, 128:256] = nan
        v[0, 1, :128] = float("-inf")
    elif extra == "zeros":        # the bit pattern of +0.0, which TMA pads with
        for r, c in ((0, 0), (127, D - 1), (128, 1), (T - 1, D - 1)):
            k[0, 0, r, c] = 0.0
            v[0, 1, r, c] = 0.0
    if nm:
        v[0, 0, 0, :4] = nan
        k[0, 0, 1, :] = nan
        q[0, :H // Kh, 1, :] -= 1.0 if NM_OFFSETS[0] > 0 else -1.0
    off = FA_OFFSETS.get(extra, 0)
    return tuple(_at_offset(t.to(dtype), off) for t in (q, k, v))


def _fa_detectors(dtype, extra):
    """As for the matmul; clean operands take the default detector only
    (random bf16 values round to the bit-pattern detector's 3.0)."""
    return [(None, {})] if extra == "clean" else _mm_detectors(dtype, extra)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FA_CASES))
def test_flash_attention_kernel_matches_plain(cuda, case):
    """Both routes against the plain version: causal S = T, S < T and
    non-causal, a ragged last K/V tile with NaN in the next head's rows, a
    fatal V lane in a loaded but masked key, whole fatal tiles, a detector
    that matches TMA's zero padding (fill 0.5), clean operands, and 16-bit
    views off 16-byte alignment (FFMA); under both detectors (one for the
    zero-pattern case).  Memory mode, on copies at the same offsets, leaves
    K and V clean: a second call counts nothing."""
    (B, H, Kh, S, T, D), blocks, causal, dtype, want_route, extra = FA_CASES[case]
    tol = TOL[dtype]
    q, k, v = _fa_operands(cuda, FA_CASES[case])
    assert ra.route(q, k, v) == want_route
    for det, pkw in _fa_detectors(dtype, extra):
        common.reset_launches()
        kw = dict(causal=causal, blocks=blocks, detector=det, **pkw)
        got = ra.flash_attention_raw(q, k, v, **kw)
        want = ra.flash_attention_plain(q, k, v, **kw)
        assert common.LAUNCHES == {"flash_attention": 1}
        assert torch.equal(got[1], want[1])
        assert (int(got[1][ra.EV_TOTAL]) > 0) == (extra != "clean")
        torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol, atol=tol)
        kk, vv = (_at_offset(t, t.storage_offset()) for t in (k, v))
        assert ra.route(q, kk, vv) == want_route
        ops.flash_attention(q, kk, vv, mode="memory", **kw)
        again = ops.flash_attention(q, kk, vv, mode="memory", **kw)
        assert again.counts.tolist() == [0] * 8
        assert torch.isfinite(again.out.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c, v in FA_CASES.items() if v[4] == "wgmma"])
def test_flash_attention_scan_matches_plain(cuda, case):
    """The wgmma route's scan kernel: per-logical-tile lane counts and
    per-physical-tile K/V flags equal to its plain version's."""
    (B, H, Kh, S, T, D), blocks, causal, dtype, _, extra = FA_CASES[case]
    q, k, v = _fa_operands(cuda, FA_CASES[case])
    for det, _ in _fa_detectors(dtype, extra):
        for blk in {blocks, None}:
            spec, consts_k, consts_v = ra._spec(q, k, v, True, blk, det)
            buf, ptrs = ra._scratch(B, Kh, T, spec[1], cuda)
            ra._scan_kernel(k, v, S, causal, spec, consts_k, consts_v, ptrs)
            want = ra.scan_plain(k, v, S=S, causal=causal, blocks=blk, detector=det)
            got = torch.split(buf, ra._scratch_sizes(B, Kh, T, spec[1]))[1:]
            for g, w in zip(got, want):
                assert torch.equal(g.view(w.shape), w)
            assert (int(want[1].sum()) > 0) == (extra != "clean")


# id: (B, C, H, Kh, Dh, pg, M), dtype, expected route, q offset in elements
PF_CASES = {
    "bf16-C64-D128": ((3, 64, 12, 2, 128, 16, 8), BF16, "wgmma", 0),
    "f16-C64-D128": ((3, 64, 12, 2, 128, 16, 8), F16, "wgmma", 0),
    "bf16-C20-D64": ((3, 20, 4, 2, 64, 16, 8), BF16, "wgmma", 0),
    "f16-C20-D64": ((3, 20, 12, 2, 64, 16, 8), F16, "wgmma", 0),
    "bf16-C100-D64": ((3, 100, 12, 2, 64, 16, 8), BF16, "wgmma", 0),
    "f16-C100-D128": ((3, 100, 12, 2, 128, 16, 8), F16, "wgmma", 0),
    # 256 keys: two 128-key tiles
    "bf16-C100-M16-D128": ((3, 100, 12, 2, 128, 16, 16), BF16, "wgmma", 0),
    "f16-C64-M16-D64": ((3, 64, 8, 1, 64, 16, 16), F16, "wgmma", 0),
    # 512 keys in four tiles: the 2-stage (Dh 128) and 3-stage (Dh 64)
    # rings wrap
    "bf16-pg32-M16-D128": ((2, 100, 12, 2, 128, 32, 16), BF16, "wgmma", 0),
    "f16-pg32-M16-D64": ((2, 64, 12, 2, 64, 32, 16), F16, "wgmma", 0),
    # two 48-key pages a tile (96 keys), one 128-key page a tile
    "bf16-pg48": ((3, 64, 12, 2, 128, 48, 5), BF16, "wgmma", 0),
    "f16-pg128-D64": ((2, 100, 12, 2, 64, 128, 2), F16, "wgmma", 0),
    "f32-C64": ((3, 64, 12, 2, 128, 16, 8), F32, "ffma", 0),
    # q 2 bytes off 16-byte alignment; pages of 8 keys
    "bf16-unaligned": ((3, 64, 12, 2, 128, 16, 8), BF16, "ffma", 1),
    "bf16-pg8": ((3, 20, 12, 2, 64, 8, 8), BF16, "ffma", 0),
}


def _pf_operands(dev, case, nm=False):
    """q, pools (P, 3, pg, Kh, Dh), block tables and q_start of one
    PF_CASES entry, read at layer 1.  Request b holds n_b real pages, then
    NULL slots; its chunk ends at its context's end (or starts at 0).  NaN,
    ±Inf, a range-guard value and a bit-pattern value are planted in live
    pages, NaN in K and V of the last real page of request 0 (dead for its
    early row blocks, live for its last one) and in the NULL page (live
    for the short requests' late rows, dead for their early ones).  With
    ``nm``, the neighbor_mean operands (_nm_pools, _nm_paged_lanes): the
    last request's chunk starts at 0, so its first rows see its first
    page alone."""
    (B, C, H, Kh, Dh, pg, M), dtype, _, off = case
    n_real = [M, M // 2 + 1, 3][:B]
    P = sum(n_real) + 2
    null = P - 1
    gen = torch.Generator(device=dev).manual_seed(11)
    perm = torch.randperm(P - 1, generator=gen, device=dev).tolist()
    rows, cursor = [], 0
    for n in n_real:
        rows.append(perm[cursor:cursor + n] + [null] * (M - n))
        cursor += n
    k = torch.randn((P, 3, pg, Kh, Dh), generator=gen, device=dev)
    v = torch.randn((P, 3, pg, Kh, Dh), generator=gen, device=dev)
    if nm:
        _nm_pools(k, v, rows[-1][0])
    nan, inf = float("nan"), float("inf")
    for t, (page, off_, kh, d), val in (
            (k, (rows[0][0], 3, 0, 10), nan), (v, (rows[0][0], 5, Kh - 1, 7), inf),
            (k, (rows[1][1], 1, 0, 2), 3.0e4), (v, (rows[0][1], 2, Kh - 1, 9), 3.0),
            (k, (rows[1][0], 0, Kh - 1, 4), -inf),
            (k, (rows[0][-1], 0, Kh - 1, 1), nan), (v, (rows[0][-1], 0, 0, 3), -inf),
            (k, (null, 0, 0, 0), nan), (v, (null, 0, Kh - 1, 5), nan)):
        t[page, 1, off_, kh, d] = val
    q = torch.randn((B, C, H, Dh), generator=gen, device=dev)
    bt = torch.tensor(rows, dtype=torch.int32, device=dev)
    starts = [max(0, n * pg - C) for n in n_real]
    if nm:
        _nm_paged_lanes(k, v, q, rows[-1][0], B - 1)
        starts[-1] = 0
    qs = torch.tensor(starts, dtype=torch.int32, device=dev)
    return _at_offset(q.to(dtype), off), k.to(dtype), v.to(dtype), bt, qs


def _pf_configs(dtype):
    """(kwargs) of the two detectors: the default one with the zero fill,
    and range guard + bit pattern with a constant V fill; then the two ways
    a V lane stays non-finite after the repair, which reach every row of
    its KV head in the reference (0 × NaN), the rows that mask it too: V
    detection off, and an infinite V fill."""
    det = _detectors(dtype)[1]
    return [dict(), dict(detector_k=det, detector_v=det, policy_k="zero",
                         policy_v="constant", constant_v=0.5),
            dict(detector_v=None),
            dict(policy_v="constant", constant_v=float("inf"))]


def _pf_poisoned(kw):
    """Whether a _pf_configs entry leaves V lanes non-finite."""
    return ("detector_v" in kw and kw["detector_v"] is None) or \
        kw.get("constant_v") == float("inf")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PF_CASES))
def test_paged_prefill_kernel_matches_plain(cuda, case):
    """Both prefill routes against the plain version: C 20, 64, 100; Dh 64
    and 128; one, two and four 128-key tiles (the rings wrapped); pages of
    16, 32, 48 and 128 keys; planted lanes in live pages, in a page dead
    for some row blocks and in the NULL slots' K and V; both detectors and
    a constant V fill; V lanes left non-finite (detection off, an infinite
    fill), whose NaN and Inf must land where the plain version's do.  Slot
    counts and AT counts equal, outputs within the file's tolerances, one
    launch a call, on the expected route."""
    _, dtype, want_route, _ = PF_CASES[case]
    q, k, v, bt, qs = _pf_operands(cuda, PF_CASES[case])
    assert pa.route(q, k, v) == want_route
    for kw in _pf_configs(dtype):
        common.reset_launches()
        got = pa.paged_prefill_raw(q, k, v, bt, qs, 1, **kw)
        want = pa.paged_prefill_plain(q, k, v, bt, qs, 1, **kw)
        assert common.LAUNCHES == {"paged_prefill": 1}
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        assert int(got[2][pa.EV_TOTAL]) > 0
        assert got[0].dtype == q.dtype and got[0].shape == q.shape
        # non-finite V lanes reach whole columns, the NULL page's too
        assert bool((~want[0].isfinite()).any()) == _pf_poisoned(kw)
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   rtol=TOL[dtype], atol=TOL[dtype],
                                   equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c, v in PF_CASES.items() if v[2] == "wgmma"])
def test_paged_prefill_scan_matches_plain(cuda, case):
    """The wgmma route's scan kernel: slot counts, AT counts and per-slot
    K/V flags equal to its plain version's, NULL and dead slots included;
    each request's poison end is one past its last slot whose V stays
    non-finite after the repair."""
    _, dtype, _, _ = PF_CASES[case]
    _, k, v, bt, _ = _pf_operands(cuda, PF_CASES[case])
    for kw in _pf_configs(dtype):
        poisoned = _pf_poisoned(kw)
        kw = {n: kw[n] for n in ("detector_k", "detector_v", "policy_v",
                                 "constant_v") if n in kw}
        *got, poison_end = pa._scan_kernel(k, v, bt, 1, **kw)
        want = pa.prefill_scan_plain(k, v, bt, 1, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert int(want[2].sum()) > 0
        poison = (want[2][..., 1] >> 1) & 1
        end = (poison * torch.arange(1, bt.shape[1] + 1, device=cuda)).amax(1)
        assert torch.equal(poison_end, end.int())
        assert bool(poison.any()) == poisoned


# id: (B, H, Kh, Dh, pg, M), dtype, expected route, q offset in elements
DC_CASES = {
    "bf16-main": ((4, 12, 2, 128, 16, 8), BF16, "fused", 0),
    "f16-main": ((4, 12, 2, 128, 16, 8), F16, "fused", 0),
    "f32-main": ((4, 12, 2, 128, 16, 8), F32, "fused", 0),
    # G = 8, pages of 32 keys, five slots (five one-slot blocks)
    "bf16-pg32-D64-G8": ((4, 8, 1, 64, 32, 5), BF16, "fused", 0),
    # two slots a block, eight blocks; B = 1
    "f16-M16-B1": ((1, 12, 2, 128, 16, 16), F16, "fused", 0),
    # G = 1, head dim 64, two slots a block
    "bf16-M16-D64-G1": ((4, 4, 4, 64, 16, 16), BF16, "fused", 0),
    "f32-pg32-D64": ((2, 12, 2, 64, 32, 8), F32, "fused", 0),
    # three slots a block, seven blocks, the last holding two
    "bf16-M20": ((2, 12, 2, 128, 16, 20), BF16, "fused", 0),
    # f32 pages of 32 keys at Dh 128: a block's four slots in two rounds
    # of two
    "f32-pg32-M32-rounds": ((2, 12, 2, 128, 32, 32), F32, "fused", 0),
    # 28 query heads on 16 head warps (a second pass over heads), G = 7
    "bf16-H28-G7": ((2, 28, 4, 128, 16, 8), BF16, "fused", 0),
    # pages of 48 keys: three 16-key score passes, two softmax lane passes
    "f16-pg48-D64": ((2, 8, 2, 64, 48, 6), F16, "fused", 0),
    # q 2 bytes off 16-byte alignment
    "bf16-unaligned": ((4, 12, 2, 128, 16, 8), BF16, "walk", 1),
}


def _dc_operands(dev, case, nm=False):
    """q (B, H, Dh), pools (P, 3, pg, Kh, Dh), block tables and positions of
    one DC_CASES entry, read at layer 1.  Request b holds n_b real pages,
    then NULL slots; request 0's position ends inside its second-to-last
    page, so its last real page lies past it.  NaN, ±Inf, a range-guard
    value and a bit-pattern value are planted in live pages, NaN and Inf in
    K and V of request 0's last page, and NaN in the NULL page's K and V.
    With ``nm``, the neighbor_mean operands (_nm_pools, _nm_paged_lanes):
    the last request's position ends in its first page."""
    (B, H, Kh, Dh, pg, M), dtype, _, off = case
    n_real = [M, M // 2 + 1, 3, 1][:B]
    P = sum(n_real) + 2
    null = P - 1
    gen = torch.Generator(device=dev).manual_seed(13)
    perm = torch.randperm(P - 1, generator=gen, device=dev).tolist()
    rows, cursor = [], 0
    for n in n_real:
        rows.append(perm[cursor:cursor + n] + [null] * (M - n))
        cursor += n
    k = torch.randn((P, 3, pg, Kh, Dh), generator=gen, device=dev)
    v = torch.randn((P, 3, pg, Kh, Dh), generator=gen, device=dev)
    if nm:
        _nm_pools(k, v, rows[-1][0])
    nan, inf = float("nan"), float("inf")
    for t, (page, off_, kh, d), val in (
            (k, (rows[0][0], 3, 0, 10), nan), (v, (rows[0][0], 5, Kh - 1, 7), inf),
            (k, (rows[-1][0], 1, 0, 2), 3.0e4), (v, (rows[0][1 % M], 2, Kh - 1, 9), 3.0),
            (k, (rows[-1][0], 0, Kh - 1, 4), -inf),
            (k, (rows[0][-1], 0, Kh - 1, 1), nan), (v, (rows[0][-1], 0, 0, 3), -inf),
            (k, (null, 0, 0, 0), nan), (v, (null, 0, Kh - 1, 5), nan)):
        t[page, 1, off_, kh, d] = val
    q = torch.randn((B, H, Dh), generator=gen, device=dev)
    bt = torch.tensor(rows, dtype=torch.int32, device=dev)
    pos = [n * pg - 2 for n in n_real]
    pos[0] = max(0, (n_real[0] - 1) * pg - 1)
    if nm:
        _nm_paged_lanes(k, v, q, rows[-1][0], B - 1)
        pos[-1] = pg - 2
    pos = torch.tensor(pos, dtype=torch.int32, device=dev)
    return _at_offset(q.to(dtype), off), k.to(dtype), v.to(dtype), bt, pos


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DC_CASES))
def test_paged_decode_kernel_matches_plain(cuda, case):
    """Both decode routes against the plain version at every ``splits``
    that divides M (1, 2, 4): pages of 16, 32 and 48 keys; Dh 64 and 128;
    G = 1, 6, 7, 8 (28 heads: more than one head a warp); B = 1, 2, 4; M =
    5, 6, 8, 16, 20, 32 (one, two and three slots a block, a short last
    block, slots in two rounds); planted lanes in live
    pages, in a page past the position and in the NULL slots; both
    detectors and a constant V fill; V lanes left non-finite (detection
    off, an infinite fill), whose NaN and Inf must land where the plain
    version's do.  Slot counts and AT counts equal, outputs within the
    file's tolerances (the fused route also against the plain twin of its
    own partition), one launch a call, on the expected route."""
    (_, _, _, _, _, M), dtype, want_route, _ = DC_CASES[case]
    q, k, v, bt, pos = _dc_operands(cuda, DC_CASES[case])
    assert pa.decode_route(q, k, v) == want_route
    tol = TOL[dtype]
    for kw in _pf_configs(dtype):
        for splits in [s for s in (1, 2, 4) if M % s == 0]:
            common.reset_launches()
            got = pa.paged_attention_splitk_raw(q, k, v, bt, pos, 1,
                                                splits=splits, **kw)
            assert common.LAUNCHES == {"paged_decode": 1}
            wants = [pa.paged_decode_plain(q, k, v, bt, pos, 1, splits=splits, **kw)]
            if want_route == "fused":
                wants.append(pa.paged_decode_fused_plain(q, k, v, bt, pos, 1, **kw))
            for want in wants:
                assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
                out, ref = got[0].float(), want[0].float()
                fin = ref.isfinite()
                assert bool((~fin).any()) == _pf_poisoned(kw)
                assert torch.equal(out.isfinite(), fin)
                torch.testing.assert_close(out[fin], ref[fin], rtol=tol, atol=tol)
                both_inf = out.isinf() & ref.isinf()
                assert torch.equal(out[both_inf], ref[both_inf])
            assert int(got[2][pa.EV_TOTAL]) > 0
            assert got[0].dtype == q.dtype and got[0].shape == q.shape


# scrub: (shape, first lane's offset in its storage, ids, n_valid, block,
# n_valid_rows, tile with one planted lane in each, random lanes); the
# first and last lanes are always planted
SC_CASES = {
    "width-7": ((40, 7), 0, None, None, None, 0, None, 12),
    "width-129": ((12, 129), 0, None, None, None, 5, None, 12),
    "offset": ((64, 32), 1, None, None, None, 0, None, 12),
    "offset-pages": ((9, 5, 25), 3, [8, 2, 6, 1], None, None, None, None, 20),
    "straddle": ((10, 3, 7), 0, [4, 1, 7, 2, 4, 4, 4, 4], 4, (2, 7), None, None, 20),
    "straddle-129": ((6, 3, 129), 0, [5, 0, 3, 0], 3, (6, 129), None, None, 20),
    "many-tiles": ((256, 96), 0, None, None, (2, 8), 0, (2, 8), 0),
    "many-tiles-bound": ((256, 96), 0, None, None, (2, 8), 77, (2, 8), 0),
    "mid-tile-bound": ((5, 8, 7), 0, None, None, (8, 7), 13, None, 12),
    "staged": ((700, 2, 7), 0, "600+pad", 600, None, None, None, 200),
    "staged-all": ((700, 2, 7), 0, "600", None, None, None, None, 200),
    "pool-pages": ((64, 28, 16, 2, 128), 0, [5, 17, 40, 5], 3, None, None, None, 40),
    "large": ((16384, 1024), 0, None, None, None, 0, None, 64),
}


def _sc_operand(dev, dtype, case, seed=0):
    """The case's buffer on the card, its first lane ``offset`` lanes into
    its storage, with NaN/±Inf lanes planted; and its page ids."""
    shape, offset, ids, _, _, _, every, n_rand = SC_CASES[case]
    rng = np.random.default_rng(seed + len(case))
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    faults = np.array([np.nan, np.inf, -np.inf], np.float32)
    if every is not None:
        br, bc = every
        tiles = (flat.shape[0] // br, flat.shape[1] // bc)
        rows = np.arange(0, flat.shape[0], br)[:, None] + rng.integers(br, size=tiles)
        cols = np.arange(0, flat.shape[1], bc)[None, :] + rng.integers(bc, size=tiles)
        flat[rows, cols] = faults[(rows + cols) % 3]
    lanes = np.concatenate([[0, x.size - 1],
                            rng.choice(np.arange(1, x.size - 1), n_rand, replace=False)])
    x.reshape(-1)[lanes] = faults[np.arange(lanes.size) % 3]
    buf = torch.empty(offset + x.size, dtype=dtype, device=dev)
    buf[offset:] = torch.from_numpy(x.reshape(-1)).to(dev).to(dtype)
    if isinstance(ids, str):
        perm = rng.permutation(shape[0])[:600].tolist()
        ids = perm + [perm[0]] * (1024 - 600) if ids.endswith("pad") else perm
    return buf[offset:].view(shape), ids


def _sc_call(fn, x, ids, case, **kw):
    _, _, _, n_valid, block, n_valid_rows, _, _ = SC_CASES[case]
    if ids is None:
        return fn(x, block=block, n_valid_rows=n_valid_rows, **kw)[1]
    return fn(x, ids, block=block, n_valid=n_valid, **kw)[1]


def _sc_fns(ids):
    if ids is None:
        return scrub.scrub, scrub.scrub_plain
    return scrub.scrub_pages, scrub.scrub_pages_plain


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16, F16])
@pytest.mark.parametrize("case", list(SC_CASES))
def test_scrub_kernel_matches_plain(cuda, case, dtype):
    """One launch; counts and repaired bits equal to the plain version's:
    row widths off the vector width, views off 16-byte alignment, logical
    tiles that straddle pages, more than 32 tiles with a fatal lane in each,
    count bounds mid-tile, more ids than ride in the launch's parameters
    (staged), the engine's pool, and a buffer of more chunks than blocks;
    then the repaired buffer counts 0."""
    x, ids = _sc_operand(cuda, dtype, case)
    plain = x.clone()
    kernel, plain_fn = _sc_fns(ids)
    if ids is not None:
        live = scrub.live_ids(np.asarray(ids), SC_CASES[case][3])
        staged = scrub.launch_plan(2, len(live), 8, 1, 132).ids == "staged"
        assert staged == case.startswith("staged")
    common.reset_launches()
    got = _sc_call(kernel, x, ids, case)
    assert common.LAUNCHES == {"scrub": 1}
    want = _sc_call(plain_fn, plain, ids, case)
    assert torch.equal(got, want) and int(want[2]) > 0
    assert torch.equal(detect.bits_of(x), detect.bits_of(plain))
    if SC_CASES[case][6] is not None and not SC_CASES[case][5]:
        assert int(got[2]) == x.numel() // 16      # every (2, 8) tile
    assert _sc_call(kernel, x, ids, case).tolist() == [0, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16, F16])
@pytest.mark.parametrize("kind", ["inf-off", "range+bitpattern", "constant"])
def test_scrub_kernel_detectors_match_plain(cuda, dtype, kind):
    """The detector variants (Inf off; the range guard with a bit pattern)
    and the constant fill, on a whole buffer off alignment and on pages."""
    det, pol = None, {}
    if kind == "inf-off":
        det = Detector(inf=False)
    elif kind == "range+bitpattern":
        det = _detectors(dtype)[1]
    else:
        pol = dict(policy="constant", constant=0.5)
    for case in ("offset", "straddle"):
        x, ids = _sc_operand(cuda, dtype, case)
        _plant(x, 3)
        plain = x.clone()
        kernel, plain_fn = _sc_fns(ids)
        got = _sc_call(kernel, x, ids, case, detector=det, **pol)
        want = _sc_call(plain_fn, plain, ids, case, detector=det, **pol)
        assert torch.equal(got, want) and int(want[0] + want[1]) > 0
        assert torch.equal(detect.bits_of(x), detect.bits_of(plain))


@pytest.mark.cuda
def test_scrub_kernel_back_to_back_on_one_workspace(cuda):
    """Calls of different sizes on one stream share one workspace, which
    each leaves zeroed: many tiles, then one, then many chunks, then many
    tiles again, then staged ids; the last repaired buffer counts 0.  A
    call on another stream gets a workspace of its own."""
    for case in ("many-tiles", "width-7", "large", "many-tiles", "staged"):
        x, ids = _sc_operand(cuda, BF16, case, seed=5)
        plain = x.clone()
        kernel, plain_fn = _sc_fns(ids)
        got = _sc_call(kernel, x, ids, case)
        want = _sc_call(plain_fn, plain, ids, case)
        assert torch.equal(got, want) and int(want[2]) > 0
    assert _sc_call(kernel, x, ids, case).tolist() == [0, 0, 0]
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        x, _ = _sc_operand(cuda, F32, "many-tiles", seed=6)
        plain = x.clone()
        got = scrub.scrub(x, block=(2, 8))[1]
        want = scrub.scrub_plain(plain, block=(2, 8))[1]
    stream.synchronize()
    assert torch.equal(got, want) and int(want[2]) == x.numel() // 16


def _mlstm_inputs(dev, dtype, nc, Q, P, B=2, H=2, off=0, nm=False):
    """q, k, v (B, H, nc, Q, P) with NaN and ±Inf planted, f32 gates; q, k
    and v start ``off`` elements into their storage.  With ``nm``, each
    (b, h, c) tile of q, k and v carries its own offset (_nm_note) times
    NM_MLSTM_SCALE (q's also over sqrt(P), as q is drawn)."""
    gen = torch.Generator(device=dev).manual_seed(7 + nc)
    shape = (B, H, nc, Q, P)

    def tiles(scale):
        if not nm:
            return 0.0
        return _tile_offsets(B * H * nc * Q, P, (Q, P), dev,
                             NM_MLSTM_SCALE * scale).view(shape)

    q = _plant(torch.randn(shape, generator=gen, device=dev) / P ** 0.5
               + tiles(P ** -0.5), 8)
    k = _plant(torch.randn(shape, generator=gen, device=dev) + tiles(1.0), 9)
    v = _plant(torch.randn(shape, generator=gen, device=dev) + tiles(1.0), 10)
    li = torch.randn((B, H, nc, Q), generator=gen, device=dev) * 0.5
    lf = torch.nn.functional.logsigmoid(
        torch.randn((B, H, nc, Q), generator=gen, device=dev) + 2.0)

    def placed(x):
        out = torch.empty(x.numel() + off, dtype=dtype, device=dev)[off:]
        return out.view(x.shape).copy_(x)

    return placed(q), placed(k), placed(v), li, lf


def _mlstm_check(got, wants, include_inf):
    for want in wants:
        assert torch.equal(got[1], want[1]) and int(got[1][mc.EV_TOTAL]) > 0
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4,
                                   equal_nan=True)
    assert int(got[1][mc.INF_Q] + got[1][mc.INF_KV]) == (6 if include_inf else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nc,Q,P,off,want_route", [
    (torch.float32, 1, 128, 64, 0, "ffma"),
    (torch.bfloat16, 1, 128, 64, 0, "wgmma"),
    (torch.float32, 5, 32, 96, 0, "ffma"),
    (torch.bfloat16, 5, 32, 96, 0, "wgmma"),
    (torch.float32, 3, 48, 100, 0, "ffma"),
    (torch.bfloat16, 3, 48, 100, 0, "ffma"),
    (torch.bfloat16, 2, 48, 96, 0, "wgmma"),    # Q = 48: M padded to 64
    (torch.bfloat16, 1, 128, 64, 1, "ffma"),    # the same data 2 bytes off
    (torch.bfloat16, 5, 32, 96, 1, "ffma"),
])
def test_mlstm_chunk_kernel_matches_plain(cuda, dtype, nc, Q, P, off, want_route):
    """One chunk of the longest length, five short ones, and three ragged
    ones (P = 100 not a multiple of the 32-column slab, Q = 48 not a
    multiple of the 32-row tile), under both detectors and fills, on the
    route the rule gives; the wgmma route also against the plain twin of
    its own arithmetic."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = _mlstm_inputs(cuda, dtype, nc, Q, P, off=off)
    assert mc.route(*x[:3]) == want_route
    for include_inf in (True, False):
        for policy, constant in (("zero", 0.0), ("constant", 0.5)):
            kw = dict(policy=policy, constant=constant, include_inf=include_inf)
            common.reset_launches()
            got = mc.mlstm_chunk_raw(*x, **kw)
            assert common.LAUNCHES == {"mlstm_chunk": 1}
            wants = [mc.mlstm_chunk_plain(*x, **kw)]
            if want_route == "wgmma":
                wants.append(mc.mlstm_chunk_split_plain(*x, **kw))
            _mlstm_check(got, wants, include_inf)


@pytest.mark.cuda
def test_mlstm_chunk_wgmma_at_xlstm_width(cuda):
    """xlstm-1.3b's head (P = 1024, Q = 128) over three chunks, bf16, on
    the wgmma route: held against the plain version and the split twin."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = _mlstm_inputs(cuda, torch.bfloat16, 3, 128, 1024, B=1, H=2)
    assert mc.route(*x[:3]) == "wgmma"
    for include_inf in (True, False):
        kw = dict(include_inf=include_inf)
        got = mc.mlstm_chunk_raw(*x, **kw)
        _mlstm_check(got, [mc.mlstm_chunk_plain(*x, **kw),
                           mc.mlstm_chunk_split_plain(*x, **kw)], include_inf)


@pytest.mark.cuda
def test_mlstm_chunk_wgmma_under_strong_forget_gates(cuda):
    """Forget gates of log f ≈ −0.69 a step (the random-weight xLSTM-1.3b's
    are ≈ −0.70) take a chunk's first rows into f32's subnormal range,
    below any bf16 term: the wgmma route scales each row by a power of two
    before its splits, and must agree with the plain version there."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, _, _ = _mlstm_inputs(cuda, torch.bfloat16, 3, 128, 128, B=1, H=2)
    gen = torch.Generator(device=cuda).manual_seed(23)
    li = torch.randn((1, 2, 3, 128), generator=gen, device=cuda) * 0.01
    lf = torch.randn((1, 2, 3, 128), generator=gen, device=cuda) * 0.01 - 0.69
    assert mc.route(q, k, v) == "wgmma"
    for include_inf in (True, False):
        kw = dict(include_inf=include_inf)
        got = mc.mlstm_chunk_raw(q, k, v, li, lf, **kw)
        _mlstm_check(got, [mc.mlstm_chunk_plain(q, k, v, li, lf, **kw),
                           mc.mlstm_chunk_split_plain(q, k, v, li, lf, **kw)],
                     include_inf)


@pytest.mark.cuda
def test_xlstm_on_the_card_matches_the_cpu(cuda):
    """The reduced f32 xLSTM: kernels on the card, plain versions on the
    CPU, the same weights — forward logits within 1e-4, one kernel launch
    per mLSTM block, and identical tokens and stats from ``generate`` with
    the scrub kernel on the cache."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("xlstm-1.3b").reduced(),
                              repair=ApproxConfig(mode="memory", policy="zero"))
    gpu = XLSTMLM(cfg, device=cuda, seed=0)
    cpu = XLSTMLM(cfg, device="cpu", seed=1)
    cpu.load_state_dict({n: p.cpu() for n, p in gpu.state_dict().items()})
    tokens = torch.randint(0, cfg.vocab, (2, 48), generator=torch.Generator().manual_seed(0))
    common.reset_launches()
    lg, cg = gpu(tokens.to(cuda), with_counts=True)
    assert common.LAUNCHES == {"mlstm_chunk": 3}
    lc, cc = cpu(tokens, with_counts=True)
    assert cg.tolist() == cc.tolist() == [0] * 8
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    outs = []
    for model in (gpu, cpu):
        space = serve.serve_space(model, 4, memoize=False)
        tok, stats = serve.generate(model, tokens[:, :8], max_new=6, max_seq=16,
                                    space=space)
        outs.append((tok.cpu().tolist(), stats, space.rule_stats()))
    assert outs[0] == outs[1]


# ------------------------------------------------------------ neighbor_mean
# A fatal lane takes the f32 mean of its logical tile's non-fatal lanes,
# rounded to the dtype: from ``tile_fill``'s table on the card, from
# ``common.tile_means`` in the plain versions.  The two sum in different
# orders, so a repaired lane may differ in the last place: repaired lanes
# within FILL_TOL, every other lane bit-equal, counts equal.
FILL_TOL = {F32: dict(rtol=1e-6, atol=1e-6), BF16: dict(rtol=1e-2, atol=1e-6),
            F16: dict(rtol=1e-2, atol=1e-6)}
NM = dict(policy="neighbor_mean")

# _nm_note: the products' neighbor_mean operands.  Every logical tile
# carries its own offset, NM_OFFSETS[t % 6] for tile t (row-major over the
# tile grid): neighbouring tiles' offsets differ by 5 or more and in sign,
# none lies within 2 of 0.  A few fatal lanes sit where their fill reaches
# an output lane almost unmixed (a causal row that sees one key or one
# page, a spike in the other operand of a product).  So the controls (the
# same call with the zero fill, and with one operand's table rolled by one
# tile, as a kernel that reads its neighbour's entry) must fail the test's
# own comparison: _tol_ratio above 1.
NM_OFFSETS = (3.0, -2.0, 4.0, -3.0, 2.0, -4.0)
# the partner of a fatal product lane: finite, and below 512, where the
# range detector's bound (on the exponent) starts
NM_SPIKE = 256.0
# the mLSTM's tile offsets, scaled so q.k and the state stay in the range
# the 1e-4 tolerance was set for
NM_MLSTM_SCALE = 0.25


def _tile_offsets(rows, cols, block, dev, scale=1.0, first=0):
    """(rows, cols) f32: NM_OFFSETS[(t - first) % 6] * scale on every lane
    of logical tile t of a (rows, cols) view with tiles ``block``."""
    br, bc = block
    gr, gc = rows // br, cols // bc
    t = (torch.arange(gr * gc, device=dev) - first) % len(NM_OFFSETS)
    off = torch.tensor(NM_OFFSETS, device=dev)[t].view(gr, gc) * scale
    return off.repeat_interleave(br, 0).repeat_interleave(bc, 1)


def _nm_pools(k, v, page):
    """Each page of layer 1 carries its own offset (a page is one logical
    tile of the paged kernels), ``page``'s NM_OFFSETS[0] > 0: its fill
    stays positive under both detectors, also with the default detector's
    3e4 lane in its mean."""
    P_, _, pg, Kh, Dh = k.shape
    cols = pg * Kh * Dh
    for t in (k, v):
        t[:, 1] += _tile_offsets(P_, cols, (1, cols), t.device,
                                 first=page).view(P_, pg, Kh, Dh)


def _nm_paged_lanes(k, v, q, page, b):
    """Lanes a wrong fill must move, in ``page`` (offset by _nm_pools), the
    first page of request ``b``, whose early rows see that page alone: V
    lane 3 of KV head 0 NaN in every slot (the output lane there is V's
    fill, whatever the weights), K of slot 1 of the last KV head NaN in
    every lane, and q of that head group biased against the page's sign
    (the page's keys score alike with the right fill; slot 1 takes the row
    over with a zero or negative one).  q is (B, H, Dh) or (B, C, H, Dh)."""
    Kh, H = k.shape[3], q.shape[-2]
    v[page, 1, :, 0, 3] = float("nan")
    k[page, 1, 1, Kh - 1, :] = float("nan")
    q[b][..., (Kh - 1) * (H // Kh):, :] -= 1.0


def _tol_ratio(got, want, tol):
    """assert_close(got, want, rtol=tol, atol=tol) as a number: the largest
    |got - want| / (tol + tol |want|) over want's finite lanes, inf where
    the two differ in finiteness; above 1 fails."""
    got, want = got.float(), want.float()
    fin = want.isfinite()
    if not torch.equal(got.isfinite(), fin):
        return float("inf")
    r = (got[fin] - want[fin]).abs() / (tol + tol * want[fin].abs())
    return float(r.max()) if r.numel() else 0.0


@contextlib.contextmanager
def _rolled_table(target):
    """Inside, the fill table a wrapper builds for ``target`` (the tensor at
    its data pointer) is rolled by one tile: tile t reads tile t+1's
    entry.  Yields the rolled tables' sizes."""
    build = tile_fill.table_or_none
    rolled = []

    def patched(policy, x, *args, **kw):
        table = build(policy, x, *args, **kw)
        if table is not None and x.data_ptr() == target.data_ptr():
            rolled.append(table.numel())
            return torch.roll(table, -1)
        return table

    tile_fill.table_or_none = patched
    try:
        yield rolled
    finally:
        tile_fill.table_or_none = build


def _controls_fail(call, operands, zero_kw, want, tol):
    """The zero fill, and each operand's table rolled (where it has more
    than one tile), must each fail ``call``'s comparison with ``want``."""
    assert _tol_ratio(call(**zero_kw)[0], want, tol) > 1.0
    for x in operands:
        with _rolled_table(x) as rolled:
            out = call()[0]
        assert rolled
        if rolled[0] > 1:
            assert _tol_ratio(out, want, tol) > 1.0


def _zero_kw(kw):
    """The zero fill in place of a paged call's neighbor_mean."""
    return dict(policy_k="zero") if "policy_k" in kw else dict(policy="zero")


def _fatal_mask(x, det):
    consts = common.detector_operand(common.resolve_detector(det, True), x.dtype)
    nan_m, inf_m = common.fatal_masks(x, consts)
    return nan_m | inf_m


def _repaired_close(got, want, fatal, dtype):
    assert torch.equal(detect.bits_of(got)[~fatal], detect.bits_of(want)[~fatal])
    torch.testing.assert_close(got[fatal].float(), want[fatal].float(),
                               **FILL_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16, F16])
def test_tile_fill_matches_plain(cuda, dtype):
    """The table of every view form: 2-D tiles narrower and wider than a
    block's 256 threads, tiles of odd sizes, a row stride and offset (a
    paged pool's layer, one tile a page) and a page map (scrub_pages'
    gathered view); one tile fatal in every lane takes 0."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = _plant(torch.randn((96, 640), generator=gen, device=cuda) + 0.5, 5)
    x[0:3, 0:5] = float("nan")
    x = x.to(dtype)
    det = _detectors(dtype)[1]
    for d in (None, det):
        consts = common.detector_operand(common.resolve_detector(d, True), dtype)
        for rows, cols, block, where in (
                (96, 640, (3, 5), {}), (96, 640, (32, 640), {}),
                (96, 640, (96, 5), {}), (1, 96 * 640, (1, 96 * 640), {}),
                (11, 3 * 640, (1, 3 * 640), dict(row_stride=8 * 640, offset=2 * 640)),
                (12, 640, (4, 64), dict(ids=[7, 2, 5, 0], rows_per_page=3,
                                        page_stride=12 * 640 // 4 * 2))):
            common.reset_launches()
            got = tile_fill.tile_fill(x, rows, cols, block, consts, **where)
            assert common.LAUNCHES == {"tile_fill": 1}
            want = tile_fill.tile_fill_plain(x, rows, cols, block, consts, **where)
            torch.testing.assert_close(tile_fill.values(got, dtype),
                                       tile_fill.values(want, dtype),
                                       **FILL_TOL[dtype])
        assert float(tile_fill.values(
            tile_fill.tile_fill(x, 96, 640, (3, 5), consts), dtype)[0]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF16, F16])
@pytest.mark.parametrize("case", ["width-7", "offset", "offset-pages",
                                  "many-tiles-bound", "mid-tile-bound",
                                  "staged-all", "large"])
def test_scrub_kernel_neighbor_mean_matches_plain(cuda, case, dtype):
    """``scrub`` and ``scrub_pages`` (unique ids) under both detectors: one
    tile_fill and one scrub launch; counts equal, the repaired lanes
    within FILL_TOL of the plain version's, the rest bit-equal."""
    for det in _detectors(dtype):
        x, ids = _sc_operand(cuda, dtype, case)
        fn, plain_fn = _sc_fns(ids)
        plain = x.clone()
        fatal = _fatal_mask(x, det)
        if ids is not None:     # scrub_pages repairs the listed pages only
            listed = torch.zeros(x.shape[0], dtype=torch.bool, device=cuda)
            listed[ids] = True
            fatal &= listed.view((-1,) + (1,) * (x.dim() - 1))
        common.reset_launches()
        got = _sc_call(fn, x, ids, case, detector=det, **NM)
        assert common.LAUNCHES == {"scrub": 1, "tile_fill": 1}
        want = _sc_call(plain_fn, plain, ids, case, detector=det, **NM)
        assert torch.equal(got, want) and int(want[0]) > 0
        _repaired_close(x, plain, fatal, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f32", "bf16", "bf16xf32", "f16",
                                  "bf16-unaligned", "all-fatal-tile"])
@pytest.mark.parametrize("split", [False, True])
def test_repair_matmul_neighbor_mean_matches_plain(cuda, case, split):
    """Both routes with the fill table of each operand: the split blocks'
    bk and bn (88, 130, 86, 82, 108, 64) are not multiples of a 16-byte
    chunk's 8 lanes, so the wgmma route's chunks span logical tiles; a
    whole fatal A and B tile.  Two tile_fill launches and one product a
    call; memory mode's origin scrub against the plain scrub."""
    shape, dtypes, want_route, extra = MM_CASES[case]
    da, db, out = dtypes
    tol = TOL[out or da]
    blocks = MM_SPLIT[shape] if split else None
    a, b = _mm_operands(cuda, shape, dtypes, extra,
                        nm_blocks=blocks or rm._default_blocks(
                            shape[0], shape[2], shape[1]))
    assert rm.route(a, b) == want_route
    for det in _detectors(da):
        common.reset_launches()
        kw = dict(blocks=blocks, out_dtype=out, detector=det, **NM)
        got = rm.repair_matmul_raw(a, b, **kw)
        assert common.LAUNCHES == {"repair_matmul": 1, "tile_fill": 2}
        want = rm.repair_matmul_plain(a, b, **kw)
        assert torch.equal(got[1], want[1]) and int(got[1][rm.EV_TOTAL]) > 0
        torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol, atol=tol)
        _controls_fail(lambda **o: rm.repair_matmul_raw(a, b, **{**kw, **o}),
                       (a, b), dict(policy="zero"), want[0], tol)
        ka, kb, pa_, pb = a.clone(), b.clone(), a.clone(), b.clone()
        fa, fb = _fatal_mask(a, det), _fatal_mask(b, det)
        ops.repair_matmul(ka, kb, mode="memory", **kw)
        scrub.scrub_plain(pa_, detector=det, **NM)
        scrub.scrub_plain(pb, detector=det, **NM)
        _repaired_close(ka, pa_, fa, da)
        _repaired_close(kb, pb, fb, db)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f32-causal", "f32-S<T", "bf16-causal",
                                  "f16-causal-D64-long", "bf16-ragged-T",
                                  "bf16-all-fatal-tile", "bf16-unaligned"])
def test_flash_attention_neighbor_mean_matches_plain(cuda, case):
    """Both routes with the K and V tables ((bk, D) tiles of the
    (B*Kh*T, D) view, which the wgmma route's 128-row tiles do not share):
    two tile_fill launches and one attention a call."""
    (B, H, Kh, S, T, D), blocks, causal, dtype, want_route, extra = FA_CASES[case]
    tol = TOL[dtype]
    q, k, v = _fa_operands(cuda, FA_CASES[case], nm=True)
    assert ra.route(q, k, v) == want_route
    for det in _detectors(dtype):
        common.reset_launches()
        kw = dict(causal=causal, blocks=blocks, detector=det, **NM)
        got = ra.flash_attention_raw(q, k, v, **kw)
        assert common.LAUNCHES == {"flash_attention": 1, "tile_fill": 2}
        want = ra.flash_attention_plain(q, k, v, **kw)
        assert torch.equal(got[1], want[1]) and int(got[1][ra.EV_TOTAL]) > 0
        torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol, atol=tol)
        _controls_fail(lambda **o: ra.flash_attention_raw(q, k, v, **{**kw, **o}),
                       (k, v), dict(policy="zero"), want[0], tol)


def _nm_paged_configs(dtype):
    """Both operands' mean, and K's mean beside V's zero fill, under both
    detectors."""
    det = _detectors(dtype)[1]
    return [dict(NM), dict(policy_k="neighbor_mean", policy_v="zero"),
            dict(detector_k=det, detector_v=det, **NM)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16-main", "f32-main", "bf16-M20",
                                  "f16-pg48-D64", "bf16-unaligned"])
def test_paged_decode_neighbor_mean_matches_plain(cuda, case):
    """Both decode routes with the per-page tables (a page is one logical
    tile over both KV heads; the fused route's groups of slots take each
    page's own): one tile_fill per operand with the mean, one decode."""
    (_, _, _, _, _, M), dtype, want_route, _ = DC_CASES[case]
    q, k, v, bt, pos = _dc_operands(cuda, DC_CASES[case], nm=True)
    assert pa.decode_route(q, k, v) == want_route
    tol = TOL[dtype]
    for kw in _nm_paged_configs(dtype):
        n_tables = 1 if kw.get("policy_v") == "zero" else 2
        for splits in [s for s in (1, 4) if M % s == 0]:
            common.reset_launches()
            got = pa.paged_attention_splitk_raw(q, k, v, bt, pos, 1,
                                                splits=splits, **kw)
            assert common.LAUNCHES == {"paged_decode": 1, "tile_fill": n_tables}
            wants = [pa.paged_decode_plain(q, k, v, bt, pos, 1, splits=splits, **kw)]
            if want_route == "fused":
                wants.append(pa.paged_decode_fused_plain(q, k, v, bt, pos, 1, **kw))
            for want in wants:
                assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
                torch.testing.assert_close(got[0].float(), want[0].float(),
                                           rtol=tol, atol=tol)
            assert int(got[2][pa.EV_TOTAL]) > 0
            _controls_fail(
                lambda **o: pa.paged_attention_splitk_raw(
                    q, k, v, bt, pos, 1, splits=splits, **{**kw, **o}),
                (k, v)[:n_tables], _zero_kw(kw), wants[0][0], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16-C64-D128", "f16-C20-D64",
                                  "bf16-C100-M16-D128", "f16-pg32-M16-D64",
                                  "bf16-pg48", "f32-C64", "bf16-pg8"])
def test_paged_prefill_neighbor_mean_matches_plain(cuda, case):
    """Both prefill routes with the per-page tables, and the wgmma route's
    scan: its V poison test is per page with a table.  The last config
    puts two lanes near bf16's largest value in a V page beside a fatal
    lane, so the page's f32 sum overflows and its fill is Inf, as in the
    reference: that page poisons its KV head's rows on every route."""
    _, dtype, want_route, _ = PF_CASES[case]
    q, k, v, bt, qs = _pf_operands(cuda, PF_CASES[case], nm=True)
    assert pa.route(q, k, v) == want_route
    configs = _nm_paged_configs(dtype)
    if dtype == BF16:
        vh = v.clone()
        vh[bt[0, 0], 1, 0, 0, :2] = 3.0e38        # page of v's planted Inf
        configs.append(dict(NM, v_pages=vh))
    for kw in configs:
        vv = kw.pop("v_pages", v)
        common.reset_launches()
        got = pa.paged_prefill_raw(q, k, vv, bt, qs, 1, **kw)
        n_tables = 1 if kw.get("policy_v") == "zero" else 2
        assert common.LAUNCHES == {"paged_prefill": 1, "tile_fill": n_tables}
        want = pa.paged_prefill_plain(q, k, vv, bt, qs, 1, **kw)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        assert bool((~want[0].isfinite()).any()) == (vv is not v)
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   rtol=TOL[dtype], atol=TOL[dtype],
                                   equal_nan=True)
        _controls_fail(lambda **o: pa.paged_prefill_raw(q, k, vv, bt, qs, 1,
                                                        **{**kw, **o}),
                       (k, vv)[:n_tables], _zero_kw(kw), want[0], TOL[dtype])
        if want_route == "wgmma":
            skw = {n: kw[n] for n in ("detector_k", "detector_v") if n in kw}
            skw["policy_v"] = kw.get("policy_v", "neighbor_mean")
            *sgot, _ = pa._scan_kernel(k, vv, bt, 1, **skw)
            for g, w in zip(sgot, pa.prefill_scan_plain(k, vv, bt, 1, **skw)):
                assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,nc,Q,P,off,want_route", [
    (torch.float32, 5, 32, 96, 0, "ffma"),
    (torch.bfloat16, 5, 32, 96, 0, "wgmma"),
    (torch.bfloat16, 3, 48, 100, 0, "ffma"),
    (torch.bfloat16, 2, 48, 96, 0, "wgmma"),
    (torch.bfloat16, 5, 32, 96, 1, "ffma"),
])
def test_mlstm_chunk_neighbor_mean_matches_plain(cuda, dtype, nc, Q, P, off,
                                                 want_route):
    """Both mLSTM routes with a table per operand ((b, h, c) tiles); one v
    tile fatal in every lane; the wgmma route's repaired v lanes carry the
    tile's mean into the hi/lo split (against the split twin too)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = list(_mlstm_inputs(cuda, dtype, nc, Q, P, off=off, nm=True))
    x[2][1, 0, nc - 1] = float("nan")
    assert mc.route(*x[:3]) == want_route
    for include_inf in (True, False):
        kw = dict(include_inf=include_inf, **NM)
        common.reset_launches()
        got = mc.mlstm_chunk_raw(*x, **kw)
        assert common.LAUNCHES == {"mlstm_chunk": 1, "tile_fill": 3}
        wants = [mc.mlstm_chunk_plain(*x, **kw)]
        if want_route == "wgmma":
            wants.append(mc.mlstm_chunk_split_plain(*x, **kw))
        for want in wants:
            assert torch.equal(got[1], want[1]) and int(got[1][mc.EV_TOTAL]) > 0
            torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4,
                                       equal_nan=True)
        if include_inf:     # else the planted Inf lanes spread to most of y
            _controls_fail(lambda **o: mc.mlstm_chunk_raw(*x, **{**kw, **o}),
                           x[:3], dict(policy="zero"), wants[0][0], 1e-4)
