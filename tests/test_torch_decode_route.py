"""The route rule of the paged decode, the fused and heads routes'
partitions and their plain twins, on the CPU.

``decode_route`` is a pure function of the operands' dtypes, shapes and
data pointers, so it is held here on CPU tensors.  The fused route groups
each request's M slots its own way (``fused_partition``: ceil(M / 8)
consecutive slots a block, one cluster a request), so its plain twin
``paged_decode_fused_plain`` is held against the reference's Pallas kernels
(``src/repro/kernels/paged_attention.py::paged_attention_raw`` and
``paged_attention_splitk_raw``) in interpret mode, as
``tests/test_torch_kernels.py`` runs them: slot counts and AT counts
equal, outputs within the float tolerances (f32 1e-4: the partitions sum
in different orders; bf16 2e-2: p is rounded to bf16 against another
running max where the partitions differ), non-finite lanes where the
reference's are.  The kernel itself is held against these plain versions
on the card (``tests/test_torch_cuda.py``).
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import rules as jrules  # noqa: E402
from repro.kernels import paged_attention as jpa  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import detect, rules  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}
TOL = {F32: 1e-4, BF16: 2e-2}


def _view(shape, dtype, off=0):
    """A contiguous tensor of ``shape`` starting ``off`` elements into its
    storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + off, dtype=dtype)[off:].view(shape)


Q = (4, 12, 128)
POOL = (5, 3, 16, 2, 128)


@pytest.mark.parametrize("q_shape,pool_shape,dtypes,offs,want", [
    (Q, POOL, (BF16,) * 3, (0, 0, 0), "fused"),
    (Q, POOL, (F16,) * 3, (0, 0, 0), "fused"),
    (Q, POOL, (F32,) * 3, (0, 0, 0), "fused"),
    ((1, 8, 64), (5, 3, 32, 1, 64), (BF16,) * 3, (0, 0, 0), "fused"),   # G = 8
    ((2, 4, 64), (5, 3, 16, 4, 64), (F16,) * 3, (0, 0, 0), "fused"),    # G = 1
    ((4, 12, 128), (5, 3, 4, 2, 128), (BF16,) * 3, (0, 0, 0), "fused"),  # pg 4
    ((4, 12, 128), (5, 3, 64, 2, 128), (F32,) * 3, (0, 0, 0), "fused"),  # pg 64
    (Q, POOL, (BF16, F16, F16), (0, 0, 0), "walk"),
    (Q, POOL, (BF16, BF16, F16), (0, 0, 0), "walk"),
    ((3, 4, 16), (9, 2, 4, 2, 16), (F32,) * 3, (0, 0, 0), "walk"),      # tests' pool
    ((4, 12, 96), (5, 3, 16, 2, 96), (BF16,) * 3, (0, 0, 0), "walk"),   # Dh 96
    ((4, 12, 256), (5, 3, 16, 2, 256), (BF16,) * 3, (0, 0, 0), "walk"),  # Dh 256
    ((4, 12, 128), (5, 3, 16, 2, 64), (BF16,) * 3, (0, 0, 0), "walk"),  # Dh differ
    (Q, (5, 3, 112, 2, 128), (F32,) * 3, (0, 0, 0), "heads"),  # 112 KiB a K tile
    (Q, (5, 3, 128, 4, 128), (BF16,) * 3, (0, 0, 0), "heads"),  # 2 x 128 KiB a slot
    (Q, (5, 3, 256, 2, 128), (F32,) * 3, (0, 0, 0), "walk"),   # 128 KiB a KV head
    ((4, 48, 128), (5, 3, 64, 4, 128), (F32,) * 3, (0, 0, 0), "heads"),  # G 12
    ((4, 12, 128), (5, 3, 112, 2, 128), (F32,) * 3, (1, 0, 0), "walk"),  # q off
    ((4, 48, 128), (5, 3, 64, 4, 128), (F32, F32, BF16), (0, 0, 0), "walk"),
    (Q, POOL, (BF16,) * 3, (1, 0, 0), "walk"),     # q 2 bytes off
    (Q, POOL, (F32,) * 3, (1, 0, 0), "walk"),      # q 4 bytes off
    (Q, POOL, (F16,) * 3, (0, 4, 0), "walk"),      # k 8 bytes off
    (Q, POOL, (BF16,) * 3, (0, 0, 4), "walk"),     # v 8 bytes off
    (Q, POOL, (BF16,) * 3, (8, 8, 8), "fused"),    # 16 bytes off
    (Q, POOL, (F32,) * 3, (4, 8, 12), "fused"),    # 16, 32, 48 bytes off
    ((0, 12, 128), POOL, (BF16,) * 3, (0, 0, 0), "walk"),   # B = 0
    (Q, (0, 3, 16, 2, 128), (BF16,) * 3, (0, 0, 0), "walk"),  # P = 0
    (Q, (5, 3, 100, 2, 128), (F32,) * 3, (0, 0, 0), "fused"),  # 100 KiB a K tile
    ((4, 48, 128), (5, 3, 16, 4, 128), (BF16,) * 3, (0, 0, 0), "fused"),  # StarCoder2
    ((4, 48, 128), (5, 3, 16, 4, 128), (F32,) * 3, (0, 0, 0), "fused"),
    ((4, 32, 64), (5, 3, 16, 32, 64), (BF16,) * 3, (0, 0, 0), "fused"),  # StableLM
    ((4, 32, 64), (5, 3, 16, 32, 64), (F32,) * 3, (0, 0, 0), "heads"),  # 256 KiB a slot
])
def test_decode_route_rule(q_shape, pool_shape, dtypes, offs, want):
    q, k, v = (_view(s, d, o) for s, d, o in
               zip((q_shape, pool_shape, pool_shape), dtypes, offs))
    assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
    assert pa.decode_route(q, k, v) == want


def test_decode_route_needs_contiguous_operands_and_matching_pools():
    k = _view(POOL, BF16)
    q = _view((12, 4, 128), BF16).transpose(0, 1)
    assert pa.decode_route(q, k, k) == "walk"
    assert pa.decode_route(q.contiguous(), k, k) == "fused"
    kt = _view((5, 3, 2, 16, 128), BF16).transpose(2, 3)
    assert pa.decode_route(q.contiguous(), kt, kt) == "walk"
    assert pa.decode_route(q.contiguous(), k, _view((5, 3, 32, 2, 128), BF16)) == "walk"


@pytest.mark.parametrize("H,Dh,pg,Kh,itemsize", [
    (12, 128, 16, 2, 2), (12, 128, 16, 2, 4), (8, 64, 32, 1, 2),
    (12, 128, 80, 2, 4), (12, 128, 96, 2, 4),
    (48, 128, 16, 4, 2), (48, 128, 16, 4, 4),    # StarCoder2-15B
    (32, 64, 16, 32, 2), (32, 64, 16, 32, 4),    # StableLM-1.6B
    (48, 128, 64, 4, 4), (12, 128, 256, 2, 4),
])
def test_fused_shared_memory_limit(H, Dh, pg, Kh, itemsize):
    """The fused route takes a pool iff one slot's staging fits a block's
    shared memory; the bytes are the kernel's layout, which holds the
    block's own partial and its inbox for the merge (its share of every
    block's acc, and each block's m and l), not the cluster's eight
    partials.  Where it does not fit, the heads route takes the pool iff
    one KV head's share of a slot does: the same layout for the G query
    heads of one KV head over that head's rows."""
    one = pa.fused_smem(H, Dh, pg, Kh, itemsize)
    tile = pg * Kh * Dh * itemsize
    partial = 4 * H * (Dh + 2)          # acc, m and l of one block
    inbox = 4 * H * Dh + 16 * 8 + 8 * 8 * H
    assert one == (16 + H * Dh * itemsize + 2 * tile + partial + inbox
                   + 4 * H * pg + 16)
    G = H // Kh
    heads = pa.heads_smem(H, Dh, pg, Kh, itemsize)
    assert heads == (16 + G * Dh * itemsize + 2 * pg * Dh * itemsize
                     + 4 * G * (Dh + 2) + 4 * G * Dh + 16 * 8 + 8 * 8 * G
                     + 4 * G * pg + 16)
    dtype = {2: BF16, 4: F32}[itemsize]
    q, k = _view((2, H, Dh), dtype), _view((3, 2, pg, Kh, Dh), dtype)
    want = ("fused" if one <= 232448 else "heads" if heads <= 232448
            else "walk")
    assert pa.decode_route(q, k, k) == want
    fused = {(12, 128, 16, 2, 2): 33536,      # the engine's pool, bf16
             (48, 128, 16, 4, 2): 100896, (48, 128, 16, 4, 4): 145952,
             (32, 64, 16, 32, 2): 156064}
    if (H, Dh, pg, Kh, itemsize) in fused:
        assert one == fused[H, Dh, pg, Kh, itemsize]
        assert want == "fused"
    if (Kh, itemsize) == (32, 4):            # StableLM f32: 256 KiB of tiles
        assert (one, heads, want) == (291232, 9256, "heads")
    if (pg, itemsize) == (256, 4):           # 256 KiB of one KV head's rows
        assert want == "walk"


@pytest.mark.parametrize("dtype,H,Dh,Kh,need", [
    (F32, 32, 64, 32, {}),                                  # StableLM: heads, ffma
    (BF16, 32, 64, 32, {}),                                 # fused, wgmma
    (F32, 48, 128, 4, {}),                                  # StarCoder2: fused, ffma
    (BF16, 48, 128, 4, {}),                                 # fused, wgmma
    (F32, 12, 128, 2, {}),                                  # Qwen2: fused, ffma
    # one KV head's page alone exceeds a block
    (F32, 1, 2048, 1, {"decode (walk": 278684, "prefill (ffma": 527376}),
])
def test_pool_refusal_names_each_route_over_the_block(dtype, H, Dh, Kh, need):
    """The walk decode stages a page as f32 in groups of KV heads, the
    largest group that fits a block, and the FFMA prefill one KV head's
    rows of a round of pages, the most pages that fit (the kernels'
    layouts).  Only a pool where one KV head's page does not fit is
    refused before any launch, naming each route and its bytes."""
    pg, G = 16, H // Kh
    es = 4 if dtype == F32 else 2
    kg = pa.walk_group(H, Dh, pg, Kh)
    for n in (kg, kg + 1):
        assert pa.walk_smem(H, Dh, pg, Kh, n) == 4 * (
            2 * H * Dh + pg * n * (2 * Dh + 1) + n * G * pg + 3 * H) + 16
    assert 0 <= kg <= Kh
    assert kg == Kh or pa.walk_smem(H, Dh, pg, Kh, kg + 1) > pa.BLOCK_SMEM
    assert kg == 0 or pa.walk_smem(H, Dh, pg, Kh, kg) <= pa.BLOCK_SMEM
    rnd = pa.ffma_round(Dh, pg, es, 8)
    for n in (rnd, rnd + 1):
        assert pa.ffma_smem(Dh, pg, es, n) == (
            4 * 32 * Dh + 16 * n + 4 * 32 * n + 4 * 32
            + 4 * 32 * (n * pg + 4) + n * pg * (2 * Dh * es + 16))
    assert rnd == 8 or pa.ffma_smem(Dh, pg, es, rnd + 1) > pa.BLOCK_SMEM
    assert rnd == 0 or pa.ffma_smem(Dh, pg, es, rnd) <= pa.BLOCK_SMEM
    if (H, Dh, Kh) == (32, 64, 32):
        assert (kg, rnd) == (25, 8)
    k = _view((3, 2, pg, Kh, Dh), dtype)
    why = pa.pool_refusal(H, k, k)
    if not need:
        assert why is None and rnd >= 1
        pa._check_smem(_view((2, H, Dh), dtype), k, k)
        return
    assert kg == rnd == 0
    for route, nbytes in need.items():
        assert f"paged {route} route) needs {nbytes} B" in why
    assert pa.pool_refusal(H, k, k, prefill=False).count("needs") == 1
    with pytest.raises(ValueError, match="ROADMAP"):
        pa._check_smem(_view((2, H, Dh), dtype), k, k)


@pytest.mark.parametrize("Dh,pg,dtype,rnd", [
    (64, 16, F32, 8), (128, 16, F32, 8), (16, 4, F32, 8), (96, 24, BF16, 8),
    (20, 4, F16, 8), (512, 16, F32, 2), (512, 64, F32, 0), (1024, 4, BF16, 5),
])
def test_ffma_round_and_head_dim_limit(Dh, pg, dtype, rnd):
    """Pages an FFMA prefill block stages a round (up to M = 8 here): all
    eight at the registry's pools, fewer where a page of one KV head is
    large; a head dim over 512 is refused even where its page fits (the
    kernel's register tile), and a head dim that is not a multiple of 4
    rounds its rows up to 4 lanes."""
    es = 4 if dtype == F32 else 2
    assert pa.ffma_round(Dh, pg, es, 8) == rnd
    q, k = _view((1, 4, 1, Dh), dtype), _view((3, 2, pg, 1, Dh), dtype)
    why = pa.smem_refusal(q, k, k)
    if rnd and Dh <= pa.FFMA_MAX_HEAD_DIM:
        assert why is None
    elif rnd:
        assert why == f"paged prefill (ffma route) takes head dims up to 512, not {Dh} (bfloat16)"
    else:
        assert "needs" in why and pa.route(q, k, k) == "ffma"
    dpad = -(-Dh // 4) * 4
    assert pa.ffma_smem(Dh, pg, es, 1) == pa.ffma_smem(dpad, pg, es, 1)


@pytest.mark.parametrize("M", list(range(1, 41)) + [64, 100, 127, 128, 129])
def test_fused_partition(M):
    """Every slot in exactly one block, consecutive slots a block, at most
    eight blocks (one cluster) a request, none empty, the last the only
    short one."""
    nb, spb = pa.fused_partition(M)
    assert 1 <= nb <= pa.FUSED_MAX_CLUSTER
    assert spb == -(-M // min(M, 8))
    groups = [range(r * spb, min(M, (r + 1) * spb)) for r in range(nb)]
    assert [j for g in groups for j in g] == list(range(M))
    assert all(len(g) == spb for g in groups[:-1]) and 1 <= len(groups[-1]) <= spb
    if M <= 8:
        assert (nb, spb) == (M, 1)


# a pool of P pages with L = 3 layers, read at layer 1; NULL is the last page
P, L, LAYER, PG, KH, DH, H = 12, 3, 1, 4, 2, 16, 4
NULL = P - 1
# request 0: ten real pages; 1: four, then NULL; 2: one, then NULL
BT = np.array([[0, 2, 8, 3, 4, 7, 1, 6, 10, 9, NULL, NULL],
               [5, 1, 10, 3] + [NULL] * 8,
               [6] + [NULL] * 11], np.int32)
# request 0's last real page (slot 9) and request 1's last (slot 3) lie past
# their positions
POS = np.array([9 * PG - 2, 3 * PG - 1, 2], np.int32)


def _pool(dtype, seed=0):
    """K and V pools with NaN, ±Inf, a range-guard value (4e3) and a
    bit-pattern value (3.0) at layer 1 of live pages, of pages past their
    request's position and of the NULL page, and a NaN at layer 0."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((P, L, PG, KH, DH)).astype(np.float32)
    v = rng.standard_normal((P, L, PG, KH, DH)).astype(np.float32)
    k[2, 1, 1, 0, 3] = np.nan             # live
    v[5, 1, 0, 1, 0] = np.inf             # live
    k[3, 1, PG - 1, 1, 7] = -np.inf       # live for request 0, past pos for 1
    v[8, 1, 2, 0, 6] = -np.inf            # live
    k[9, 1, 0, 1, 5] = np.nan             # past pos (request 0's slot 9)
    v[9, 1, 3, 0, 2] = np.inf             # past pos
    v[3, 1, 1, 1, 9] = np.nan             # past pos for request 1
    v[NULL, 1, 0, 0, 1] = np.nan          # the null page
    k[NULL, 1, 2, 1, 2] = 4.0e3           # range guard only
    v[1, 1, 1, 0, 4] = 3.0                # bit pattern only
    k[2, 0, 0, 0, 0] = np.nan             # another layer
    return convert.to_torch(k).to(dtype), convert.to_torch(v).to(dtype)


def _detector_kwargs(kind, dtype):
    """(reference, port) detector and fill kwargs of one kind."""
    if kind == "default":
        return {}, {}
    if kind == "v_off":
        return dict(detector_v=None), dict(detector_v=None)
    lay = detect.layout_of(dtype)
    three = int(detect.bits_of(torch.tensor([3.0], dtype=dtype))[0]) & ((1 << lay.width) - 1)
    spec = dict(max_magnitude=1e3, bitpatterns=((None, (1 << lay.width) - 1, three),))
    fill = dict(policy_k="zero", policy_v="constant", constant_v=0.5)
    jd, td = jrules.Detector(**spec), rules.Detector(**spec)
    return (dict(detector_k=jd, detector_v=jd, **fill),
            dict(detector_k=td, detector_v=td, **fill))


def _reference(q, k, v, bt, pos, splits, jkw, dtype):
    args = [jnp.asarray(convert.to_numpy(x)).astype(JDT[dtype]) for x in (q, k, v)]
    args += [jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(LAYER, jnp.int32)]
    if splits == 1:
        out = jpa.paged_attention_raw(*args, **jkw)
    else:
        out = jpa.paged_attention_splitk_raw(*args, splits=splits, **jkw)
    return [torch.from_numpy(np.array(x.astype(jnp.float32)
                                      if x.dtype == JDT[dtype] else x))
            for x in out]


def _same_nonfinite_and_close(got, want, tol):
    got, want = got.float(), want.float()
    fin = want.isfinite()
    assert torch.equal(got.isfinite(), fin)
    torch.testing.assert_close(got[fin], want[fin], rtol=tol, atol=tol)
    both_inf = got.isinf() & want.isinf()
    assert torch.equal(got[both_inf], want[both_inf])


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("kind", ["default", "custom", "v_off"])
@pytest.mark.parametrize("M,splits", [(12, 1), (12, 4), (10, 2), (7, 1)])
def test_fused_twin_matches_reference(dtype, kind, M, splits):
    """The fused route's plain twin against the Pallas kernels: M = 12 and
    10 put two slots in a block (six and five blocks), so its partition
    differs from every ``splits``; M = 7 one slot a block.  Planted lanes
    sit in live slots, in slots past ``pos`` and in the NULL page; with V
    detection off they stay non-finite and must land where the
    reference's do."""
    k, v = _pool(dtype, seed=1)
    bt = np.ascontiguousarray(BT[:, :M])
    pos = np.minimum(POS, M * PG - 1).astype(np.int32)
    q = convert.to_torch(np.random.default_rng(2).standard_normal(
        (3, H, DH)).astype(np.float32)).to(dtype)
    jkw, tkw = _detector_kwargs(kind, dtype)
    jout, jslot, jcnt = _reference(q, k, v, bt, pos, splits, jkw, dtype)
    out, slot, cnt = pa.paged_decode_fused_plain(
        q, k, v, torch.from_numpy(bt), torch.from_numpy(pos), LAYER, **tkw)
    assert torch.equal(slot, jslot.to(torch.int32))
    assert torch.equal(cnt, jcnt.to(torch.int32))
    assert int(cnt[pa.EV_TOTAL]) > 0
    assert out.dtype == dtype and out.shape == q.shape
    _same_nonfinite_and_close(out, jout, TOL[dtype])
    assert bool(out.isfinite().all()) == (kind != "v_off")


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("splits", [1, 4])
def test_twins_match_reference_at_twelve_heads_a_kv_head(dtype, splits):
    """G = 12 (twelve query heads on one KV head), StarCoder2-15B's GQA
    ratio, which the fused route now takes: the walk's plain version at
    ``splits`` and the fused route's plain twin against the Pallas kernels
    in interpret mode, with NaN and ±Inf in live slots, past ``pos`` and in
    the NULL page.  Slot and AT counts equal, outputs within the file's
    tolerances."""
    rng = np.random.default_rng(6)
    k = rng.standard_normal((P, L, PG, 1, DH)).astype(np.float32)
    v = rng.standard_normal((P, L, PG, 1, DH)).astype(np.float32)
    k[2, LAYER, 1, 0, 3] = np.nan         # live
    v[5, LAYER, 0, 0, 0] = np.inf         # live
    v[9, LAYER, 3, 0, 2] = np.inf         # past pos
    k[NULL, LAYER, 2, 0, 2] = -np.inf     # the null page
    k, v = (convert.to_torch(x).to(dtype) for x in (k, v))
    q = convert.to_torch(rng.standard_normal((3, 12, DH)).astype(np.float32)).to(dtype)
    jout, jslot, jcnt = _reference(q, k, v, BT, POS, splits, {}, dtype)
    bt, pos = torch.from_numpy(BT), torch.from_numpy(POS)
    for out, slot, cnt in (
            pa.paged_decode_plain(q, k, v, bt, pos, LAYER, splits=splits),
            pa.paged_decode_fused_plain(q, k, v, bt, pos, LAYER)):
        assert torch.equal(slot, jslot.to(torch.int32))
        assert torch.equal(cnt, jcnt.to(torch.int32))
        assert int(cnt[pa.EV_TOTAL]) > 0
        _same_nonfinite_and_close(out, jout, TOL[dtype])
        assert bool(out.isfinite().all())


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("where", ["past_pos", "null_page"])
@pytest.mark.parametrize("val", [float("nan"), float("inf")])
def test_fused_twin_zero_times_nan_rule(dtype, where, val):
    """V detection off, one NaN or Inf V lane in a slot past ``pos[b]`` (or
    in the NULL page, every null-padded slot), nothing else planted: in
    the reference it reaches that lane of every head of its KV head through
    0 × NaN (a dead split's partial through the merge's 0 × NaN), and the
    twin's non-finite positions equal the reference's at every
    ``splits``."""
    rng = np.random.default_rng(3)
    k = rng.standard_normal((P, L, PG, KH, DH)).astype(np.float32)
    v = rng.standard_normal((P, L, PG, KH, DH)).astype(np.float32)
    page = 9 if where == "past_pos" else NULL
    v[page, LAYER, 1, 1, 6] = val
    k, v = (convert.to_torch(x).to(dtype) for x in (k, v))
    q = convert.to_torch(rng.standard_normal((3, H, DH)).astype(np.float32)).to(dtype)
    bt, pos = BT, POS
    out = pa.paged_decode_fused_plain(q, k, v, torch.from_numpy(bt),
                                      torch.from_numpy(pos), LAYER,
                                      detector_v=None)[0]
    bad = ~out.float().isfinite()
    # request 0 holds page 9 past its position (and NULL slots 10, 11);
    # request 1 and 2 hold NULL slots; column 6 of KV head 1's heads
    heads = [h for h in range(H) if h // (H // KH) == 1]
    rows = [0] if where == "past_pos" else [0, 1, 2]
    want = torch.zeros_like(bad)
    for b in rows:
        want[b, heads, 6] = True
    assert torch.equal(bad, want)
    for splits in (1, 2, 4):
        jout = _reference(q, k, v, bt, pos, splits, dict(detector_v=None), dtype)[0]
        _same_nonfinite_and_close(out, jout, TOL[dtype])


def test_fused_twin_equals_the_walk_where_partitions_agree():
    """With one slot a block (M <= 8) and one slot a split (splits = M),
    the twin is the split-K walk bit for bit; a short last group (M = 10:
    two slots a block, the fifth block one) leaves the padded walk exact."""
    k, v = _pool(F32, seed=4)
    q = convert.to_torch(np.random.default_rng(5).standard_normal(
        (3, H, DH)).astype(np.float32))
    bt = torch.from_numpy(np.ascontiguousarray(BT[:, :8]))
    pos = torch.from_numpy(np.minimum(POS, 31))
    twin = pa.paged_decode_fused_plain(q, k, v, bt, pos, LAYER)
    walk = pa.paged_decode_plain(q, k, v, bt, pos, LAYER, splits=8)
    assert torch.equal(detect.bits_of(twin[0]), detect.bits_of(walk[0]))
    assert torch.equal(twin[1], walk[1]) and torch.equal(twin[2], walk[2])
    bt10 = torch.from_numpy(np.ascontiguousarray(BT[:, :10]))
    bt9 = torch.from_numpy(np.ascontiguousarray(BT[:, :9]))
    pos9 = torch.from_numpy(np.minimum(POS, 8 * PG - 1))
    # slot 9 masked for every request: dropping it changes no float
    assert pa.fused_partition(10) == (5, 2)
    out10 = pa.paged_decode_fused_plain(q, k, v, bt10, pos9, LAYER)[0]
    out9 = pa._decode_plain(q, k, v, bt9, pos9, LAYER, 2,
                            pa._operand_spec(F32, True, "zero", 0.0, "default",
                                             "default", None, None, None, None))[0]
    assert torch.equal(detect.bits_of(out10), detect.bits_of(out9))
