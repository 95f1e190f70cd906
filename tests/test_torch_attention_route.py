"""The route rule of ``flash_attention``, the plain twin of the scan
kernel of its wgmma and f32 routes, and the plain twin of the f32 route's
key partition, on the CPU.

``route`` is a pure function of the operands' dtypes, shapes and data
pointers, so it is held here on CPU tensors.  ``scan_plain`` (what the scan
kernel writes: per-logical-tile NaN/Inf lane counts of K and V over the
live prefix, and per-physical-tile K and V fatal flags over every row the
main kernel loads) is held against numpy, and the seven counts its tiles
give through the closed forms against the reference's Pallas kernel
(``src/repro/kernels/repair_attention.py::flash_attention_raw``) in
interpret mode, as the reference's own tests run it.  Everything here is
integer: counts and flags must be equal.  The scan kernel itself is held
against ``scan_plain`` on the card (``tests/test_torch_cuda.py``).
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import rules as jrules  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import rules  # noqa: E402
from repro_torch.kernels import repair_attention as ra  # noqa: E402

# the module, not the package attribute of the same name
jra = importlib.import_module("repro.kernels.repair_attention")

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
JDT = {F32: jnp.float32, BF16: jnp.bfloat16, F16: jnp.float16}


def _view(shape, dtype, off=0):
    """A contiguous tensor of ``shape`` starting ``off`` elements into its
    storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + off, dtype=dtype)[off:].view(shape)


@pytest.mark.parametrize("q_shape,kv_shape,dtypes,offs,want", [
    ((1, 4, 256, 64), (1, 2, 256, 64), (BF16,) * 3, (0, 0, 0), "wgmma"),
    ((1, 4, 256, 64), (1, 2, 256, 64), (F16,) * 3, (0, 0, 0), "wgmma"),
    ((2, 4, 128, 128), (2, 2, 192, 128), (BF16,) * 3, (0, 0, 0), "wgmma"),
    ((1, 4, 64, 128), (1, 4, 192, 128), (F16,) * 3, (0, 0, 0), "wgmma"),
    ((1, 12, 2048, 128), (1, 2, 2048, 128), (BF16,) * 3, (0, 0, 0), "wgmma"),
    ((1, 4, 256, 64), (1, 2, 256, 64), (F32,) * 3, (0, 0, 0), "f32"),     # the quickstart
    ((1, 12, 2048, 128), (1, 2, 2048, 128), (F32,) * 3, (0, 0, 0), "f32"),
    ((2, 4, 128, 64), (2, 2, 192, 64), (F32,) * 3, (0, 0, 0), "f32"),
    ((1, 4, 256, 96), (1, 2, 256, 96), (F32,) * 3, (0, 0, 0), "ffma"),    # D 96
    ((1, 4, 256, 64), (1, 2, 256, 64), (F32,) * 3, (1, 0, 0), "ffma"),    # q 4 bytes off
    ((1, 4, 256, 64), (1, 2, 256, 64), (F32,) * 3, (0, 2, 0), "ffma"),    # k 8 bytes off
    ((1, 4, 256, 64), (1, 2, 256, 64), (F32,) * 3, (0, 0, 3), "ffma"),    # v 12 bytes off
    ((1, 4, 256, 64), (1, 2, 256, 64), (F32,) * 3, (4, 4, 4), "f32"),     # 16 bytes off
    ((1, 4, 256, 64), (1, 2, 256, 64), (F32, F32, BF16), (0, 0, 0), "ffma"),
    ((1, 4, 0, 64), (1, 2, 256, 64), (F32,) * 3, (0, 0, 0), "ffma"),      # S = 0
    ((1, 4, 256, 64), (1, 2, 256, 64), (BF16, BF16, F16), (0, 0, 0), "ffma"),
    ((1, 4, 256, 64), (1, 2, 256, 64), (BF16, F32, F32), (0, 0, 0), "ffma"),
    ((1, 4, 256, 96), (1, 2, 256, 96), (BF16,) * 3, (0, 0, 0), "ffma"),
    ((1, 4, 256, 64), (1, 2, 256, 64), (BF16,) * 3, (1, 0, 0), "ffma"),   # q 2 bytes off
    ((1, 4, 256, 64), (1, 2, 256, 64), (F16,) * 3, (0, 4, 0), "ffma"),    # k 8 bytes off
    ((1, 4, 256, 64), (1, 2, 256, 64), (BF16,) * 3, (0, 0, 4), "ffma"),   # v 8 bytes off
    ((1, 4, 256, 64), (1, 2, 256, 64), (BF16,) * 3, (8, 8, 8), "wgmma"),  # 16 bytes off
    ((1, 4, 0, 64), (1, 2, 256, 64), (BF16,) * 3, (0, 0, 0), "ffma"),     # S = 0
    ((0, 4, 256, 64), (0, 2, 256, 64), (BF16,) * 3, (0, 0, 0), "ffma"),   # B = 0
])
def test_route_rule(q_shape, kv_shape, dtypes, offs, want):
    q, k, v = (_view(s, d, o) for s, d, o in
               zip((q_shape, kv_shape, kv_shape), dtypes, offs))
    assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
    assert ra.route(q, k, v) == want


@pytest.mark.parametrize("dtype,want", [(BF16, "wgmma"), (F32, "f32")])
def test_route_rule_needs_contiguous_operands(dtype, want):
    q = _view((1, 4, 256, 64), dtype)
    k = _view((1, 2, 64, 256), dtype).transpose(2, 3)
    assert ra.route(q, k, k) == "ffma"
    assert ra.route(q, k.contiguous(), k.contiguous()) == want


def _planted(rng, shape, n_bad, dtype, rows=()):
    """Standard normal values with ``n_bad`` NaN/±Inf/finite plants at random
    lanes, and a NaN in lane (b=0, kh=0, r, 5) for each r in ``rows``."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, n_bad, replace=False)
    flat[idx] = rng.choice([np.nan, np.inf, -np.inf, 3.0e4, 3.0], n_bad)
    for r in rows:
        x[0, 0, r, 5] = np.nan
    return convert.to_torch(x).to(dtype)


# (B, Kh, S, T, D), blocks, causal, planted rows, (rows counted, rows read)
SCAN_CASES = {
    "causal S=T": ((2, 2, 256, 256, 64), (64, 64), True, (), (256, 256)),
    # S < T: keys 64..127 are loaded by the one 128-row q tile, masked for
    # every row and past the live prefix: flagged, not counted; key 200 is
    # never loaded
    "causal S<T": ((1, 2, 64, 384, 64), (32, 64), True, (100, 200), (64, 128)),
    # T = 192 is not a multiple of the 128-row tile
    "ragged T": ((1, 2, 192, 192, 128), (64, 64), True, (130, 191), (192, 192)),
    "ragged T non-causal": ((1, 1, 64, 192, 64), (32, 64), False, (150,), (192, 192)),
    # a logical tile of 512 rows reaches past the rows the kernel loads
    "live past loaded": ((1, 1, 192, 1024, 64), (64, 512), True, (400, 700),
                         (512, 512)),
    "non-causal S<T": ((1, 2, 64, 256, 128), None, False, (255,), (256, 256)),
}


def _np_scan(x, bk, live, rows, tile):
    """numpy twin of one operand's half of the scan: (NaN, Inf) lanes per
    logical tile over rows < live, and flags per physical tile over rows
    < rows."""
    a = x.float().numpy()
    B, Kh, T, D = a.shape
    nan, inf = np.isnan(a), np.isinf(a)
    keep = (np.arange(T) < live)[:, None]
    counts = [(m & keep).reshape(B, Kh, T // bk, bk * D).sum(-1) for m in (nan, inf)]
    fatal = ((nan | inf).any(-1) & (np.arange(T) < rows))
    fatal = np.pad(fatal, ((0, 0), (0, 0), (0, -T % tile)))
    return counts, fatal.reshape(B, Kh, -1, tile).any(-1).astype(np.int32)


@pytest.mark.parametrize("dtype", [BF16, F16])
@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_plain_matches_numpy(case, dtype):
    (B, Kh, S, T, D), blocks, causal, rows_planted, (live, rows) = SCAN_CASES[case]
    rng = np.random.default_rng(S + T + D)
    k = _planted(rng, (B, Kh, T, D), 12, dtype, rows_planted)
    v = _planted(rng, (B, Kh, T, D), 12, dtype, rows_planted[:1])
    assert ra._scan_rows(S, T, (blocks or ra._default_blocks(S, T))[1],
                         causal) == (live, rows)
    tiles, flags = ra.scan_plain(k, v, S=S, causal=causal, blocks=blocks)
    bk = (blocks or ra._default_blocks(S, T))[1]
    tk = ra.WGMMA_TILE[1]
    assert tiles.dtype == flags.dtype == torch.int32
    assert tuple(tiles.shape) == (B, Kh, T // bk, 4)
    assert tuple(flags.shape) == (B, Kh, -(-T // tk), 2)
    for i, x in enumerate((k, v)):
        (nan, inf), f = _np_scan(x, bk, live, rows, tk)
        np.testing.assert_array_equal(tiles[..., 2 * i].numpy(), nan)
        np.testing.assert_array_equal(tiles[..., 2 * i + 1].numpy(), inf)
        np.testing.assert_array_equal(flags[..., i].numpy(), f)
    assert int(flags.sum()) > 0
    for r in rows_planted:   # flagged iff read, counted iff live
        assert bool(flags[0, 0, r // tk, 0]) == (r < rows)
        assert bool(tiles[0, 0, r // bk, 0] > 0) == (r < live)


# rows counted and read per case by the f32 route's scan, whose main kernel
# loads keys in 64-row tiles up to its 64-row q tile's causal edge
F32_SCAN_ROWS = {"causal S=T": (256, 256), "causal S<T": (64, 64),
                 "ragged T": (192, 192), "ragged T non-causal": (192, 192),
                 "live past loaded": (512, 512), "non-causal S<T": (256, 256)}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_f32_scan_plain_matches_numpy(case):
    """The f32 route's scan on ``F32_TILE``: the same counts, flags on
    64-row K/V tiles over the rows a 64-row q tile loads (at S = 64 < T
    keys 100 and 200 are neither read nor counted)."""
    (B, Kh, S, T, D), blocks, causal, rows_planted, _ = SCAN_CASES[case]
    live, rows = F32_SCAN_ROWS[case]
    rng = np.random.default_rng(S + T + D)
    k = _planted(rng, (B, Kh, T, D), 12, F32, rows_planted)
    v = _planted(rng, (B, Kh, T, D), 12, F32, rows_planted[:1])
    bk = (blocks or ra._default_blocks(S, T))[1]
    assert ra._scan_rows(S, T, bk, causal, ra.F32_TILE) == (live, rows)
    tiles, flags = ra.scan_plain(k, v, S=S, causal=causal, blocks=blocks,
                                 tile=ra.F32_TILE)
    tk = ra.F32_TILE[1]
    assert tuple(flags.shape) == (B, Kh, -(-T // tk), 2)
    assert flags.numel() == ra._scratch_sizes(B, Kh, T, bk, ra.F32_TILE)[2]
    for i, x in enumerate((k, v)):
        (nan, inf), f = _np_scan(x, bk, live, rows, tk)
        np.testing.assert_array_equal(tiles[..., 2 * i].numpy(), nan)
        np.testing.assert_array_equal(tiles[..., 2 * i + 1].numpy(), inf)
        np.testing.assert_array_equal(flags[..., i].numpy(), f)
    for r in rows_planted:
        assert bool(flags[0, 0, r // tk, 0]) == (r < rows)
        assert bool(tiles[0, 0, r // bk, 0] > 0) == (r < live)


# (B, H, Kh, S, T, D), blocks, causal: causal S = T over several q tiles,
# S < T, non-causal with T off the 64-key tile, D 128, G 1 and 6
F32_TWIN_CASES = {
    "causal S=T": ((1, 4, 2, 256, 256, 64), (64, 32), True),
    "causal S<T": ((1, 4, 2, 64, 192, 128), (32, 64), True),
    "non-causal ragged T": ((1, 2, 1, 96, 160, 64), (32, 32), False),
    "causal G=6 ragged S": ((2, 6, 1, 200, 200, 64), (40, 40), True),
}


@pytest.mark.parametrize("case", list(F32_TWIN_CASES))
def test_f32_partition_twin_matches_plain(case):
    """The f32 route's key partition (two online softmaxes over alternate
    64-key tiles, merged) gives the full softmax's output within 1e-5 and
    the same counts, with NaN and Inf planted in K and V."""
    (B, H, Kh, S, T, D), blocks, causal = F32_TWIN_CASES[case]
    rng = np.random.default_rng(S * T + D)
    q = convert.to_torch(rng.standard_normal((B, H, S, D)).astype(np.float32))
    k = _planted(rng, (B, Kh, T, D), 6, F32, (T - 1,))
    v = _planted(rng, (B, Kh, T, D), 6, F32)
    kw = dict(causal=causal, blocks=blocks)
    got = ra.flash_attention_f32_plain(q, k, v, **kw)
    want = ra.flash_attention_plain(q, k, v, **kw)
    assert torch.equal(got[1], want[1]) and int(got[1][ra.EV_TOTAL]) > 0
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)


def test_f32_partition_twin_matches_reference():
    """The twin against the reference's Pallas kernel in interpret mode:
    causal over four 64-row q tiles with S < T, G = 2; output within 1e-5
    (f32, other summation orders), counts equal."""
    B, H, Kh, S, T, D, blocks = 1, 4, 2, 256, 320, 64, (64, 64)
    rng = np.random.default_rng(29)
    q = convert.to_torch(rng.standard_normal((B, H, S, D)).astype(np.float32))
    k = _planted(rng, (B, Kh, T, D), 6, F32, (70,))
    v = _planted(rng, (B, Kh, T, D), 6, F32, (130,))
    out, counts = jra.flash_attention_raw(
        *(jnp.asarray(convert.to_numpy(x)) for x in (q, k, v)),
        causal=True, blocks=blocks, interpret=True)
    got = ra.flash_attention_f32_plain(q, k, v, causal=True, blocks=blocks)
    assert got[1].tolist() == np.asarray(counts).tolist()
    torch.testing.assert_close(got[0], convert.to_torch(np.asarray(out)),
                               rtol=1e-5, atol=1e-5)


def _detectors(kind, dtype):
    """(reference, port) detectors of one kind."""
    if kind == "default":
        return None, None
    if kind == "range":
        spec = dict(max_magnitude=1e3)
    else:                              # the bit pattern of +0.0
        mask = 0xFFFFFFFF if dtype == F32 else 0xFFFF
        spec = dict(bitpatterns=((None, mask, 0),))
    return jrules.Detector(**spec), rules.Detector(**spec)


@pytest.mark.parametrize("dtype", [BF16, F16, F32])
@pytest.mark.parametrize("kind", ["default", "range", "zero"])
def test_scan_counts_match_reference(dtype, kind):
    """The seven counts from the scan's tiles equal the Pallas kernel's,
    causal with S < T (the live prefix ends before T)."""
    B, H, Kh, S, T, D, blocks = 1, 2, 1, 64, 128, 64, (32, 32)
    rng = np.random.default_rng(11)
    q = convert.to_torch(rng.standard_normal((B, H, S, D)).astype(np.float32)).to(dtype)
    k = _planted(rng, (B, Kh, T, D), 6, dtype, (20, 100))
    v = _planted(rng, (B, Kh, T, D), 6, dtype, (40,))
    if kind == "zero":
        k[0, 0, 3, 7] = 0.0
        v[0, 0, 50, 1] = 0.0
    jd, td = _detectors(kind, dtype)
    _, want = jra.flash_attention_raw(
        *(jnp.asarray(convert.to_numpy(x)).astype(JDT[dtype]) for x in (q, k, v)),
        causal=True, blocks=blocks, detector=jd, interpret=True)
    tile = ra.TILES[ra.route(q, k, v)]    # f32 on its own route's tiles
    tiles, flags = ra.scan_plain(k, v, S=S, causal=True, blocks=blocks,
                                 detector=td, tile=tile)
    got = ra._at_counts(tiles, (H // Kh) * ra._live_visits(S, T, *blocks, True))
    assert got.tolist() == np.asarray(want).tolist()
    assert got[ra.EV_TOTAL] > 0
    # the plain version's counts are the same closed forms over all tiles
    assert torch.equal(got, ra.flash_attention_plain(
        q, k, v, causal=True, blocks=blocks, detector=td)[1])
