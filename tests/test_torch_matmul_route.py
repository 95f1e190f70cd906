"""The route rule of ``repair_matmul`` and the plain twin of the scan
kernel of its wgmma and f32 routes, on the CPU.

``route`` is a pure function of the operands' dtypes, shapes and data
pointers, so it is held here on CPU tensors.  ``scan_plain`` (what the scan
kernel writes: per-logical-tile NaN/Inf lane counts and per-physical-tile
fatal flags) is held against numpy, and the seven counts its tiles give
through the closed forms against the reference's Pallas kernel
(``src/repro/kernels/repair_matmul.py::repair_matmul_raw``) in interpret
mode, as the reference's own tests run it.  Everything here is integer:
counts and flags must be equal.  The scan kernel itself is held against
``scan_plain`` on the card (``tests/test_torch_cuda.py``).
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
from repro_torch.kernels import repair_matmul as rm  # noqa: E402

# the module, not the package attribute of the same name (a jitted function)
jrm = importlib.import_module("repro.kernels.repair_matmul")

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
JDT = {F32: jnp.float32, BF16: jnp.bfloat16, F16: jnp.float16}


def _operands(M, K, N, da, db, off_a=0, off_b=0):
    """Contiguous (M, K) and (K, N) views starting ``off_*`` elements into
    their storage."""
    a = torch.zeros(M * K + off_a, dtype=da)[off_a:].view(M, K)
    b = torch.zeros(K * N + off_b, dtype=db)[off_b:].view(K, N)
    return a, b


@pytest.mark.parametrize("mkn,da,db,off_a,off_b,want", [
    ((64, 128, 256), BF16, BF16, 0, 0, "wgmma"),
    ((64, 128, 256), F16, F16, 0, 0, "wgmma"),
    ((2048, 1536, 8960), BF16, BF16, 0, 0, "wgmma"),      # gate/up
    ((2048, 8960, 1536), BF16, BF16, 0, 0, "wgmma"),      # down
    ((200, 1032, 328), BF16, BF16, 0, 0, "wgmma"),        # ragged M
    ((5, 8, 8), F16, F16, 0, 0, "wgmma"),
    ((512, 512, 512), F32, F32, 0, 0, "f32"),             # the quickstart
    ((2048, 1536, 8960), F32, F32, 0, 0, "f32"),          # gate/up in f32
    ((96, 264, 320), F32, F32, 0, 0, "f32"),
    ((200, 1032, 328), F32, F32, 0, 0, "f32"),            # ragged M
    ((5, 8, 8), F32, F32, 0, 0, "f32"),
    ((64, 130, 256), F32, F32, 0, 0, "ffma"),             # K % 4 != 0
    ((64, 128, 258), F32, F32, 0, 0, "ffma"),             # N % 4 != 0
    ((64, 128, 256), F32, F32, 1, 0, "ffma"),             # a 4 bytes off
    ((64, 128, 256), F32, F32, 0, 2, "ffma"),             # b 8 bytes off
    ((64, 128, 256), F32, F32, 4, 4, "f32"),              # 16 bytes off
    ((64, 128, 260), F32, F32, 0, 4, "f32"),              # N % 8 != 0
    ((0, 128, 256), F32, F32, 0, 0, "ffma"),
    ((64, 128, 256), F32, F16, 0, 0, "ffma"),
    ((64, 128, 256), BF16, F32, 0, 0, "ffma"),
    ((64, 128, 256), F32, BF16, 0, 0, "ffma"),
    ((64, 128, 256), F16, BF16, 0, 0, "ffma"),
    ((64, 132, 256), BF16, BF16, 0, 0, "ffma"),           # K % 8 != 0
    ((64, 128, 260), BF16, BF16, 0, 0, "ffma"),           # N % 8 != 0
    ((96, 260, 324), BF16, BF16, 0, 0, "ffma"),
    ((64, 128, 256), BF16, BF16, 1, 0, "ffma"),           # a 2 bytes off
    ((64, 128, 256), BF16, BF16, 0, 4, "ffma"),           # b 8 bytes off
    ((64, 128, 256), BF16, BF16, 8, 8, "wgmma"),          # 16 bytes off
    ((0, 128, 256), BF16, BF16, 0, 0, "ffma"),
    ((64, 0, 256), BF16, BF16, 0, 0, "ffma"),
    ((64, 128, 256), F16, F32, 0, 0, "ffma"),
    ((64, 128, 264), F16, F16, 0, 8, "wgmma"),
])
def test_route_rule(mkn, da, db, off_a, off_b, want):
    a, b = _operands(*mkn, da, db, off_a, off_b)
    assert a.is_contiguous() and b.is_contiguous()
    assert rm.route(a, b) == want


@pytest.mark.parametrize("mnk,sms,want", [
    ((2048, 8960, 1536), 132, (1056, 4)),  # gate/up: 4 waves, 64 tiles split 4 ways
    ((2048, 1536, 8960), 132, (192, 1)),   # down: 192 tiles, one wave, not split
    ((512, 512, 512), 132, (0, 4)),        # the quickstart: 16 tiles, 32 k-steps
    ((5, 8, 8), 132, (1, 1)),              # one k-step: no split
    ((2048, 2048, 64), 4, (256, 1)),       # 256 tiles fill 32 waves of 8
    ((200, 328, 1032), 132, (0, 8)),
])
def test_f32_plan(mnk, sms, want):
    """The f32 route's grid: whole waves over all of K, the last wave's
    tiles split over k within the limits."""
    M, N, K = mnk
    n_full, splits = rm.f32_plan(M, N, K, sms)
    assert (n_full, splits) == want
    tiles = -(-M // 128) * -(-N // 128)
    assert n_full == tiles or splits <= rm.F32_MAX_SPLITS
    assert -(-K // 16) // splits >= rm.F32_MIN_SPLIT_STEPS or splits == 1


def _planted(rng, shape, n_bad, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, n_bad, replace=False)
    flat[idx] = rng.choice([np.nan, np.inf, -np.inf, 3.0e4, 3.0], n_bad)
    return convert.to_torch(x).to(dtype)


def _np_tiles(fatal, br, bc, pad=False):
    """Per-tile sums of a boolean numpy mask; with ``pad``, the ragged edge
    padded with False first."""
    R, C = fatal.shape
    if pad:
        fatal = np.pad(fatal, ((0, -R % br), (0, -C % bc)))
        R, C = fatal.shape
    return fatal.reshape(R // br, br, C // bc, bc).sum(axis=(1, 3))


@pytest.mark.parametrize("dtype", [BF16, F16, F32])
@pytest.mark.parametrize("mkn,blocks", [
    ((96, 264, 320), (32, 64, 88)),
    ((200, 1032, 328), (50, 82, 86)),
    ((256, 128, 512), None),
])
def test_scan_plain_matches_numpy(mkn, blocks, dtype):
    M, K, N = mkn
    rng = np.random.default_rng(M + K + N)
    a = _planted(rng, (M, K), 40, dtype)
    b = _planted(rng, (K, N), 40, dtype)
    tiles_a, tiles_b, flags_a, flags_b = rm.scan_plain(a, b, blocks=blocks)
    bm, bn, bk = blocks or rm._default_blocks(M, N, K)
    tm, tn, tk = rm.WGMMA_TILE
    for x, t, f, (br, bc), (fr, fc) in (
        (a, tiles_a, flags_a, (bm, bk), (tm, tk)),
        (b, tiles_b, flags_b, (bk, bn), (tk, tn)),
    ):
        v = x.float().numpy()
        nan, inf = np.isnan(v), np.isinf(v)
        assert t.dtype == f.dtype == torch.int32
        np.testing.assert_array_equal(t[..., 0].numpy(), _np_tiles(nan, br, bc))
        np.testing.assert_array_equal(t[..., 1].numpy(), _np_tiles(inf, br, bc))
        np.testing.assert_array_equal(
            f.numpy(), (_np_tiles(nan | inf, fr, fc, pad=True) > 0).astype(np.int32))
    assert int(flags_a.sum()) > 0 and int(flags_b.sum()) > 0


@pytest.mark.parametrize("mkn,blocks", [
    ((96, 264, 320), (32, 64, 88)),
    ((200, 1032, 328), (50, 82, 86)),
    ((5, 8, 8), None),
])
def test_f32_scan_plain_matches_numpy(mkn, blocks):
    """The f32 route's scan: lane counts as on the wgmma route, flags on
    ``F32_TILE``'s A (128 x 16) and B (16 x 128) tiles, ragged edges
    padded."""
    M, K, N = mkn
    rng = np.random.default_rng(M * K + N)
    a = _planted(rng, (M, K), min(40, M * K // 4), F32)
    b = _planted(rng, (K, N), min(40, K * N // 4), F32)
    assert rm.route(a, b) == "f32"
    tiles_a, tiles_b, flags_a, flags_b = rm.scan_plain(a, b, blocks=blocks,
                                                       tile=rm.F32_TILE)
    bm, bn, bk = blocks or rm._default_blocks(M, N, K)
    tm, tn, tk = rm.F32_TILE
    assert (tuple(flags_a.shape), tuple(flags_b.shape)) == rm._flag_shapes(
        M, N, K, rm.F32_TILE)
    for x, t, f, (br, bc), (fr, fc) in (
        (a, tiles_a, flags_a, (bm, bk), (tm, tk)),
        (b, tiles_b, flags_b, (bk, bn), (tk, tn)),
    ):
        v = x.numpy()
        nan, inf = np.isnan(v), np.isinf(v)
        np.testing.assert_array_equal(t[..., 0].numpy(), _np_tiles(nan, br, bc))
        np.testing.assert_array_equal(t[..., 1].numpy(), _np_tiles(inf, br, bc))
        np.testing.assert_array_equal(
            f.numpy(), (_np_tiles(nan | inf, fr, fc, pad=True) > 0).astype(np.int32))
    assert int(flags_a.sum()) > 0 and int(flags_b.sum()) > 0
    # the scratch the f32 route allocates holds these flags
    sizes = rm._scratch_sizes(M, N, K, (bm, bn, bk), rm.F32_TILE)
    assert sizes[3:] == [flags_a.numel(), flags_b.numel()]


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
    """The seven counts from the scan's tiles equal the Pallas kernel's."""
    M, K, N, blocks = 64, 128, 128, (32, 64, 64)
    rng = np.random.default_rng(7)
    a = _planted(rng, (M, K), 6, dtype)
    b = _planted(rng, (K, N), 6, dtype)
    if kind == "zero":
        a[3, 70] = 0.0
        b[100, 5] = 0.0
    jd, td = _detectors(kind, dtype)
    _, want = jrm.repair_matmul_raw(
        jnp.asarray(convert.to_numpy(a)).astype(JDT[dtype]),
        jnp.asarray(convert.to_numpy(b)).astype(JDT[dtype]),
        blocks=blocks, detector=jd)
    tile = rm.TILES[rm.route(a, b)]       # f32 on its own route's tiles
    tiles_a, tiles_b, _, _ = rm.scan_plain(a, b, blocks=blocks, detector=td,
                                           tile=tile)
    got = rm._mm_counts(tiles_a, tiles_b)
    assert got.tolist() == np.asarray(want).tolist()
    assert got[rm.EV_TOTAL] > 0
