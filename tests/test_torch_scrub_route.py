"""The scrub's plain versions against the reference's Pallas scrub
(interpret mode on the CPU, as the reference's own tests run it) on the
geometries the CUDA kernel's partition has to get right: logical tiles that
straddle two pages, row widths off the 16-byte vector width, count bounds
in the middle of a tile, and many tiles with a fatal lane in each.  Counts
and repaired bits must be identical.  Also the wrapper's launch plan and
its page-id check, which are plain Python.  The kernel itself is held
against the plain versions on the card by ``tests/test_torch_cuda.py``."""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import rules as jrules  # noqa: E402
from repro.kernels.scrub import scrub as j_scrub  # noqa: E402
from repro.kernels.scrub import scrub_pages as j_scrub_pages  # noqa: E402
from repro_torch.convert import to_numpy, to_torch  # noqa: E402
from repro_torch.core import rules  # noqa: E402
from repro_torch.kernels import scrub  # noqa: E402

DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
          "float16": np.float16}
FAULTS = (np.nan, np.inf, -np.inf)


def _planted(shape, dtype, n_faults, seed, every=None):
    """Normal values with ``n_faults`` NaN/±Inf lanes at random places, or
    one in each ``every`` = (rows, cols) tile of the folded 2-D view."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    if every is not None:
        br, bc = every
        for r in range(0, flat.shape[0], br):
            for c in range(0, flat.shape[1], bc):
                flat[r + rng.integers(br), c + rng.integers(bc)] = FAULTS[(r + c) % 3]
    for i, lane in enumerate(rng.choice(flat.size, n_faults, replace=False)):
        flat.reshape(-1)[lane] = FAULTS[i % 3]
    return x.astype(DTYPES[dtype]) if dtype != "float32" else x


def _same(tx, jx):
    np.testing.assert_array_equal(to_numpy(tx).view(np.uint8),
                                  np.asarray(jx).view(np.uint8))


# (pool shape, ids, n_valid, block): tiles of 2 rows over pages of 3 rows
# straddle pages; 7 and 129 columns are off the 8- and 4-lane vector width;
# 600 pages of one 7-lane row take more ids than the by-value cap
PAGE_CASES = {
    "straddle": ((10, 3, 7), [4, 1, 7, 2, 4, 4, 4, 4], 4, (2, 7)),
    "straddle-129": ((6, 3, 129), [5, 0, 3, 0], 3, (6, 129)),
    "odd-rows": ((9, 5, 7), [8, 2, 6], None, None),
    "many-pages": ((600, 1, 7), list(range(599, -1, -1)), None, (8, 7)),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(PAGE_CASES))
def test_scrub_pages_plain_matches_pallas_on_kernel_geometries(case, dtype):
    shape, ids, n_valid, block = PAGE_CASES[case]
    x = _planted(shape, dtype, 3 * shape[0], seed=len(ids))
    jfixed, jc = j_scrub_pages(jnp.asarray(x), jnp.asarray(ids, np.int32),
                               block=block, n_valid=n_valid)
    tx = to_torch(x)
    _, tc = scrub.scrub_pages(tx, ids, block=block, n_valid=n_valid)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _same(tx, jfixed)


# (shape, block, n_valid_rows, every): n_valid_rows mid-tile; 128 tiles of
# (2, 8) with a fatal lane in each (four bitmap words); 129 columns
WHOLE_CASES = {
    "mid-tile-bound": ((5, 8, 7), (8, 7), 13, None),
    "many-tiles": ((64, 32), (2, 8), 0, (2, 8)),
    "many-tiles-bound": ((64, 32), (2, 8), 37, (2, 8)),
    "width-129": ((12, 129), None, 5, None),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(WHOLE_CASES))
def test_scrub_plain_matches_pallas_on_kernel_geometries(case, dtype):
    shape, block, n_valid_rows, every = WHOLE_CASES[case]
    x = _planted(shape, dtype, 9, seed=sum(shape), every=every)
    jfixed, jc = j_scrub(jnp.asarray(x), block=block,
                         n_valid_rows=n_valid_rows or None)
    tx = to_torch(x)
    _, tc = scrub.scrub(tx, block=block, n_valid_rows=n_valid_rows)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _same(tx, jfixed)


@pytest.mark.parametrize("kind", ["inf-off", "range", "constant"])
def test_scrub_plain_detector_variants_match_pallas(kind):
    x = _planted((6, 4, 9), "bfloat16", 20, seed=3)
    x.reshape(-1)[[5, 17]] = 5.0e4            # over the range guard's bound
    spec, pol = {}, {}
    if kind == "inf-off":
        spec = dict(inf=False)
    elif kind == "range":
        spec = dict(max_magnitude=1e3)
    else:
        pol = dict(policy="constant", constant=0.5)
    jd = jrules.Detector(**spec) if spec else None
    td = rules.Detector(**spec) if spec else None
    jfixed, jc = j_scrub_pages(jnp.asarray(x), jnp.asarray([3, 0, 5, 3], np.int32),
                               detector=jd, n_valid=3, **pol)
    tx = to_torch(x)
    _, tc = scrub.scrub_pages(tx, [3, 0, 5, 3], detector=td, n_valid=3, **pol)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _same(tx, jfixed)


@pytest.mark.parametrize("geometry, want", [
    # the engine's page scrub: 2 pages of one (28, 16, 2, 128) bf16 pool row
    ((2, 2, 28 * 16 * 2 * 128, 7),
     scrub.LaunchPlan(8, "value", 256, 56, 112, 1, 10)),
    # the xLSTM cache's mLSTM C at xlstm-1.3b width, batch 4, f32
    ((4, 1, 6 * 7 * 4 * 4 * 1024 * 1024, 5376),
     scrub.LaunchPlan(4, "value", 4096, 43008, 528, 168, 344)),
    # the most ids that ride in the launch's parameters, and one more
    ((2, 512, 7, 512), scrub.LaunchPlan(8, "value", 256, 1, 512, 16, 40)),
    ((4, 513, 7, 513), scrub.LaunchPlan(4, "staged", 4096, 1, 513, 17, 42)),
    # a page smaller than one 16-byte word: one chunk for its scalar lanes
    ((2, 3, 5, 1), scrub.LaunchPlan(8, "value", 256, 1, 3, 1, 10)),
    # an empty buffer: one block still writes the counts
    ((4, 1, 0, 0), scrub.LaunchPlan(4, "value", 256, 1, 1, 0, 8)),
])
def test_launch_plan(geometry, want):
    elem_bytes, n_pages, page_elems, n_tiles = geometry
    assert scrub.launch_plan(elem_bytes, n_pages, page_elems, n_tiles, 132) == want


def test_launch_plan_covers_every_word_once():
    """The chunks of a page cover its whole words: per_page chunks of
    chunk_words reach the last word and no chunk starts past it."""
    for page_elems in (7, 8, 1000, 229376, 1 << 20):
        for n_pages in (1, 2, 3, 600):
            plan = scrub.launch_plan(2, n_pages, page_elems, 1, 132)
            words = page_elems // plan.vec_lanes
            assert plan.chunks_per_page * plan.chunk_words >= words
            assert (plan.chunks_per_page - 1) * plan.chunk_words < max(words, 1)
            assert plan.grid <= n_pages * plan.chunks_per_page


@pytest.mark.parametrize("ids, n_valid, ok", [
    ([4, 1, 7, 4], 3, True),
    ([4, 1, 7, 4], None, False),      # a duplicate among the valid ids
    ([4, 1, 7, 2], 3, False),         # padding that repeats no valid id
    ([4, 1, 7], None, True),
])
def test_live_ids(ids, n_valid, ok):
    arr = np.asarray(ids, np.int64)
    if ok:
        assert scrub.live_ids(arr, n_valid) == ids[:n_valid or len(ids)]
    else:
        with pytest.raises(ValueError):
            scrub.live_ids(arr, n_valid)
