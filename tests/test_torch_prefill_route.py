"""The route rule of ``paged_prefill_raw``, the plain twin of the wgmma
route's scan kernel and its live-slot rule, on the CPU.

``route`` is a pure function of the operands' dtypes, shapes and data
pointers, so it is held here on CPU tensors.  ``prefill_scan_plain`` (what
the scan kernel writes: per-slot fatal-lane totals, the AT counts and one K
and one V flag per (b, j) slot, NULL-padded slots and slots past every
row's causal limit included) is held against numpy and against the
reference's Pallas kernel (``src/repro/kernels/paged_attention.py::
paged_prefill_raw``) in interpret mode, as ``tests/test_torch_kernels.py``
runs it; counts and flags must be equal.  ``live_slots`` (which slots a
row block of the wgmma route loads) is held against brute force, and the
plain version restricted to each row block's loaded slots must give that
block's rows bit for bit, also where a V lane stays non-finite after the
repair and reaches rows that mask it.  The kernels themselves are held against these
plain versions on the card (``tests/test_torch_cuda.py``).
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
JDT = {F32: jnp.float32, BF16: jnp.bfloat16, F16: jnp.float16}


def _view(shape, dtype, off=0):
    """A contiguous tensor of ``shape`` starting ``off`` elements into its
    storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + off, dtype=dtype)[off:].view(shape)


Q = (1, 64, 12, 128)
POOL = (5, 3, 16, 2, 128)


@pytest.mark.parametrize("q_shape,pool_shape,dtypes,offs,want", [
    (Q, POOL, (BF16,) * 3, (0, 0, 0), "wgmma"),
    (Q, POOL, (F16,) * 3, (0, 0, 0), "wgmma"),
    ((2, 20, 4, 64), (5, 3, 16, 2, 64), (BF16,) * 3, (0, 0, 0), "wgmma"),
    ((1, 100, 12, 128), (5, 3, 32, 2, 128), (BF16,) * 3, (0, 0, 0), "wgmma"),
    ((1, 64, 12, 128), (5, 3, 48, 2, 128), (F16,) * 3, (0, 0, 0), "wgmma"),
    ((1, 64, 12, 64), (5, 3, 128, 2, 64), (BF16,) * 3, (0, 0, 0), "wgmma"),
    (Q, POOL, (F32,) * 3, (0, 0, 0), "ffma"),
    (Q, POOL, (BF16, F16, F16), (0, 0, 0), "ffma"),
    (Q, POOL, (BF16, BF16, F16), (0, 0, 0), "ffma"),
    ((3, 6, 4, 16), (9, 2, 4, 2, 16), (BF16,) * 3, (0, 0, 0), "ffma"),  # tests' pool
    ((1, 64, 12, 96), (5, 3, 16, 2, 96), (BF16,) * 3, (0, 0, 0), "ffma"),   # Dh 96
    (Q, (5, 3, 8, 2, 128), (BF16,) * 3, (0, 0, 0), "ffma"),     # pg 8
    (Q, (5, 3, 24, 2, 128), (BF16,) * 3, (0, 0, 0), "ffma"),    # pg 24
    (Q, (5, 3, 256, 2, 128), (BF16,) * 3, (0, 0, 0), "ffma"),   # pg 256
    (Q, POOL, (BF16,) * 3, (1, 0, 0), "ffma"),     # q 2 bytes off
    (Q, POOL, (F16,) * 3, (0, 4, 0), "ffma"),      # k 8 bytes off
    (Q, POOL, (BF16,) * 3, (0, 0, 4), "ffma"),     # v 8 bytes off
    (Q, POOL, (BF16,) * 3, (8, 8, 8), "wgmma"),    # 16 bytes off
    ((1, 0, 12, 128), POOL, (BF16,) * 3, (0, 0, 0), "ffma"),       # C = 0
    (Q, (0, 3, 16, 2, 128), (BF16,) * 3, (0, 0, 0), "ffma"),       # P = 0
])
def test_route_rule(q_shape, pool_shape, dtypes, offs, want):
    q, k, v = (_view(s, d, o) for s, d, o in
               zip((q_shape, pool_shape, pool_shape), dtypes, offs))
    assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
    assert pa.route(q, k, v) == want


def test_route_rule_needs_contiguous_operands():
    k = _view(POOL, BF16)
    q = _view((1, 12, 64, 128), BF16).transpose(1, 2)
    assert pa.route(q, k, k) == "ffma"
    assert pa.route(q.contiguous(), k, k) == "wgmma"
    kt = _view((5, 3, 2, 16, 128), BF16).transpose(2, 3)
    assert pa.route(q.contiguous(), kt, kt) == "ffma"


# a pool of P pages with L = 3 layers, read at layer 1; NULL is the last page
P, L, LAYER = 12, 3, 1
NULL = P - 1


def _pool(dtype, pg=4, Kh=2, Dh=16, seed=0):
    """K and V pools with NaN, ±Inf, a range-guard value (4e3) and a
    bit-pattern value (3.0) at layer 1 of referenced pages, of the NULL
    page and of an unreferenced page, and a NaN at layer 0."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((P, L, pg, Kh, Dh)).astype(np.float32)
    v = rng.standard_normal((P, L, pg, Kh, Dh)).astype(np.float32)
    k[2, 1, 1, 0, 3] = np.nan
    v[5, 1, 0, 1, 0] = np.inf
    k[3, 1, pg - 1, 1, 7] = -np.inf
    v[NULL, 1, 0, 0, 1] = np.nan
    k[NULL, 1, 2, 1, 2] = 4.0e3
    v[1, 1, 1, 0, 4] = 3.0
    k[4, 1, 0, 0, 5] = np.nan
    v[4, 1, 0, 1, 5] = -np.inf
    k[9, 1, 0, 0, 0] = np.nan             # unreferenced
    k[2, 0, 0, 0, 0] = np.nan             # another layer
    return (convert.to_torch(k).to(dtype), convert.to_torch(v).to(dtype))


# request 0: 5 real pages; 1: 3 then NULL; 2: 1 then NULL (every slot)
BT = np.array([[0, 2, 8, 3, 4, NULL], [5, 1, 10, NULL, NULL, NULL],
               [6, NULL, NULL, NULL, NULL, NULL]], np.int32)
QSTART = np.array([6, 2, 0], np.int32)


def _np_scan(k, v, bt, layer, include_inf, fill_inf):
    """numpy twin of the scan under the legacy detector: (slot_counts,
    counts, flags); bit 1 of the V flag where an Inf lane is left as it is
    (``include_inf`` off) or a fatal lane takes an infinite fill."""
    lanes = []
    for x in (k, v):
        a = x.float().numpy()[bt, layer]             # (B, M, pg, Kh, Dh)
        nan = np.isnan(a).sum(axis=(2, 3, 4))
        inf = np.isinf(a).sum(axis=(2, 3, 4))
        lanes.append((nan, inf if include_inf else 0 * nan, inf))
    (nk, ik, _), (nv, iv, all_iv) = lanes
    fk, fv = nk + ik, nv + iv
    poison = (all_iv > iv) | ((fv > 0) & fill_inf)
    counts = [nk.sum(), ik.sum(), (fk > 0).sum(), nv.sum(), iv.sum(),
              (fv > 0).sum(), ((fk + fv) > 0).sum(), 0]
    flags = np.stack([fk > 0, (fv > 0) | (poison << 1)], -1)
    return fk + fv, np.array(counts), flags.astype(np.int32)


@pytest.mark.parametrize("dtype", [F32, BF16, F16])
@pytest.mark.parametrize("include_inf", [True, False])
@pytest.mark.parametrize("fill_inf", [False, True])
def test_prefill_scan_plain_matches_numpy(dtype, include_inf, fill_inf):
    k, v = _pool(dtype)
    bt = torch.from_numpy(BT)
    fill = dict(policy_v="constant", constant_v=float("inf")) if fill_inf else {}
    slot_counts, counts, flags = pa.prefill_scan_plain(
        k, v, bt, LAYER, include_inf=include_inf, **fill)
    assert slot_counts.dtype == counts.dtype == flags.dtype == torch.int32
    assert tuple(flags.shape) == BT.shape + (2,)
    want = _np_scan(k, v, BT, LAYER, include_inf, fill_inf)
    for got, w in zip((slot_counts, counts, flags), want):
        np.testing.assert_array_equal(got.numpy(), w)
    # the NULL slots are visits, every one of them: request 2's five NULL
    # slots each carry the NULL page's V NaN
    assert flags[2, 1:, 1].tolist() == [3 if fill_inf else 1] * 5
    assert int(counts[pa.EV_TOTAL]) == int((slot_counts > 0).sum())
    # an Inf lane left as it is: request 1's slot 0 holds page 5's V Inf
    assert int(flags[1, 0, 1]) >> 1 == int(fill_inf or not include_inf)


def _detector_kwargs(kind, dtype):
    """(reference, port) detector kwargs of one kind."""
    if kind == "default":
        return {}, {}
    if kind == "off_k":
        return dict(detector_k=None), dict(detector_k=None)
    lay = detect.layout_of(dtype)
    three = int(detect.bits_of(torch.tensor([3.0], dtype=dtype))[0]) & ((1 << lay.width) - 1)
    spec = dict(max_magnitude=1e3, bitpatterns=((None, (1 << lay.width) - 1, three),))
    jd, td = jrules.Detector(**spec), rules.Detector(**spec)
    return dict(detector_k=jd, detector_v=jd), dict(detector_k=td, detector_v=td)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("kind", ["default", "custom", "off_k"])
def test_prefill_scan_counts_match_reference(dtype, kind):
    """Slot counts and AT counts of the scan's plain twin equal the Pallas
    kernel's and the plain prefill's, NULL and dead slots included."""
    k, v = _pool(dtype, seed=3)
    H, Dh = 4, 16
    rng = np.random.default_rng(4)
    q = convert.to_torch(rng.standard_normal((3, 5, H, Dh)).astype(np.float32)).to(dtype)
    jkw, tkw = _detector_kwargs(kind, dtype)
    _, jslot, jcnt = jpa.paged_prefill_raw(
        *(jnp.asarray(convert.to_numpy(x)).astype(JDT[dtype]) for x in (q, k, v)),
        jnp.asarray(BT), jnp.asarray(QSTART), jnp.asarray(LAYER, jnp.int32), **jkw)
    bt = torch.from_numpy(BT)
    slot_counts, counts, flags = pa.prefill_scan_plain(k, v, bt, LAYER, **tkw)
    np.testing.assert_array_equal(slot_counts.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcnt))
    _, pslot, pcnt = pa.paged_prefill_plain(q, k, v, bt, torch.from_numpy(QSTART),
                                            LAYER, **tkw)
    assert torch.equal(slot_counts, pslot) and torch.equal(counts, pcnt)
    assert int(counts[pa.EV_TOTAL]) > 0 and int(flags.sum()) > 0


@pytest.mark.parametrize("q_start,C,G,pg,M", [
    ([64, 16, 0, 0], 64, 6, 16, 8),
    ([28, 0, 0], 100, 6, 16, 8),
    ([0, 5, 300], 20, 2, 16, 16),
    ([176, 80], 64, 6, 48, 5),
    ([3], 48, 6, 4, 16),
])
def test_live_slots_rule(q_start, C, G, pg, M):
    """Each row block's live slots: the slots j with j·pg <= q_start + c
    for some chunk row c of the block's rows (brute force)."""
    got = pa.live_slots(q_start, C, G, pg, M)
    nb = -(-C * G // pa.WGMMA_ROWS)
    assert tuple(got.shape) == (len(q_start), nb)
    for b, qs in enumerate(q_start):
        for i in range(nb):
            rows = range(i * pa.WGMMA_ROWS, min((i + 1) * pa.WGMMA_ROWS, C * G))
            live = {j for j in range(M) for r in rows if j * pg <= qs + r // G}
            assert int(got[b, i]) == max(live) + 1 == len(live)
    if (q_start, C, G) == ([64, 16, 0, 0], 64, 6):
        assert got.tolist() == [[5, 6, 6, 7, 8, 8], [2, 3, 3, 4, 5, 5],
                                [1, 2, 2, 3, 4, 4], [1, 2, 2, 3, 4, 4]]
    # with the scan's flags: every slot up to the request's last one whose
    # V stays non-finite (bit 1 of the V flag; bit 0 alone extends nothing)
    flags = torch.zeros((len(q_start), M, 2), dtype=torch.int32)
    flags[0, M - 1, 1] = 1
    flags[-1, M // 2, 1] = 3
    flags[-1, 0, 1] = 2
    ext = pa.live_slots(q_start, C, G, pg, M, flags)
    assert torch.equal(ext[:-1], got[:-1])
    assert torch.equal(ext[-1], torch.clamp(got[-1], min=M // 2 + 1))


def _block_rows(out, i, G, Kh, C):
    """The rows of row block ``i`` of one request's (C, H, Dh) output, as
    the wgmma route groups them (per KV head, in (C, G) order), stacked."""
    rows = []
    for r in range(i * pa.WGMMA_ROWS, min((i + 1) * pa.WGMMA_ROWS, C * G)):
        c, g = divmod(r, G)
        rows += [out[c, kh * G + g] for kh in range(Kh)]
    return detect.bits_of(torch.stack(rows))


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("kind", ["repaired", "v_off", "inf_fill"])
def test_plain_restricted_to_live_slots_is_bit_identical(dtype, kind):
    """The plain prefill over only a row block's loaded slots gives that
    block's rows bit for bit: a slot masked for every row of the block
    leaves (m, l, acc) exactly as they were when its V is finite, so the
    wgmma route may skip it.  Its pages hold NaN and ±Inf.  ``repaired``:
    the detector repairs them.  ``v_off`` (V detection off) and
    ``inf_fill`` (an infinite V fill): V lanes stay non-finite and, through
    0 × NaN, reach rows that mask them; the loaded slots then reach the
    request's last such slot, and the causal slots alone would not do.
    There the NULL page's V NaN is cleared, so that the last such slot of
    request 0 is its slot 12 (page 4's V -Inf) and its blocks still skip
    slots 13-15."""
    C, H, Kh, Dh, pg = 48, 12, 2, 16, 4
    G = H // Kh
    k, v = _pool(dtype, pg=pg, Kh=Kh, Dh=Dh, seed=5)
    if kind != "repaired":
        v[NULL, LAYER, 0, 0, 1] = 0.0
    bt = torch.tensor([[0, 2, 8, 3, 4, 7, 1, NULL] * 2,
                       [5, 6, 10, NULL] + [NULL] * 12], dtype=torch.int32)
    M = bt.shape[1]
    qs = torch.tensor([3, 0], dtype=torch.int32)
    rng = np.random.default_rng(6)
    q = convert.to_torch(rng.standard_normal((2, C, H, Dh)).astype(np.float32)).to(dtype)
    kw = {"repaired": {}, "v_off": dict(detector_v=None),
          "inf_fill": dict(policy_v="constant", constant_v=float("inf"))}[kind]
    full = pa.paged_prefill_plain(q, k, v, bt, qs, LAYER, **kw)[0]
    flags = pa.prefill_scan_plain(k, v, bt, LAYER, **kw)[2]
    causal = pa.live_slots(qs, C, G, pg, M)
    loaded = pa.live_slots(qs, C, G, pg, M, flags)
    assert int(loaded.min()) < M                  # some block skips slots
    assert torch.equal(loaded, causal) == (kind == "repaired")
    assert bool(full.isfinite().all()) == (kind == "repaired")
    for b in range(2):
        for i, (n, n_causal) in enumerate(zip(loaded[b].tolist(),
                                              causal[b].tolist())):
            def part(n):
                return pa.paged_prefill_plain(q[b:b + 1], k, v, bt[b:b + 1, :n],
                                              qs[b:b + 1], LAYER, **kw)[0][0]
            want = _block_rows(full[b], i, G, Kh, C)
            assert torch.equal(_block_rows(part(n), i, G, Kh, C), want)
            if n > n_causal:
                assert not torch.equal(_block_rows(part(n_causal), i, G, Kh, C),
                                       want)
