"""The plain versions the f32 paged routes are held against on the card,
against the reference's Pallas kernels in interpret mode, on the CPU.

The pool is tiny and shaped as StableLM-1.6B's: four KV heads of one query
head each (G = 1), NaN and ±Inf planted in live pages, in pages past the
positions and in the NULL page's K (its V stays finite, so that with V
detection off each request's poisoned slots end before its last one).

* ``paged_decode_heads_plain``, the plain twin of the heads decode route's
  partition (``heads_partition``: four KV heads, so each request's twelve
  slots go to six blocks of two), against ``paged_attention_raw``.
* ``prefill_scan_plain`` in f32, on contiguous pools and on views 4 bytes
  into their storage (the FFMA route takes offset views), against the
  counts of ``paged_prefill_raw``.
* ``live_slots`` at the FFMA route's 32-row blocks with the scan's
  poison_end: the plain prefill over a block's loaded slots gives that
  block's rows bit for bit, and the whole prefill agrees with the
  reference.

Tolerances as in ``tests/test_torch_decode_route.py`` (f32 1e-4: the
partitions sum in other orders); integer outputs equal.  The reference
runs once per configuration, in a module-scoped fixture.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import paged_attention as jpa  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import detect  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402

P, L, LAYER, PG, KH, DH = 14, 2, 1, 4, 4, 16
H = KH                                   # G = 1
NULL = P - 1
M, C = 12, 40                            # decode slots; prefill rows (two blocks)
# request 0: ten real pages; 1: four, then NULL; 2: one, then NULL
BT = np.array([[0, 2, 8, 3, 4, 7, 1, 6, 10, 9, NULL, NULL],
               [5, 1, 11, 3] + [NULL] * 8,
               [12] + [NULL] * 11], np.int32)
POS = np.array([9 * PG - 2, 3 * PG - 1, 2], np.int32)
QSTART = np.array([2, 0, 1], np.int32)
KINDS = {"default": {}, "v_off": dict(detector_v=None)}
TOL = 1e-4


def _pools():
    rng = np.random.default_rng(7)
    k = rng.standard_normal((P, L, PG, KH, DH)).astype(np.float32)
    v = rng.standard_normal((P, L, PG, KH, DH)).astype(np.float32)
    k[2, LAYER, 1, 0, 3] = np.nan          # live
    v[5, LAYER, 0, 1, 0] = np.inf          # live
    k[3, LAYER, PG - 1, 3, 7] = -np.inf    # live for request 0
    v[8, LAYER, 2, 2, 6] = -np.inf         # live
    k[9, LAYER, 0, 1, 5] = np.nan          # past request 0's position
    v[9, LAYER, 3, 0, 2] = np.inf          # past it
    k[NULL, LAYER, 0, 3, 1] = np.nan       # the NULL page
    k[2, 0, 0, 0, 0] = np.nan              # the other layer
    return k, v


def _ref(x):
    return jnp.asarray(x)


@pytest.fixture(scope="module")
def case():
    """The operands (numpy) and the reference's outputs per kind."""
    k, v = _pools()
    rng = np.random.default_rng(8)
    q = rng.standard_normal((3, H, DH)).astype(np.float32)
    qc = rng.standard_normal((3, C, H, DH)).astype(np.float32)
    ref = {}
    for kind, kw in KINDS.items():
        dec = jpa.paged_attention_raw(_ref(q), _ref(k), _ref(v), _ref(BT),
                                      _ref(POS), jnp.asarray(LAYER, jnp.int32),
                                      **kw)
        pre = jpa.paged_prefill_raw(_ref(qc), _ref(k), _ref(v), _ref(BT),
                                    _ref(QSTART), jnp.asarray(LAYER, jnp.int32),
                                    **kw)
        ref[kind] = [[torch.from_numpy(np.array(x)) for x in out]
                     for out in (dec, pre)]
    return dict(k=k, v=v, q=q, qc=qc, ref=ref)


def _torch(*xs):
    return [convert.to_torch(x) for x in xs]


def _same_nonfinite_and_close(got, want):
    fin = want.isfinite()
    assert torch.equal(got.isfinite(), fin)
    torch.testing.assert_close(got[fin], want[fin], rtol=TOL, atol=TOL)
    both_inf = got.isinf() & want.isinf()
    assert torch.equal(got[both_inf], want[both_inf])


def _at_offset(x, off=1):
    """``x`` copied into a view ``off`` elements into its storage."""
    buf = torch.empty(x.numel() + off, dtype=x.dtype)
    view = buf[off:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("M_,Kh,want", [
    (M, KH, (6, 2)), (8, 32, (4, 2)),                 # StableLM-1.6B's pool
    (8, 4, (8, 1)), (8, 132, (1, 8)), (1, 2, (1, 1)), (20, 2, (7, 3)),
    (100, 1, (8, 13)),
])
def test_heads_partition(M_, Kh, want):
    """Each KV head's M slots in nb blocks of spb consecutive slots (the
    last possibly shorter, none empty, at most eight: one cluster), split
    into about HEADS_MIN_BLOCKS / Kh groups where M allows: StableLM-1.6B's
    32 KV heads take 4 blocks of 2 slots (128 blocks a request), four KV
    heads 8 of 1, 132 KV heads none."""
    nb, spb = pa.heads_partition(M_, Kh)
    assert (nb, spb) == want
    assert 1 <= nb <= pa.FUSED_MAX_CLUSTER and (nb - 1) * spb < M_ <= nb * spb


@pytest.mark.parametrize("kind", list(KINDS))
def test_heads_twin_matches_reference(case, kind):
    """Slot counts and AT counts equal the Pallas kernel's; outputs within
    1e-4, non-finite lanes where the reference's are (V detection off: a
    V lane past the position reaches its KV head's output through 0 ×
    NaN)."""
    k, v, q = _torch(case["k"], case["v"], case["q"])
    jout, jslot, jcnt = case["ref"][kind][0]
    out, slot, cnt = pa.paged_decode_heads_plain(
        q, k, v, torch.from_numpy(BT), torch.from_numpy(POS), LAYER,
        **KINDS[kind])
    assert torch.equal(slot, jslot.to(torch.int32))
    assert torch.equal(cnt, jcnt.to(torch.int32))
    assert int(cnt[pa.EV_TOTAL]) > 0
    _same_nonfinite_and_close(out, jout)
    assert bool(out.isfinite().all()) == (kind == "default")


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("offset", [0, 1])
def test_scan_plain_f32_matches_reference(case, kind, offset):
    """The scan's plain twin in f32, on the pools and on views of them one
    lane into their storage: slot counts and AT counts equal the
    reference prefill's, the flags mark exactly the slots with fatal
    lanes, and bit 1 of V marks the slots whose V stays non-finite."""
    k, v = _torch(case["k"], case["v"])
    if offset:
        k, v = _at_offset(k), _at_offset(v)
        assert k.storage_offset() == v.storage_offset() == 1
    _, jslot, jcnt = case["ref"][kind][1]
    slot, cnt, flags = pa.prefill_scan_plain(k, v, torch.from_numpy(BT), LAYER,
                                             **KINDS[kind])
    assert torch.equal(slot, jslot.to(torch.int32))
    assert torch.equal(cnt, jcnt.to(torch.int32))
    assert torch.equal((flags[..., 0] | flags[..., 1]) & 1, (slot > 0).int())
    poison = (flags[..., 1] >> 1) & 1
    assert bool(poison.any()) == (kind == "v_off")


@pytest.mark.parametrize("kind", list(KINDS))
def test_ffma_live_slots_give_each_block_its_rows(case, kind):
    """Each FFMA row block (32 of one KV head's C·G rows) loads the slots
    ``live_slots(..., rows=FFMA_ROWS)`` gives with the scan's flags; the
    plain prefill over those slots alone is that block's rows bit for bit,
    and the whole prefill is within 1e-4 of the reference, non-finite
    where it is."""
    k, v, qc = _torch(case["k"], case["v"], case["qc"])
    bt, qs = torch.from_numpy(BT), torch.from_numpy(QSTART)
    kw = KINDS[kind]
    full = pa.paged_prefill_plain(qc, k, v, bt, qs, LAYER, **kw)[0]
    _same_nonfinite_and_close(full, case["ref"][kind][1][0])
    flags = pa.prefill_scan_plain(k, v, bt, LAYER, **kw)[2]
    loaded = pa.live_slots(qs, C, 1, PG, M, flags, rows=pa.FFMA_ROWS)
    causal = pa.live_slots(qs, C, 1, PG, M, rows=pa.FFMA_ROWS)
    assert loaded.shape == (3, 2) and int(loaded.min()) < M
    assert torch.equal(loaded, causal) == (kind == "default")
    for b in range(3):
        for i, n in enumerate(loaded[b].tolist()):
            part = pa.paged_prefill_plain(qc[b:b + 1], k, v, bt[b:b + 1, :n],
                                          qs[b:b + 1], LAYER, **kw)[0][0]
            rows = slice(i * pa.FFMA_ROWS, (i + 1) * pa.FFMA_ROWS)
            assert torch.equal(detect.bits_of(part[rows]),
                               detect.bits_of(full[b, rows]))
