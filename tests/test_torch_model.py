"""Port parity of the model's paged paths: ``serve_step_paged`` and
``prefill_paged`` on the serving tests' tiny Qwen2 shapes, with the
reference's parameters carried across by ``params_from_jax`` and the same
pool (faults planted) on both sides.  Slot and AT counts must be identical;
logits and the pool after the K/V writes agree within rtol = atol = 1e-4
(f32 throughout; XLA and PyTorch sum the projections in different orders,
and two layers compound it)."""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import tiny_transformer  # noqa: E402
from repro.core import rules as jrules  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, to_torch  # noqa: E402
from repro_torch.core import rules  # noqa: E402
from repro_torch.runtime import ApproxConfig  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
P, PG, M = 9, 4, 4


def tiny_cfg():
    """The port's twin of ``conftest.tiny_transformer``'s config."""
    return dataclasses.replace(
        get_config("qwen2-1.5b").reduced(),
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=97, repair=ApproxConfig(mode="off"),
    )


@pytest.fixture(scope="module")
def models():
    jm, jp = tiny_transformer()
    tm = params_from_jax(jax.tree.map(np.asarray, jp), tiny_cfg(), device="cpu")
    return jm, jp, tm


def _pool(seed):
    rng = np.random.default_rng(seed)
    shape = (P, 2, PG, 2, 16)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    k[1, 0, 2, 1, 5] = np.nan
    v[3, 1, 0, 0, 0] = np.inf
    v[P - 1, 1, 1, 1, 1] = np.nan          # null page
    k[2, 1, 3, 0, 4] = 5.0e3               # range guard only
    return k, v


def _pools(seed):
    k, v = _pool(seed)
    jpool = {"layers": {"k": jnp.asarray(k), "v": jnp.asarray(v)}}
    tpool = {"layers/k": to_torch(k), "layers/v": to_torch(v)}
    return jpool, tpool


def _spec(kind):
    if kind == "default":
        det = dict(k=jrules.Detector(), v=jrules.Detector())
        tdet = dict(k=rules.Detector(), v=rules.Detector())
        fills = {"k": ("zero", 0.0), "v": ("zero", 0.0)}
    else:
        det = dict(k=jrules.Detector(max_magnitude=1e3), v=None)
        tdet = dict(k=rules.Detector(max_magnitude=1e3), v=None)
        fills = {"k": ("constant", 0.25), "v": ("zero", 0.0)}
    return det, tdet, fills


def _check_pools(jpool, tpool):
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tpool[f"layers/{name}"].numpy(), np.asarray(jpool["layers"][name]), **TOL)


@pytest.mark.parametrize("split_k", [1, 2])
@pytest.mark.parametrize("kind", ["default", "range_k_off_v"])
def test_serve_step_paged_matches_reference(models, split_k, kind):
    jm, jp, tm = models
    jpool, tpool = _pools(0)
    bt = np.array([[0, 1, 2, P - 1], [3, 4, P - 1, P - 1], [P - 1] * 4], np.int32)
    pos = np.array([9, 5, 0], np.int32)
    tokens = np.array([[5], [17], [0]], np.int32)
    det, tdet, fills = _spec(kind)
    jl, jpool, jslot, jcnt = jm.serve_step_paged(
        jp, jpool, {"tokens": jnp.asarray(tokens)}, jnp.asarray(bt),
        jnp.asarray(pos), detectors=det, fills=fills, split_k=split_k)
    tl, tslot, tcnt = tm.serve_step_paged(
        tpool, torch.from_numpy(tokens), torch.from_numpy(bt),
        torch.from_numpy(pos), detectors=tdet, fills=fills, split_k=split_k)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_pools(jpool, tpool)


@pytest.mark.parametrize("kind", ["default", "range_k_off_v"])
def test_prefill_paged_matches_reference(models, kind):
    """A padded chunk (q_len < C): the padding rows re-write the last valid
    position, so the pool stays identical and no flip is healed."""
    jm, jp, tm = models
    jpool, tpool = _pools(1)
    bt = np.array([[5, 6, 7, P - 1]], np.int32)
    tokens = np.array([[3, 9, 27, 81 % 97, 4, 0, 0]], np.int32)
    q_start, q_len = np.array([2], np.int32), np.array([5], np.int32)
    det, tdet, fills = _spec(kind)
    jl, jpool, jslot, jcnt = jm.prefill_paged(
        jp, jpool, {"tokens": jnp.asarray(tokens)}, jnp.asarray(bt),
        jnp.asarray(q_start), jnp.asarray(q_len), detectors=det, fills=fills)
    tl, tslot, tcnt = tm.prefill_paged(
        tpool, torch.from_numpy(tokens), torch.from_numpy(bt),
        torch.from_numpy(q_start), torch.from_numpy(q_len),
        detectors=tdet, fills=fills)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(tl[:, :5].numpy(), np.asarray(jl)[:, :5], **TOL)
    _check_pools(jpool, tpool)


def test_params_carry_across_and_init_scheme(models):
    jm, jp, tm = models
    np.testing.assert_array_equal(tm.layers[1].attn.wq.numpy(),
                                  np.asarray(jp["layers"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(tm.embed.table.numpy(),
                                  np.asarray(jp["embed"]["table"]))
    from repro_torch.models import TransformerLM

    fresh = TransformerLM(tiny_cfg(), device="cpu", seed=0)
    again = TransformerLM(tiny_cfg(), device="cpu", seed=0)
    for (n, a), (_, b) in zip(fresh.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), n                    # seeded: reproducible
    assert torch.all(fresh.layers[0].norm1.scale == 1)
    assert torch.all(fresh.layers[0].attn.bq == 0)
    std = fresh.layers[0].mlp.w_down.std().item()      # fan-in 128
    assert abs(std - 128 ** -0.5) < 0.01
    assert abs(fresh.embed.table.std().item() - 0.02) < 0.004


def test_unported_families_raise():
    from repro_torch.models import build_model

    cfg = dataclasses.replace(tiny_cfg(), family="audio")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, device="cpu")
