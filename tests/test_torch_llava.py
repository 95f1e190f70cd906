"""Port parity of LLaVA-NeXT-Mistral-7B's patch prefix: the reduced twin
(``get_config("llava-next-mistral-7b").reduced()`` cut to 2 layers, f32,
untied head) against the reference's ``TransformerLM`` on the same weights
and the same patch and token arrays: ``forward``'s logits (the prefix runs
through the trunk, positions over P + S, and is dropped before the
readout), ``loss`` and every gradient (the loss over the tokens only), one
``build_train_step`` step at ``n_micro`` 1 and 2 (the microbatches slice
the patches too); and the port's own patch batches (``batch_for_step``,
``SyntheticStream``: shapes, dtype, determinism in (seed, step),
``host_slice``).

Both packages start from the reference's ``init_train_state``, carried
across by ``convert.train_state_from_jax``; the batches are the
reference's (the port's generator cannot draw threefry's bits), fed to
both as numpy.  Tolerances are ``tests/test_torch_train.py``'s f32 ones:
logits rtol = atol = 1e-4, the loss 1e-6, every gradient lane within 1e-5
of its leaf's largest |grad|, the moments within 1e-5 and the params
within 2 % of the step's learning rate.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import SyntheticStream as JStream  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.runtime import ApproxSpace as JApproxSpace  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.regions import flatten  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import TransformerLM  # noqa: E402
from repro_torch.runtime import ApproxSpace  # noqa: E402

ARCH = "llava-next-mistral-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = 1e-5
MOMENT_TOL = 1e-5
PARAM_LR_SHARE = 2e-2
BATCH, SEQ = 4, 32              # P = int(32 · 0.125) = 4 patch rows, 28 tokens
LR = dict(peak_lr=3e-3, warmup=5, total=30)


def cfgs(**over):
    kw = {"n_layers": 2, "remat": False, **over}
    return (dataclasses.replace(jget_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


@pytest.fixture(scope="module")
def ref():
    """The reference's model, optimizer and train state (one init for the
    module), and its first two patch batches as numpy."""
    jcfg, _ = cfgs()
    jm = jbuild(jcfg)
    jopt = jtrain.make_optimizer(**LR)
    js = jtrain.init_train_state(jm, jopt, jax.random.PRNGKey(0),
                                 space=JApproxSpace(jcfg.repair))
    stream = JStream(jcfg, seed=0, batch=BATCH, seq=SEQ)
    batches = [jax.tree.map(np.asarray, stream(i)) for i in range(2)]
    return jm, jopt, jax.tree.map(np.asarray, js), batches


def _port(ref, **over):
    """A fresh port model and train state from the reference's state."""
    tcfg = cfgs(**over)[1]
    return convert.train_state_from_jax(ref[2], tcfg, device="cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_reference_batch_has_the_prefix(ref):
    batch = ref[3][0]
    assert batch["tokens"].shape == (BATCH, SEQ - 4)
    assert batch["patch_embeds"].shape == (BATCH, 4, 128)
    assert batch["patch_embeds"].dtype == np.float32


def test_forward_matches_reference(ref):
    """Logits of the tokens alone, (B, S - P, V), with the prefix in the
    trunk; another prefix changes them."""
    jm, _, js, batches = ref
    tm, _ = _port(ref)
    batch = batches[0]
    want = np.asarray(jax.jit(jm.forward)(js["params"], jax.tree.map(jnp.asarray, batch)))
    tb = _torch_batch(batch)
    got = tm(tb["tokens"], patch_embeds=tb["patch_embeds"])
    assert got.shape == (BATCH, SEQ - 4, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    other = tm(tb["tokens"], patch_embeds=tb["patch_embeds"] + 1.0)
    assert not torch.allclose(other, got, **TOL)
    # without a prefix the positions start at the first token
    bare = np.asarray(jax.jit(jm.forward)(js["params"], {"tokens": jnp.asarray(batch["tokens"])}))
    np.testing.assert_allclose(tm(tb["tokens"]).numpy(), bare, **TOL)


def _port_grads(tm, batch):
    grads = tm.bind_grads()
    for g in grads.values():
        g.zero_()
    loss, metrics = tm.loss(_torch_batch(batch))
    loss.backward()
    return loss.detach(), metrics, grads


def test_loss_and_every_grad_match_reference(ref):
    jm, _, js, batches = ref
    tm, _ = _port(ref)
    batch = batches[1]

    def jloss(p):
        return jm.loss(p, jax.tree.map(jnp.asarray, batch))

    (jl, jmet), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, js["params"]))
    loss, metrics, grads = _port_grads(tm, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    assert float(metrics["tokens"]) == float(jmet["tokens"]) == BATCH * (SEQ - 4 - 1)
    np.testing.assert_allclose(float(metrics["accuracy"]), float(jmet["accuracy"]),
                               rtol=1e-6)
    want = flatten(jax.tree.map(np.asarray, jg))
    assert list(grads) == list(want)
    for path, w in want.items():
        err = np.abs(grads[path].numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL, (path, err)


def test_remat_carries_the_prefix(ref):
    """The recomputed trunk sees the same prefix: remat on and off give the
    same gradients, bit for bit."""
    batch = ref[3][1]
    out = []
    for remat in (False, True):
        tm, _ = _port(ref, remat=remat)
        out.append(_port_grads(tm, batch)[2])
    for path in out[0]:
        assert torch.equal(out[0][path], out[1][path]), path


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(ref, n_micro):
    """One memory-mode step on a patch batch (the boundary scrub, the
    backward, AdamW): the loss, the gradient norm and the state after it."""
    jm, jopt, js, batches = ref
    jcfg = jm.cfg
    jstep = jax.jit(jtrain.build_train_step(jm, jopt, n_micro=n_micro,
                                            space=JApproxSpace(jcfg.repair)))
    tm, ts = _port(ref)
    tstep = ttrain.build_train_step(tm, ttrain.make_optimizer(**LR),
                                    n_micro=n_micro, space=ApproxSpace(tm.cfg.repair))
    batch = batches[0]
    js2, jmet = jstep(jax.tree.map(jnp.asarray, js), jax.tree.map(jnp.asarray, batch))
    ts, tmet = tstep(ts, _torch_batch(batch))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                               rtol=1e-5)
    lr = float(jmet["lr"])
    want = flatten(jax.tree.map(np.asarray, {
        "params": js2["params"], "opt": {"mu": js2["opt"].mu, "nu": js2["opt"].nu}}))
    for path, w in want.items():
        got = ts[path].detach().numpy()
        if path.startswith("opt/"):
            err = np.abs(got - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= MOMENT_TOL, (path, err)
        else:
            assert np.abs(got - w).max() <= PARAM_LR_SHARE * lr, path
    assert int(ts["opt/step"]) == 1
    assert ts["stats"] == {k: int(v) for k, v in js2["stats"].items()}


# --------------------------------------------------------- the port's batches

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_patch_batches(dtype):
    """``batch_for_step`` of a patch-prefix config: ``P = int(seq ·
    frontend_fraction)`` standard-normal rows in the config's dtype before
    ``seq - P`` tokens, a pure function of (seed, step); the tokens are
    the tokens-only draw at ``seq - P``; ``SyntheticStream`` slices both
    keys per process."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype_name=dtype)
    b = pipeline.batch_for_step(cfg, 3, 5, batch=4, seq=64, device="cpu")
    assert set(b) == {"tokens", "patch_embeds"}
    assert b["tokens"].shape == (4, 56) and b["tokens"].dtype == torch.int32
    assert b["patch_embeds"].shape == (4, 8, 128)
    assert b["patch_embeds"].dtype == cfg.dtype
    pe = b["patch_embeds"].float()
    assert abs(float(pe.mean())) < 0.1 and abs(float(pe.std()) - 1.0) < 0.1
    again = pipeline.batch_for_step(cfg, 3, 5, batch=4, seq=64, device="cpu")
    for k in b:
        assert torch.equal(b[k], again[k]), k
    other = pipeline.batch_for_step(cfg, 3, 6, batch=4, seq=64, device="cpu")
    assert not torch.equal(b["patch_embeds"], other["patch_embeds"])
    plain = dataclasses.replace(cfg, frontend="none")
    assert torch.equal(b["tokens"], pipeline.batch_for_step(
        plain, 3, 5, batch=4, seq=56, device="cpu")["tokens"])
    halves = [pipeline.SyntheticStream(cfg, 3, 4, 64, process_index=i,
                                       process_count=2, device="cpu")(5)
              for i in range(2)]
    for k in b:
        assert torch.equal(torch.cat([h[k] for h in halves]), b[k]), k
        assert halves[1][k].shape[0] == 2


def test_port_batch_trains(ref):
    """The port's own patch batch runs through ``train_loop`` (device move,
    the boundary scrub, two steps): finite losses."""
    tm, ts = _port(ref)
    stream = pipeline.SyntheticStream(tm.cfg, 0, 2, SEQ, device="cpu")
    _, history = ttrain.train_loop(tm, ttrain.make_optimizer(**LR), stream,
                                   steps=2, state=ts, log_every=1)
    assert len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)


def test_audio_batches_still_raise():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), family="audio",
                              frontend="frames")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipeline.batch_for_step(cfg, 0, 0, batch=1, seq=8, device="cpu")
    assert isinstance(TransformerLM(cfgs()[1], device="cpu"), TransformerLM)
