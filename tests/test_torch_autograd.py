"""The port under autograd: the CUDA kernel wrappers refuse inputs that
require grad (a kernel writes raw device memory and has no backward, so
its result would silently leave the graph), ``matmul_f32``'s backward
on the card keeps the f32 cotangent (and ``bmm_f32``, its batched twin,
agrees with it), the MoE block on the card routes as on the CPU, the
xLSTM's loss and gradients on the
card match the CPU's, LLaVA's and Zamba's full-width bf16 forwards are
finite and their f32 cuts match the CPU (LLaVA's loss and gradients on a
patch batch, Zamba's ``generate`` under a planted fault), and a checkpoint of card tensors (the save scrub on
the card) round-trips.

The guard's own test runs on the CPU; one test per wrapper, and the
backward check, need the card (marked ``cuda``) and skip without one.  The
file imports neither JAX nor the reference, so on the card it runs as

    python -m pytest --noconftest -q tests/test_torch_autograd.py
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import common, scrub, tile_fill  # noqa: E402
from repro_torch.kernels import mlstm_chunk as mc  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import repair_attention as ra  # noqa: E402
from repro_torch.kernels import repair_matmul as rm  # noqa: E402
from repro_torch.nn import moe  # noqa: E402
from repro_torch.nn.layers import bmm_f32, matmul_f32  # noqa: E402

NO_BACKWARD = "no backward"


def test_the_guard_refuses_grad_inputs_only_in_grad_mode():
    x = torch.randn(4, requires_grad=True)
    plain = torch.randn(4)
    with pytest.raises(RuntimeError, match=NO_BACKWARD):
        common.refuse_autograd("op", plain, x)
    with torch.no_grad():
        common.refuse_autograd("op", plain, x)
    common.refuse_autograd("op", plain, x.detach(), None,
                           torch.zeros(3, dtype=torch.int32))
    # the CPU route is the plain version, which autograd differentiates
    assert common.require_device(x, "op", x) == "cpu"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _pool(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    k = torch.randn((9, 2, 4, 2, 16), generator=gen, device=dev)
    return k, k.clone()


def _refused_then_runs(call, grad_input):
    """``call`` raises with ``grad_input`` requiring grad, and runs on the
    same values under ``torch.no_grad()``."""
    grad_input.requires_grad_(True)
    with pytest.raises(RuntimeError, match=NO_BACKWARD):
        call()
    with torch.no_grad():
        call()
    grad_input.requires_grad_(False)


@pytest.mark.cuda
def test_scrub_refuses_autograd(cuda):
    x = torch.randn(64, 64, device=cuda)
    _refused_then_runs(lambda: scrub.scrub(x), x)


@pytest.mark.cuda
def test_scrub_pages_refuses_autograd(cuda):
    x = torch.randn(4, 8, 16, device=cuda)
    _refused_then_runs(lambda: scrub.scrub_pages(x, [0, 2]), x)


@pytest.mark.cuda
def test_paged_decode_refuses_autograd(cuda):
    k, v = _pool(cuda)
    q = torch.randn((3, 4, 16), device=cuda)
    bt = torch.tensor([[0, 2, 8, 8], [5, 3, 1, 8], [8, 8, 8, 8]],
                      dtype=torch.int32, device=cuda)
    pos = torch.tensor([9, 13, 0], dtype=torch.int32, device=cuda)
    _refused_then_runs(lambda: pa.paged_attention_raw(q, k, v, bt, pos, 1), q)
    _refused_then_runs(lambda: pa.paged_attention_raw(q, k, v, bt, pos, 1), v)


@pytest.mark.cuda
def test_paged_prefill_refuses_autograd(cuda):
    k, v = _pool(cuda)
    q = torch.randn((3, 6, 4, 16), device=cuda)
    bt = torch.tensor([[0, 2, 8, 8], [5, 3, 1, 8], [8, 8, 8, 8]],
                      dtype=torch.int32, device=cuda)
    qs = torch.tensor([4, 8, 0], dtype=torch.int32, device=cuda)
    _refused_then_runs(lambda: pa.paged_prefill_raw(q, k, v, bt, qs, 1), k)


@pytest.mark.cuda
def test_repair_matmul_refuses_autograd(cuda):
    a = torch.randn(64, 128, device=cuda, dtype=torch.bfloat16)
    b = torch.randn(128, 64, device=cuda, dtype=torch.bfloat16)
    _refused_then_runs(lambda: rm.repair_matmul_raw(a, b), b)


@pytest.mark.cuda
def test_flash_attention_refuses_autograd(cuda):
    q = torch.randn(1, 4, 128, 64, device=cuda, dtype=torch.bfloat16)
    k = torch.randn(1, 2, 128, 64, device=cuda, dtype=torch.bfloat16)
    v = torch.randn(1, 2, 128, 64, device=cuda, dtype=torch.bfloat16)
    _refused_then_runs(lambda: ra.flash_attention_raw(q, k, v), q)


@pytest.mark.cuda
def test_mlstm_chunk_refuses_autograd(cuda):
    shape = (1, 2, 2, 16, 32)
    q, k, v = (torch.randn(shape, device=cuda) for _ in range(3))
    li = torch.randn(shape[:4], device=cuda)
    lf = torch.nn.functional.logsigmoid(torch.randn(shape[:4], device=cuda))
    _refused_then_runs(lambda: mc.mlstm_chunk_raw(q, k, v, li, lf), lf)


@pytest.mark.cuda
def test_tile_fill_refuses_autograd(cuda):
    x = torch.randn(96, 640, device=cuda)
    consts = common.detector_operand(common.resolve_detector(None, True),
                                     torch.float32)
    _refused_then_runs(
        lambda: tile_fill.tile_fill(x, 96, 640, (32, 64), consts), x)


def _bwd_bar(got, exact, mag, k: int):
    """bf16 ``got`` against the f64 ``exact`` whose terms' magnitudes sum to
    ``mag``, over ``k`` terms: (lanes beyond one bf16 ulp plus the f32
    sum's own error, sqrt(k) · 2^-24 · mag; share of lanes other than
    ``exact`` rounded once)."""
    ax = exact.abs()
    ulp = torch.where(ax > 0, torch.exp2(torch.floor(torch.log2(ax)) - 7),
                      torch.zeros_like(ax))
    allow = ulp + k ** 0.5 * 2.0 ** -24 * mag
    beyond = int(((got.double() - exact).abs() > allow).sum())
    return beyond, float((got != exact.to(torch.bfloat16)).float().mean())


@pytest.mark.cuda
def test_matmul_f32_backward_on_the_card(cuda):
    """bf16 gradients on the card within one ulp of the f64 products (plus
    the f32 sum's error where the sum cancels), at most 1 % of lanes other
    than the f64 product rounded once; the control that rounds the
    cotangent to bf16 first fails the same bar."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((2, 256, 512), generator=gen, device=cuda).bfloat16()
    w = (torch.randn((512, 384), generator=gen, device=cuda) / 16).bfloat16()
    g = torch.randn((2, 256, 384), generator=gen, device=cuda)
    a.requires_grad_(True)
    w.requires_grad_(True)
    matmul_f32(a, w).backward(g)
    g64 = g.double().reshape(-1, 384)
    a64, w64 = a.detach().double().reshape(-1, 512), w.detach().double()
    exact_a, mag_a = g64 @ w64.t(), g64.abs() @ w64.abs().t()
    exact_w, mag_w = a64.t() @ g64, a64.abs().t() @ g64.abs()
    for got, exact, mag, k in ((a.grad.reshape(-1, 512), exact_a, mag_a, 384),
                               (w.grad, exact_w, mag_w, 512)):
        beyond, share = _bwd_bar(got, exact, mag, k)
        assert beyond == 0 and share <= 1e-2, (beyond, share)
    ctrl = g.bfloat16().reshape(-1, 384) @ w.detach().t()
    beyond, share = _bwd_bar(ctrl, exact_a, mag_a, 384)
    assert beyond > 0 or share > 1e-2, (beyond, share)


@pytest.mark.cuda
def test_bmm_f32_on_the_card_matches_matmul_f32(cuda):
    """``bmm_f32`` on bf16 operands (one ``torch.bmm`` with an f32
    result) against ``matmul_f32`` a batch at a time: the product and both
    gradients within the f32 sums' error, K·2^-24·(|a|@|b|) for the
    product and one bf16 ulp for the rounded gradients."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randn((4, 48, 512), generator=gen, device=cuda).bfloat16()
    b = (torch.randn((4, 512, 384), generator=gen, device=cuda) / 16).bfloat16()
    g = torch.randn((4, 48, 384), generator=gen, device=cuda)
    a.requires_grad_(True)
    b.requires_grad_(True)
    out = bmm_f32(a, b)
    assert out.dtype == torch.float32
    out.backward(g)
    for e in range(4):
        ae = a.detach()[e].clone().requires_grad_(True)
        be = b.detach()[e].clone().requires_grad_(True)
        oe = matmul_f32(ae, be)
        oe.backward(g[e])
        mag = ae.detach().float().abs() @ be.detach().float().abs()
        assert bool(((out[e].detach() - oe.detach()).abs()
                     <= 512 * 2.0 ** -24 * mag).all())
        for got, want in ((a.grad[e], ae.grad), (b.grad[e], be.grad)):
            assert bool(((got.float() - want.float()).abs()
                         <= 2.0 ** -7 * want.float().abs() + 1e-6).all())


@pytest.mark.cuda
def test_moe_on_the_card_matches_the_cpu(cuda):
    """The reduced Qwen3-MoE block in bf16 (16 experts, top 8) on the card
    and on the CPU on the same weights and inputs, a NaN lane in one
    hidden row: equal expert ids and kept slots (NaN row: experts 0…7),
    the NaN row NaN, the others within 2e-2 of the CPU's (bf16 outputs
    whose f32 sums run in different orders)."""
    torch.backends.cuda.matmul.allow_tf32 = False        # the router's f32 logits
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    kw = dict(dtype=torch.bfloat16)
    gpu = moe.MoE(cfg.d_model, cfg.d_ff, 16, 8, device=cuda, **kw)
    cpu = moe.MoE(cfg.d_model, cfg.d_ff, 16, 8, device="cpu", **kw)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for (n, p), (_, q) in zip(gpu.named_parameters(), cpu.named_parameters()):
            q.copy_(torch.randn(q.shape, generator=gen) * 0.1)
            p.copy_(q)
        x = torch.randn((3, 5, cfg.d_model), generator=gen).bfloat16()
        x[1, 2, 7] = float("nan")
        out, _ = gpu(x.to(cuda))
        want, _ = cpu(x)
        ids = [m.route(t)[1] for m, t in ((gpu, x.to(cuda)), (cpu, x))]
    assert torch.equal(ids[0].cpu(), ids[1])
    assert ids[1][1, 2].tolist() == list(range(8))
    assert torch.equal(moe.slots(ids[0], 16, gpu.capacity(5))[1].cpu(),
                       moe.slots(ids[1], 16, cpu.capacity(5))[1])
    out = out.cpu().float()
    assert bool(torch.isnan(out[1, 2]).all())
    out[1, 2] = want[1, 2] = 0.0
    assert float((out - want.float()).abs().max()) <= 2e-2


@pytest.mark.cuda
def test_xlstm_loss_and_grads_on_the_card(cuda):
    """The reduced xLSTM (f32, TF32 off, remat on) on the card against the
    same weights on the CPU: the loss within 1e-5 relative and every
    gradient within 1e-4 of its norm; the trunk runs no kernel (the train
    path is the plain chunked mLSTM under autograd)."""
    from repro_torch.models import XLSTMLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("xlstm-1.3b").reduced()
    cpu, card = XLSTMLM(cfg, device="cpu", seed=0), XLSTMLM(cfg, device=cuda, seed=1)
    with torch.no_grad():
        for path, t in card.param_tree().items():
            t.copy_(cpu.param_tree()[path])
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(0))
    out = []
    common.reset_launches()
    for m in (card, cpu):
        grads = m.bind_grads()
        loss, _ = m.loss({"tokens": tokens.to(m.device)})
        loss.backward()
        out.append((float(loss.detach()), {p: g.cpu() for p, g in grads.items()}))
    assert not common.LAUNCHES
    assert abs(out[0][0] - out[1][0]) <= 1e-5 * abs(out[1][0])
    for path, want in out[1][1].items():
        got = out[0][1][path]
        assert torch.isfinite(got).all(), path
        err = float((got - want).norm() / want.norm().clamp_min(1e-30))
        assert err <= 1e-4, (path, err)


def _card_cpu_pair(cls, cfg, cuda):
    """``cls(cfg)`` on the card and on the CPU with the card's weights."""
    card, cpu = cls(cfg, device=cuda, seed=0), cls(cfg, device="cpu", seed=1)
    with torch.no_grad():
        for path, t in cpu.param_tree().items():
            t.copy_(card.param_tree()[path].cpu())
    return card, cpu


@pytest.mark.cuda
def test_llava_on_the_card(cuda):
    """LLaVA-NeXT-Mistral-7B at full width in bf16: the forward over 16
    patch rows and 48 tokens gives finite logits of the tokens alone; cut
    to 2 layers in f32 (TF32 off), the loss of a patch batch within 1e-5
    of the CPU's and every gradient within 1e-4 of its norm."""
    import dataclasses

    from repro_torch.data import SyntheticStream
    from repro_torch.models import TransformerLM

    cfg = get_config("llava-next-mistral-7b")
    model = TransformerLM(cfg, device=cuda, seed=0)
    gen = torch.Generator(device=cuda).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (1, 48), generator=gen, device=cuda)
    patches = torch.randn((1, 16, cfg.d_model), generator=gen, device=cuda).bfloat16()
    logits = model(tokens, patch_embeds=patches)
    assert logits.shape == (1, 48, cfg.vocab) and bool(torch.isfinite(logits).all())
    del model, logits
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    card, cpu = _card_cpu_pair(
        TransformerLM, dataclasses.replace(cfg, n_layers=2, dtype_name="float32"), cuda)
    batch = SyntheticStream(cpu.cfg, seed=1, batch=1, seq=64, device="cpu")(0)
    out = []
    for m in (card, cpu):
        grads = m.bind_grads()
        loss, _ = m.loss({k: v.to(m.device) for k, v in batch.items()})
        loss.backward()
        out.append((float(loss.detach()), {p: g.cpu() for p, g in grads.items()}))
    assert abs(out[0][0] - out[1][0]) <= 1e-5 * abs(out[1][0])
    for path, want in out[1][1].items():
        err = float((out[0][1][path] - want).norm() / want.norm().clamp_min(1e-30))
        assert err <= 1e-4, (path, err)


@pytest.mark.cuda
def test_zamba_on_the_card(cuda):
    """Zamba2-7B at full width in bf16: the forward over 128 tokens gives
    finite logits; cut to 7 layers (a group and a tail of 1) in f32 (TF32
    off), ``generate`` with an interval scrub and a NaN planted in the SSM
    state gives the CPU's tokens, stats, scrub counts and scrubbed bytes,
    and the scrub runs the kernel on every cache leaf."""
    import dataclasses

    from repro_torch.launch import serve
    from repro_torch.models import ZambaLM
    from repro_torch.runtime import ApproxConfig

    cfg = dataclasses.replace(get_config("zamba2-7b"),
                              repair=ApproxConfig(mode="memory", policy="zero"))
    model = ZambaLM(cfg, device=cuda, seed=0)
    tokens = torch.randint(0, cfg.vocab, (1, 128),
                           generator=torch.Generator().manual_seed(3)).to(cuda)
    logits = model(tokens)
    assert logits.shape == (1, 128, cfg.vocab) and bool(torch.isfinite(logits).all())
    del model, logits
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    card, cpu = _card_cpu_pair(
        ZambaLM, dataclasses.replace(cfg, n_layers=7, dtype_name="float32"), cuda)
    prompt = torch.randint(0, cfg.vocab, (2, 4), generator=torch.Generator().manual_seed(4))
    out = []
    for m in (card, cpu):
        space = serve.serve_space(m, 2, memoize=False)
        inner, log = space.scrub, []

        def scrub(cache, stats, *, trigger="forced", inner=inner, log=log):
            if len(log) == 1:
                cache["mamba_groups/ssm"][0, 1, 1, 5, 3, 2] = float("nan")
            cache, new = inner(cache, stats, trigger=trigger)
            log.append(new["nan_found"] - stats["nan_found"])
            return cache, new

        space.scrub = scrub
        common.reset_launches()
        toks, stats = serve.generate(m, prompt, max_new=4, max_seq=8, space=space)
        out.append((toks.cpu().tolist(), stats, log, space.scrubbed_bytes,
                    dict(common.LAUNCHES)))
    assert out[0][:4] == out[1][:4]
    assert out[0][2][1] == 1
    assert out[0][4] == {"scrub": len(out[0][2]) * len(card.cache_defs(2, 8))}


@pytest.mark.cuda
def test_save_checkpoint_of_card_tensors(cuda, tmp_path):
    """A bf16 weight and an f32 moment on the card, each with planted
    faults: the save scrub (the scrub kernel, one launch a leaf) writes a
    clean file and leaves the card tensors as they were; the restore lands
    on the card, bit-equal to the plain scrub of the same values."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = {"params/w": torch.randn((64, 96), generator=gen, device=cuda).bfloat16(),
            "opt/mu/w": torch.randn((64, 96), generator=gen, device=cuda),
            "opt/step": torch.zeros((), dtype=torch.int32, device=cuda)}
    tree["params/w"][3, 5] = float("nan")
    tree["opt/mu/w"][7, 1] = float("-inf")
    before = {p: t.clone() for p, t in tree.items()}
    mgr = CheckpointManager(str(tmp_path))
    common.reset_launches()
    mgr.save(1, tree)
    mgr.wait()
    assert common.LAUNCHES == {"scrub": 2}
    for p, t in tree.items():
        assert torch.equal(t.view(torch.uint8) if t.dim() else t,
                           before[p].view(torch.uint8) if t.dim() else before[p]), p
    restored, step = mgr.restore(like=tree)
    assert step == 1 and mgr.space.stats_dict()["nan_found"] == 1
    for p in ("params/w", "opt/mu/w"):
        want = before[p].clone()
        scrub.scrub_plain(want, policy="zero")
        assert restored[p].device.type == "cuda"
        assert torch.equal(restored[p].view(torch.uint8), want.view(torch.uint8)), p
    save_checkpoint(str(tmp_path), 2, restored, scrub=False)
