"""Port parity of the transformer's bf16 products: ``SwiGLU``, the biased
``Attention.qkv`` and the tied readout ``Embedding.attend``, in bf16 on the
CPU, against the reference modules' bf16 outputs (XLA's einsums with
``preferred_element_type=f32``), the weights carried across by
``convert.params_from_jax`` and the inputs made from a numpy seed.

The bar for a bf16 output: equal to the reference's except for lanes where
the two f32 sums, formed in different orders, round to neighbouring bf16
values — at most 0.1 % of the lanes, and none more than one bf16 ulp apart.
The bar for the f32 logits: within 1e-5 of the row's largest |logit|.  A
control rounds each product to bf16 before it is widened (the port's form
before the fix), and the bar must refuse it."""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.runtime import ApproxConfig as JApproxConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.runtime import ApproxConfig  # noqa: E402

WIDTHS = dict(n_layers=1, d_model=128, n_heads=4, n_kv=2, head_dim=32,
              d_ff=384, vocab=211, qkv_bias=True, dtype_name="bfloat16")
B, S = 2, 24
MAX_DIFF_SHARE = 1e-3       # lanes that may differ by summation order
LOGIT_TOL = 1e-5            # of the row's largest |logit|


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def make_pair():
    """The reference's bf16 model (random biases, so the bias add counts)
    and the port's holding the same weights, plus a bf16 input."""
    jcfg = dataclasses.replace(jget_config("qwen2-1.5b").reduced(), **WIDTHS,
                               repair=JApproxConfig(mode="off"))
    jm = jbuild_model(jcfg)
    jp = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    attn = jp["layers"]["attn"]
    for b in ("bq", "bk", "bv"):
        attn[b] = (0.5 * rng.standard_normal(attn[b].shape)).astype(attn[b].dtype)
    tcfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(), **WIDTHS,
                               repair=ApproxConfig(mode="off"))
    tm = convert.params_from_jax(jp, tcfg, device="cpu")
    x = rng.standard_normal((B, S, WIDTHS["d_model"])).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    return jm, jp, tm, jx, convert.to_torch(np.asarray(jx))


def _ordered(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns as integers in the order of their values, so two
    lanes one ulp apart differ by 1 (+0 and -0 coincide)."""
    i = bits.astype(np.int32)
    return np.where(i < 0, -(i & 0x7FFF), i)


def bf16_bar(got: torch.Tensor, want) -> tuple:
    """(share of lanes that differ, largest distance in bf16 ulps)."""
    assert got.dtype == torch.bfloat16
    g = _ordered(got.view(torch.int16).numpy())
    w = _ordered(np.asarray(want).view(np.int16))
    assert g.shape == w.shape
    dist = np.abs(g - w)
    return float((dist > 0).mean()), int(dist.max())


def holds_bf16(got, want) -> bool:
    share, ulps = bf16_bar(got, want)
    return share <= MAX_DIFF_SHARE and ulps <= 1


def logit_err(got: torch.Tensor, want) -> float:
    """Largest |got - want| over the row's largest |want|, over all rows."""
    w = np.asarray(want, np.float32)
    scale = np.abs(w).max(axis=-1, keepdims=True)
    return float((np.abs(got.numpy() - w) / scale).max())


def _layer0(jp):
    return jax.tree.map(lambda a: jnp.asarray(a[0]), jp["layers"])


def _round_then_widen(x, w):
    """The control: the bf16 product, rounded, then widened to f32."""
    return torch.matmul(x, w).float()


def _swiglu(tm, x, mm):
    mlp = tm.layers[0].mlp
    g, u = mm(x, mlp.w_gate), mm(x, mlp.w_up)
    h = (torch.nn.functional.silu(g) * u).to(x.dtype)
    return torch.matmul(h, mlp.w_down).to(x.dtype)


def _qkv(tm, x, mm):
    attn = tm.layers[0].attn
    return tuple(
        (mm(x, getattr(attn, w)) + getattr(attn, b).float()).to(x.dtype)
        for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv"))
    )


def test_swiglu_matches_reference_in_bf16(pair):
    jm, jp, tm, jx, x = pair
    want = jm.mlp(_layer0(jp)["mlp"], jx)
    got = tm.layers[0].mlp(x)
    assert got.dtype == torch.bfloat16
    share, ulps = bf16_bar(got, want)
    assert share <= MAX_DIFF_SHARE and ulps <= 1, (share, ulps)


def test_biased_qkv_matches_reference_in_bf16(pair):
    jm, jp, tm, jx, x = pair
    assert tm.layers[0].attn.qkv_bias
    want = jm.attn._qkv(_layer0(jp)["attn"], jx)
    got = tm.layers[0].attn.qkv(x)
    for name, g, w in zip("qkv", got, want):
        share, ulps = bf16_bar(g, w)
        assert share <= MAX_DIFF_SHARE and ulps <= 1, (name, share, ulps)


def test_readout_matches_reference_in_f32(pair):
    jm, jp, tm, jx, x = pair
    want = jm.embed.attend({"table": jnp.asarray(jp["embed"]["table"])}, jx)
    got = tm.embed.attend(x)
    assert got.dtype == torch.float32
    assert logit_err(got, want) <= LOGIT_TOL


@pytest.mark.parametrize("site", ["swiglu", "qkv", "readout"])
def test_double_rounding_control_fails_the_bar(pair, site):
    """Each product rounded to bf16 before it is widened: the bar must
    refuse it at every site, so the tests above can see the fault."""
    jm, jp, tm, jx, x = pair
    if site == "swiglu":
        assert not holds_bf16(_swiglu(tm, x, _round_then_widen),
                              jm.mlp(_layer0(jp)["mlp"], jx))
    elif site == "qkv":
        got = _qkv(tm, x, _round_then_widen)
        want = jm.attn._qkv(_layer0(jp)["attn"], jx)
        assert not all(holds_bf16(g.reshape(w.shape), w) for g, w in zip(got, want))
    else:
        got = _round_then_widen(x, tm.embed.table.t())
        want = jm.embed.attend({"table": jnp.asarray(jp["embed"]["table"])}, jx)
        assert logit_err(got, want) > LOGIT_TOL


@pytest.mark.parametrize("site", ["swiglu", "qkv"])
def test_control_twins_are_the_modules_with_f32_products(pair, site):
    """The control's twins with f32 products are the modules themselves, so
    the control differs from the port in the rounding alone."""
    from repro_torch.nn.layers import matmul_f32

    _, _, tm, _, x = pair
    if site == "swiglu":
        assert torch.equal(_swiglu(tm, x, matmul_f32), tm.layers[0].mlp(x))
    else:
        for a, b in zip(_qkv(tm, x, matmul_f32), tm.layers[0].attn.qkv(x)):
            assert torch.equal(a.reshape(b.shape), b)


def test_f32_operands_take_the_plain_product():
    from repro_torch.nn.layers import matmul_f32

    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 5, 8, generator=g)
    b = torch.randn(8, 6, generator=g)
    assert torch.equal(matmul_f32(a, b), torch.matmul(a, b))
    got = matmul_f32(a.bfloat16(), b.bfloat16())
    assert got.dtype == torch.float32 and got.shape == (3, 5, 6)
    assert torch.equal(got, torch.matmul(a.bfloat16().float(), b.bfloat16().float()))
