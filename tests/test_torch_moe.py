"""Port parity of the MoE family: ``nn.moe.MoE`` against the reference's
``MoE.__call__`` on numpy inputs from a seed (the routing integers — expert
ids, kept slots, buffer rows — exactly equal; out and aux within 1e-5 in
f32), the NaN-row and capacity-overflow cases, register mode with a NaN
expert lane, the bf16 module's rounding points, and ``bmm_f32``; then
tiny twins of Qwen3-MoE-30B-A3B (RMSNorm, 128 → 4 experts, top 8 → 2) and
Phi-3.5-MoE (LayerNorm, 16 → 4 experts, top 2), with untied heads, against
the reference's models: logits, the dense cache, the paged decode at
splits 1 and 4, the paged prefill, the engine under planted faults (exact
integers), and the loss with its aux term and its gradients.  Models agree
within rtol = atol = 1e-4 (f32; the two packages sum the products in
different orders)."""

import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import repair as jrepair  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro.runtime import ApproxConfig as JApproxConfig  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServingConfig as JServingConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import regions, repair  # noqa: E402
from repro_torch.models.transformer_lm import Block, TransformerLM  # noqa: E402
from repro_torch.nn import moe  # noqa: E402
from repro_torch.nn.layers import bmm_f32, matmul_f32  # noqa: E402
from repro_torch.runtime import ApproxConfig, ApproxSpace  # noqa: E402
from repro_torch.serving import Engine, ServingConfig  # noqa: E402
from test_torch_dense_variants import (  # noqa: E402
    _DRAWN, _check_paged, _detectors, _pools, _tokens, _twin)
from test_torch_engine import CASES, _plant  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")
P = 9
D, FF = 32, 64


# ------------------------------------------------------------------ modules

def _moe_params(E, seed, skew=None):
    rng = np.random.default_rng(seed)
    p = {"router": {"w": (rng.standard_normal((D, E)) * 0.3).astype(np.float32)},
         "w_gate": (rng.standard_normal((E, D, FF)) / D ** 0.5).astype(np.float32),
         "w_up": (rng.standard_normal((E, D, FF)) / D ** 0.5).astype(np.float32),
         "w_down": (rng.standard_normal((E, FF, D)) / FF ** 0.5).astype(np.float32)}
    if skew is not None:
        p["router"]["w"][0, skew] = 10.0      # large for hidden rows with lane 0 high
    return p


def _pair(E, k, p, dtype=torch.float32, rcfg=None, jrcfg=None, cf=1.25):
    """The reference's module (f32) and the port's in ``dtype``, one
    ``p``."""
    jm = _ref_module(E, k, cf, jrcfg)
    tm = moe.MoE(D, FF, E, k, cf, dtype=dtype, device="cpu", rcfg=rcfg)
    tm.router.w.copy_(torch.from_numpy(p["router"]["w"]))
    for n in ("w_gate", "w_up", "w_down"):
        getattr(tm, n).copy_(torch.from_numpy(p[n]).to(dtype))
    return jm, tm


# The reference's module and its jitted call, one per (E, k, cf, rcfg), and
# its jitted routing step, one per (E, k, C): the cases share them (and
# their shapes), so each compiles once for the file.
_REF: dict = {}


def _ref_module(E, k, cf, jrcfg):
    key = (E, k, cf, jrcfg)
    if key not in _REF:
        jm = jmoe.MoE(D, FF, E, k, cf, dtype=jnp.float32,
                      **({"rcfg": jrcfg} if jrcfg is not None else {}))
        _REF[key] = jm
        _REF[id(jm)] = jax.jit(lambda p, x: jm(p, x))
    return _REF[key]


def _ref_step(E, k, C):
    """The reference's router step (``src/repro/nn/moe.py:76-107``) up to
    its routing integers: expert ids, keep and dest."""
    key = ("step", E, k, C)
    if key not in _REF:
        @jax.jit
        def step(x, w):
            B, S, _ = x.shape
            logits = jnp.einsum("gsd,de->gse", x, w)
            logits = jnp.where(jnp.isnan(logits), jmoe.NEG_INF, logits)
            _, idx = jax.lax.top_k(logits, k)
            flat = idx.reshape(B, S * k)
            onehot = jax.nn.one_hot(flat, E, dtype=jnp.int32)
            pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=1) - onehot,
                                      flat[..., None], axis=-1)[..., 0]
            keep = pos < C
            return idx, keep, jnp.where(keep, flat * C + pos, E * C)

        _REF[key] = step
    return _REF[key]


def _ref_slots(jm, p, x):
    """The reference's routing integers on the same inputs."""
    step = _ref_step(jm.n_experts, jm.top_k, jm.capacity(x.shape[1]))
    return tuple(map(np.asarray, step(jnp.asarray(x, jnp.float32),
                                      jnp.asarray(p["router"]["w"]))))


def _ref_call(jm, p, x):
    return _REF[id(jm)](jax.tree.map(jnp.asarray, p), jnp.asarray(x, jnp.float32))


def _port_slots(tm, x):
    _, idx, _ = tm.route(x)
    keep, dest = moe.slots(idx, tm.n_experts, tm.capacity(x.shape[1]))
    return idx.numpy(), keep.numpy(), dest.numpy()


def _run_both(jm, tm, p, x):
    want, jaux = _ref_call(jm, p, x)
    got, aux = tm(torch.from_numpy(x))
    return (np.asarray(want), float(jaux)), (got, float(aux))


def _check_integers(jm, tm, p, x):
    want = _ref_slots(jm, p, x)
    got = _port_slots(tm, torch.from_numpy(x))
    for name, g, w in zip(("expert ids", "keep", "dest"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    return got


def test_moe_matches_reference():
    """(a) f32, two groups of sixteen tokens, 4 experts top 2: out and
    aux within 1e-5, the routing integers exact."""
    p = _moe_params(4, 0)
    jm, tm = _pair(4, 2, p)
    x = np.random.default_rng(1).standard_normal((2, 16, D)).astype(np.float32)
    _check_integers(jm, tm, p, x)
    (want, jaux), (got, aux) = _run_both(jm, tm, p, x)
    np.testing.assert_allclose(got.numpy(), want, **MODULE_TOL)
    np.testing.assert_allclose(aux, jaux, **MODULE_TOL)
    assert tm.capacity(7) == jm.capacity(7) == 5


def test_nan_row_routes_to_the_first_experts():
    """(b) a NaN lane in one token's hidden row makes its 16 logits -1e30:
    its experts are 0…k-1 (``torch.topk`` alone would pick others), its
    gates equal, its output NaN as the reference's; the other tokens
    agree within 1e-5."""
    E, k = 16, 4
    p = _moe_params(E, 2)
    jm, tm = _pair(E, k, p)
    x = np.random.default_rng(3).standard_normal((2, 5, D)).astype(np.float32)
    x[1, 3, 7] = np.nan
    idx, _, _ = _check_integers(jm, tm, p, x)
    assert idx[1, 3].tolist() == list(range(k))
    gates, _, _ = tm.route(torch.from_numpy(x))
    assert torch.equal(gates[1, 3], torch.full((k,), 1.0 / k))
    (want, jaux), (got, aux) = _run_both(jm, tm, p, x)
    np.testing.assert_allclose(got.numpy(), want, equal_nan=True, **MODULE_TOL)
    assert np.isnan(got[1, 3].numpy()).all()
    assert np.isfinite(got[0].numpy()).all()
    np.testing.assert_allclose(aux, jaux, **MODULE_TOL)


def test_capacity_overflow_drops_the_reference_slots():
    """(c) a skewed router (one column's weight on lane 0 raised, the tokens'
    lane 0 shifted up): all 16 tokens of a chunk choose
    expert 1 first, capacity 10 keeps the first 10 in token order and drops
    the rest, exactly as the reference; a dropped slot gathers the last row
    times 0."""
    p = _moe_params(4, 4, skew=1)
    jm, tm = _pair(4, 2, p)
    x = np.random.default_rng(5).standard_normal((2, 16, D)).astype(np.float32)
    x[..., 0] += 3.0
    idx, keep, dest = _check_integers(jm, tm, p, x)
    assert tm.capacity(16) == 10
    assert (idx[..., 0] == 1).all()
    assert (~keep).sum() >= 12 and keep.reshape(2, 16, 2)[:, :10, 0].all()
    assert (dest[~keep] == 4 * 10).all()
    (want, _), (got, _) = _run_both(jm, tm, p, x)
    np.testing.assert_allclose(got.numpy(), want, **MODULE_TOL)


def test_register_mode_repairs_expert_reads():
    """(d) a NaN in one expert's ``w_gate`` lane under register mode (zero
    fill): every read repairs, out equals the reference's and is finite;
    with repair off it poisons the tokens that reach that expert.  The
    reads are pathless, as the reference's ``use`` calls: under a ruleset
    of two on-read rules they take ``RuleSet.read_rule`` (the first, bound
    to ``layers/attn``, fill 1.0), not the one bound to
    ``layers/mlp/w_gate`` (zero fill), and agree with the reference."""
    p = _moe_params(4, 6)
    p["w_gate"][2, 5, 9] = np.nan
    x = np.random.default_rng(7).standard_normal((2, 16, D)).astype(np.float32)
    jm, tm = _pair(4, 2, p, rcfg=repair.RepairConfig(mode="register", policy="zero"),
                   jrcfg=jrepair.RepairConfig(mode="register", policy="zero"))
    (want, _), (got, _) = _run_both(jm, tm, p, x)
    assert np.isfinite(got.numpy()).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, **MODULE_TOL)
    _, off = _pair(4, 2, p)
    assert not np.isfinite(off(torch.from_numpy(x))[0].numpy()).all()

    def on_read(mod):
        return mod.ApproxConfig(mode="memory", rules=(
            (r"layers/attn", mod.RepairRule(trigger="on-read", fill=1.0)),
            (r"layers/mlp/w_gate", mod.RepairRule(trigger="on-read", fill="zero"))))

    import repro.runtime as jruntime
    import repro_torch.runtime as truntime

    jm1, tm1 = _pair(4, 2, p, rcfg=on_read(truntime), jrcfg=on_read(jruntime))
    assert set(tm1.reads.paths.values()) == {""}
    (want1, _), (got1, _) = _run_both(jm1, tm1, p, x)
    np.testing.assert_allclose(got1.numpy(), want1, **MODULE_TOL)
    assert np.isfinite(got1.numpy()).all()
    assert not np.allclose(got1.numpy(), got.numpy(), **MODULE_TOL)


def test_bf16_module_rounds_where_the_reference_does():
    """(e) the bf16 module against the reference in f32 on the same
    bf16-rounded operands (the reference's bf16 MoE cannot run on the CPU:
    XLA's CPU dot has no bf16 × bf16 = f32).  The port rounds h, y, each
    slot's gate product and the k-sum to bf16; each rounding moves a value
    by at most half a bf16 ulp (2^-9 relative), and h's moves y by at most
    2^-9 Σ|h||w_down|.  Tolerance: one bf16 ulp (2^-8) of out's magnitude
    bound Σ_k |gate_k| (Σ_f |h_kf||w_down_f| + |y_k|) + |out|, plus 1e-6 of
    it for the f32 sums' order.  The routing integers are exact, and the
    control (no rounding of h) is outside no bound."""
    E, k = 4, 2
    p = _moe_params(E, 8)
    pb = jax.tree.map(lambda a: np.asarray(torch.from_numpy(a).bfloat16().float()), p)
    pb["router"]["w"] = p["router"]["w"]                    # the router stays f32
    jm, tm = _pair(E, k, pb, dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 16, D)).astype(np.float32)).bfloat16()
    xf = x.float().numpy()
    got, _ = tm(x)
    assert got.dtype == torch.bfloat16
    want, _ = _ref_call(jm, pb, xf)
    want = np.asarray(want)
    gates, idx, _ = tm.route(x)
    keep, _ = moe.slots(idx, E, tm.capacity(16))
    np.testing.assert_array_equal(idx.numpy(), _ref_slots(jm, pb, xf)[0])
    w = (gates.reshape(2, -1) * keep.float()).reshape(2, 16, k).numpy()
    mag = np.abs(want).copy()
    for b in range(2):
        for s in range(16):
            for j in range(k):
                e = int(idx[b, s, j])
                g, u = xf[b, s] @ pb["w_gate"][e], xf[b, s] @ pb["w_up"][e]
                h = g / (1.0 + np.exp(-g)) * u
                y = h @ pb["w_down"][e]
                mag[b, s] += abs(w[b, s, j]) * (np.abs(h) @ np.abs(pb["w_down"][e])
                                                + np.abs(y))
    err = np.abs(got.float().numpy() - want)
    assert (err <= (2.0 ** -8 + 1e-6) * mag).all(), float((err / mag).max())
    assert err.max() > 0                                    # the roundings happened


def test_bmm_f32_equals_per_expert_matmul_f32():
    """(h) forward and backward on bf16 operands: each batch's product,
    its f32 result and the two gradients (each rounded once to bf16)
    equal ``matmul_f32``'s bit for bit."""
    rng = np.random.default_rng(10)
    a0 = torch.from_numpy(rng.standard_normal((3, 5, 16)).astype(np.float32)).bfloat16()
    b0 = torch.from_numpy(rng.standard_normal((3, 16, 8)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((3, 5, 8)).astype(np.float32))
    a, b = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
    out = bmm_f32(a, b)
    assert out.dtype == torch.float32
    out.backward(g)
    for e in range(3):
        ae, be = a0[e].clone().requires_grad_(True), b0[e].clone().requires_grad_(True)
        oe = matmul_f32(ae, be)
        oe.backward(g[e])
        assert torch.equal(out[e].detach(), oe.detach())
        assert torch.equal(a.grad[e], ae.grad) and torch.equal(b.grad[e], be.grad)
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    with torch.no_grad():
        assert torch.equal(bmm_f32(a0, b0), out.detach())


# -------------------------------------------------------------- the models

def tiny_cfg(arch, **over):
    return _twin(get_config, arch, ApproxConfig, **over)


def jtiny_cfg(arch, **over):
    return _twin(jget_config, arch, JApproxConfig, **over)


def _ref_params(arch, seed):
    """The reference's param tree for ``arch``'s twin, its leaves drawn by
    the port's initialiser (the reference's scheme, and no XLA compile,
    where the reference's ``init`` compiles a program for each leaf shape)
    and every bias and norm parameter then drawn as ``_drawn_params``
    draws it.  Its paths, shapes and dtypes are the reference's
    ``abstract_params``."""
    jm = jbuild_model(jtiny_cfg(arch))
    flat = {path: t.numpy().copy() for path, t in
            TransformerLM(tiny_cfg(arch), device="cpu", seed=seed).param_tree().items()}
    rng = np.random.default_rng(seed)
    for path, leaf in flat.items():
        if ("/" + path).endswith(_DRAWN):
            draw = rng.standard_normal(leaf.shape).astype(leaf.dtype)
            leaf[...] = (1.0 + 0.3 * draw) if path.endswith("/scale") else 0.3 * draw
    tree: dict = {}
    for path, leaf in flat.items():
        *outer, name = path.split("/")
        node = tree
        for part in outer:
            node = node.setdefault(part, {})
        node[name] = leaf
    shapes = jax.tree.map(lambda a: (a.shape, np.dtype(a.dtype)), jm.abstract_params())
    assert jax.tree.map(lambda a: (a.shape, a.dtype), tree) == shapes
    return jm, tree


@pytest.fixture(scope="module")
def twins():
    out = {}
    for i, arch in enumerate(ARCHS):
        jm, jp = _ref_params(arch, 20 + i)
        tm = convert.params_from_jax(jp, tiny_cfg(arch), device="cpu")
        out[arch] = (jm, jax.tree.map(jnp.asarray, jp), tm)
    return out


def test_configs_build_at_full_width():
    """A full-width block of each config builds (on the meta device, which
    holds no memory; the card builds Qwen3-MoE whole), and the reduced
    twins narrow the experts as the reference's do."""
    for arch, E, k in (("qwen3-moe-30b-a3b", 128, 8), ("phi3.5-moe-42b-a6.6b", 16, 2)):
        cfg = get_config(arch)
        assert (cfg.n_experts, cfg.top_k, cfg.family) == (E, k, "moe")
        assert (cfg.reduced().n_experts, cfg.reduced().top_k) == (4, 2)
        blk = Block(cfg, torch.device("meta"))
        assert isinstance(blk.mlp, moe.MoE)
        assert tuple(blk.mlp.w_gate.shape) == (E, cfg.d_model, cfg.d_ff)
        assert tuple(blk.mlp.router.w.shape) == (cfg.d_model, E)
        assert blk.mlp.router.w.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_twin_layout_and_regions(twins, arch):
    """The stacked leaves (the router's nested path included) carry the
    reference's values; the router is exact (injection and scrub skip it),
    the (L, E, ...) experts approximate: a heavy injection flips expert
    bits and leaves the router's untouched."""
    _, jp, tm = twins[arch]
    tree = tm.param_tree()
    flat = regions.flatten(jax.tree.map(np.asarray, jp))
    assert list(tree) == list(flat)
    assert tuple(tree["layers/mlp/w_gate"].shape) == (2, 4, 64, 128)
    assert tm.layers[1].mlp.router.w.data_ptr() == (
        tree["layers/mlp/router/w"][1].data_ptr())
    reg = regions.annotate(tree)
    assert reg["layers/mlp/router/w"] is regions.Region.EXACT
    for n in ("w_gate", "w_up", "w_down"):
        assert reg[f"layers/mlp/{n}"] is regions.Region.APPROX
    state = {p: t.clone() for p, t in tree.items()}
    space = ApproxSpace(ApproxConfig(mode="memory", policy="zero"))
    space.inject(state, torch.Generator().manual_seed(0), 1e-3)
    assert torch.equal(state["layers/mlp/router/w"], tree["layers/mlp/router/w"])
    assert not torch.equal(state["layers/mlp/w_up"].view(torch.int32),
                           tree["layers/mlp/w_up"].view(torch.int32))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_and_dense_cache_match_reference(twins, arch):
    jm, jp, tm = twins[arch]
    tokens = _tokens((2, 12), 2)
    want = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(tm(torch.from_numpy(tokens)).numpy(),
                               np.asarray(want), **TOL)
    B, T = 2, 16
    jc, tc = jm.init_cache(B, T), tm.init_cache(B, T)
    step = jax.jit(jm.serve_step)
    for tok, pos in ((_tokens((B, 6), 3), np.int32(0)),
                     (_tokens((B, 1), 4), np.array([6, 9], np.int32))):
        jl, jc = step(jp, jc, {"tokens": jnp.asarray(tok)}, jnp.asarray(pos))
        tl, tc = tm.serve_step(tc, torch.from_numpy(tok), torch.as_tensor(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    got = convert.cache_to_numpy(tc)
    for name in ("k", "v"):
        np.testing.assert_allclose(got["layers"][name],
                                   np.asarray(jc["layers"][name]), **TOL)


@pytest.mark.parametrize("split_k", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_serve_step_paged_matches_reference(twins, arch, split_k):
    jm, jp, tm = twins[arch]
    jpool, tpool = _pools(tm, 5)
    bt = np.array([[0, 1, 2, P - 1], [3, 4, P - 1, P - 1], [P - 1] * 4], np.int32)
    pos = np.array([9, 5, 0], np.int32)
    tokens = np.array([[5], [17], [0]], np.int32)
    jdet, tdet, fills = _detectors()
    out_j = jax.jit(lambda *a: jm.serve_step_paged(
        *a, detectors=jdet, fills=fills, split_k=split_k))(
        jp, jpool, {"tokens": jnp.asarray(tokens)}, jnp.asarray(bt),
        jnp.asarray(pos))
    out_t = tm.serve_step_paged(
        tpool, torch.from_numpy(tokens), torch.from_numpy(bt),
        torch.from_numpy(pos), detectors=tdet, fills=fills, split_k=split_k)
    _check_paged(out_j, out_t, out_j[1], tpool)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_paged_matches_reference(twins, arch):
    """A chunk of 7 rows, two of them padding in the first request: the
    padding rows are routed too and take capacity after the valid ones."""
    jm, jp, tm = twins[arch]
    jpool, tpool = _pools(tm, 6)
    bt = np.array([[5, 6, 7, P - 1], [1, 2, P - 1, P - 1]], np.int32)
    tokens = _tokens((2, 7), 7)
    q_start, q_len = np.array([2, 0], np.int32), np.array([5, 7], np.int32)
    jdet, tdet, fills = _detectors()
    out_j = jax.jit(lambda *a: jm.prefill_paged(*a, detectors=jdet, fills=fills))(
        jp, jpool, {"tokens": jnp.asarray(tokens)}, jnp.asarray(bt),
        jnp.asarray(q_start), jnp.asarray(q_len))
    out_t = tm.prefill_paged(
        tpool, torch.from_numpy(tokens), torch.from_numpy(bt),
        torch.from_numpy(q_start), torch.from_numpy(q_len), detectors=tdet,
        fills=fills)
    _check_paged(out_j, out_t, out_j[1], tpool, rows=5)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_engine_matches_reference_under_planted_faults(twins, arch):
    """The engine test's planted faults on the paged path, prompts in
    chunks of 4: tokens, page events, stats, rule stats, slot counts
    (``kernel_counts``) and scrubbed bytes equal."""
    jm, jp, tm = twins[arch]
    kw = dict(CASES["preempt"], prefill_chunk=4)
    je = JEngine(jm, jp, JServingConfig(**kw))
    te = Engine(tm, ServingConfig(**kw), device="cpu")
    assert te.paged_plan is not None
    rng = np.random.default_rng(0)
    max_seq = kw["page_size"] * kw["max_pages_per_request"]
    for i in range(6):
        prompt = rng.integers(1, 96, size=4 + i % 4)
        max_new = min(6, max_seq - len(prompt))
        assert je.add_request(prompt, max_new) == te.add_request(prompt, max_new)
    step = 0
    while je.has_work:
        assert je.step() == te.step(), step
        if step in (1, 4):
            _plant(je, te, step)
        step += 1
    assert not te.has_work
    for rid, res in je.results.items():
        assert te.results[rid] == res
    np.testing.assert_array_equal(te.pool.page_events, je.pool.page_events)
    assert te.stats_dict() == je.stats_dict()
    assert te.stats_dict()["nan_found"] > 0
    assert te.rule_stats() == je.rule_stats()
    assert te.pool.scrubbed_bytes == je.pool.scrubbed_bytes
    np.testing.assert_array_equal(te.kernel_counts, je.kernel_counts)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_loss_and_grads_match_reference(twins, arch):
    """(g) the loss with ``0.01 · aux`` and the ``moe_aux`` metric, and
    every gradient (the router's, through the gates and the aux term,
    included)."""
    jm, jp, tm = twins[arch]
    tokens = _tokens((2, 16), 8)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {"tokens": jnp.asarray(tokens)})
    grads = tm.bind_grads()
    try:
        for g in grads.values():
            g.zero_()
        tl, met = tm.loss({"tokens": torch.from_numpy(tokens)})
        tl.backward()
        np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
        np.testing.assert_allclose(float(met["moe_aux"]), float(jmet["moe_aux"]),
                                   **TOL)
        assert float(met["moe_aux"]) > 0
        jg = regions.flatten(jax.tree.map(np.asarray, jg))
        assert set(grads) == set(jg)
        for path, g in grads.items():
            want = jg[path]
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(want).max()),
                                       err_msg=path)
        assert float(np.abs(jg["layers/mlp/router/w"]).max()) > 0
    finally:
        for p in tm.parameters():
            p.requires_grad_(False)
            p.grad = None
        tm._grads = None
