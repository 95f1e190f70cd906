"""Port parity of checkpointing (``repro_torch.checkpoint``) and of the rest
of reference repair against the JAX reference on the CPU: the substrate's
checkpoint tests and the reshard lane's restore and reference-repair tests
as twins, restart-and-resume bit for bit, files written by either package
read by the other, a bf16 round trip, the save scrub's counts and rule
stats against the reference manager's, and the small pieces
(``memory_forced``, ``legacy``, ``from_reference``, the deprecated shim).

The model is ``qwen2-1.5b.reduced()`` with 2 layers and vocab 256 (the
reference's e2e ``tiny_cfg``).  Files are compared bit for bit: the same
keys in the same order, the same manifests, the same array bytes.  A
continued run is held as ``tests/test_torch_train.py`` holds three steps
in f32: moments within 1e-5 of the leaf's largest |moment|, params within
2 % of the summed learning rates.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import dataclasses
import json
import os
import signal
import time
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import checkpoint_repair as jckrep  # noqa: E402
from repro.core import policies as jpolicies  # noqa: E402
from repro.core import rules as jrules  # noqa: E402
from repro.data import SyntheticStream as JStream  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.runtime import ApproxConfig as JApproxConfig  # noqa: E402
from repro.runtime import ApproxSpace as JApproxSpace  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager, load_checkpoint, save_checkpoint,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import checkpoint_repair as tckrep  # noqa: E402
from repro_torch.core import policies as tpolicies  # noqa: E402
from repro_torch.core import rules as trules  # noqa: E402
from repro_torch.core import stats as tstats  # noqa: E402
from repro_torch.core.regions import flatten  # noqa: E402
from repro_torch.data import SyntheticStream  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import ApproxConfig  # noqa: E402

WIDTHS = dict(n_layers=2, vocab=256)
BATCH, SEQ = 8, 32
LR = dict(peak_lr=3e-3, warmup=5, total=20)
F32_MOMENT_TOL = 1e-5
F32_PARAM_LR_SHARE = 2e-2


def cfgs(dtype="float32", mode="memory", policy="neighbor_mean"):
    kw = dict(mode=mode, policy=policy, max_magnitude=1e3)
    jcfg = dataclasses.replace(jget_config("qwen2-1.5b").reduced(), **WIDTHS,
                               dtype_name=dtype, repair=JApproxConfig(**kw))
    tcfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(), **WIDTHS,
                               dtype_name=dtype, repair=ApproxConfig(**kw))
    return jcfg, tcfg


def pair(dtype="float32"):
    """The reference's (model, optimizer, space, state) and the port's,
    from one reference init."""
    jcfg, tcfg = cfgs(dtype)
    jm = jbuild_model(jcfg)
    jopt = jtrain.make_optimizer(**LR)
    jspace = JApproxSpace(jcfg.repair)
    js = jtrain.init_train_state(jm, jopt, jax.random.PRNGKey(0), space=jspace)
    tm, ts = convert.train_state_from_jax(jax.tree.map(np.asarray, js), tcfg,
                                          device="cpu")
    return (jm, jopt, jspace, js), (tm, ttrain.make_optimizer(**LR), ts)


def jdata(jcfg):
    """The reference's stream, and the same batches for the port."""
    stream = JStream(jcfg, seed=3, batch=BATCH, seq=SEQ)
    return stream, lambda i: {"tokens": torch.from_numpy(
        np.array(stream(i)["tokens"]))}


def files(path):
    """(manifest, ordered {key: ndarray}) of one checkpoint directory."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        return manifest, {k: npz[k] for k in npz.files}


def bits(x) -> bytes:
    """The raw bytes of a tensor, an array or a host number (a host int as
    the int32 the file holds)."""
    if isinstance(x, int):
        x = np.int32(x)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8).tobytes()


def jflat(js) -> dict:
    """The reference state's leaves under the file's paths, as numpy."""
    tree = {"params": js["params"], "stats": js["stats"],
            "opt": {"step": js["opt"].step, "mu": js["opt"].mu,
                    "nu": js["opt"].nu}}
    if "rule_counts" in js:
        tree["rule_counts"] = js["rule_counts"]
    return flatten(jax.tree.map(np.asarray, tree))


def tflat(ts) -> dict:
    return flatten({**{k: v for k, v in ts.items() if k != "stats"},
                    "stats": ts["stats"]})


def max_rel(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


# --------------------------------------------- twins of test_substrate.py


def test_checkpoint_roundtrip_and_scrub_on_save(tmp_path):
    tree = {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
            "step": torch.tensor(5, dtype=torch.int32)}
    tree["params"]["w"][0, 0] = float("nan")
    path = save_checkpoint(str(tmp_path), 5, tree)
    assert os.path.isdir(path)
    restored, step = load_checkpoint(str(tmp_path), like=tree)
    assert step == 5
    # scrub-on-save: the NaN was repaired before persisting, on a copy
    assert bool(torch.isfinite(restored["params"]["w"]).all())
    assert float(restored["params"]["w"][0, 1]) == 1.0
    assert bool(torch.isnan(tree["params"]["w"][0, 0]))
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 5


def test_checkpoint_manager_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.ones(2)}
    for s in (1, 2, 3):
        mgr.save(s, tree, blocking=True)
    assert mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]


def test_checkpoint_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = {"w": torch.ones(8)}
    mgr.save(7, tree)
    tree["w"].add_(1.0)          # the next step may update in place at once
    mgr.wait()
    assert mgr.latest_step() == 7
    restored, _ = mgr.restore(like=tree)
    assert torch.equal(restored["w"], torch.ones(8))


def test_restore_refuses_shardings(tmp_path):
    """The elastic reshard onto a mesh is slice 6; without shardings the
    restore round-trips bit for bit."""
    tree = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    save_checkpoint(str(tmp_path), 1, tree, scrub=False)
    with pytest.raises(NotImplementedError, match="slice 6"):
        load_checkpoint(str(tmp_path), like=tree, shardings={"w": object()})
    restored, _ = load_checkpoint(str(tmp_path), like=tree)
    assert torch.equal(restored["w"], tree["w"])


def test_preemption_hook_saves_on_sigterm(tmp_path):
    """A real SIGTERM (``os.kill``) runs one synchronous save, then the
    handler that was installed before the hook."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    state = {"w": torch.full((4,), 3.0)}
    seen = []
    original = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, lambda signum, frame: seen.append(signum))
    try:
        mgr.install_preemption_hook(lambda: (42, state))
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 10
        while not seen and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        signal.signal(signal.SIGTERM, original)
    assert seen == [signal.SIGTERM]
    assert mgr.latest_step() == 42
    restored, step = load_checkpoint(str(tmp_path), like=state)
    assert step == 42 and float(restored["w"][0]) == 3.0


# ------------------------------------- twins of test_checkpoint_reshard.py


def make_state():
    gen = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn((8, 16), generator=gen)},
            "opt": {"mu": torch.randn((8, 16), generator=gen),
                    "step": torch.zeros((), dtype=torch.int32)}}


def test_restore_with_repair_roundtrips(tmp_path):
    state = make_state()
    mgr = CheckpointManager(str(tmp_path), scrub=True)
    mgr.save(3, state, blocking=True)
    restored, step = mgr.restore(like=state, repair=True)
    assert step == 3
    for p, leaf in flatten(state).items():
        assert torch.equal(flatten(restored)[p], leaf), p


def test_restore_repair_requires_treedef(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, make_state(), blocking=True)
    with pytest.raises(ValueError):
        mgr.restore(repair=True)


def test_reference_repair_heals_post_restore_flips(tmp_path):
    """Flips that strike after the restore take the checkpoint's exact
    bits back; the events land in the manager's space."""
    state = make_state()
    mgr = CheckpointManager(str(tmp_path), scrub=True)
    mgr.save(5, state, blocking=True)
    restored, _ = mgr.restore(like=state)
    restored["params"]["w"][2, 3] = float("nan")
    restored["opt"]["mu"][0, 0] = float("inf")
    healed = mgr.reference_repair(restored)
    assert healed is restored
    for p, leaf in flatten(state).items():
        assert bits(flatten(healed)[p]) == bits(leaf), p
    d = mgr.space.stats_dict()
    assert d["nan_found"] == 1 and d["inf_found"] == 1 and d["events"] == 1


def test_save_leaves_the_live_state_and_writes_a_clean_file(tmp_path):
    """The save scrub repairs a copy: the live state keeps its bits (the
    NaN included) and the file is clean; the scrub's event lands in the
    manager's space."""
    state = make_state()
    state["params"]["w"][2, 3] = float("nan")
    before = {p: t.clone() for p, t in flatten(state).items()}
    mgr = CheckpointManager(str(tmp_path), scrub=True)
    mgr.save(7, state, blocking=True)
    for p, t in flatten(state).items():
        assert bits(t) == bits(before[p]), p
    assert bool(torch.isnan(state["params"]["w"][2, 3]))
    restored, step = mgr.restore(like=state)
    assert step == 7
    for leaf in flatten(restored).values():
        if leaf.is_floating_point():
            assert bool(torch.isfinite(leaf).all())
    assert mgr.space.stats_dict()["nan_found"] == 1


# --------------------------------------------- restart and resume


@pytest.fixture
def one_thread():
    """One CPU thread: PyTorch's thread-parallel CPU kernels do not give the
    same bits run to run (two uninterrupted runs of this model differ in the
    last places), so bit-equality needs a fixed summation order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_checkpoint_restart_resumes_identically(tmp_path, one_thread):
    """The twin of the reference's e2e test: kill at step 10, restore,
    continue to 20; the trajectory equals an uninterrupted run bit for
    bit (a stateless stream and the exact optimizer state)."""
    _, tcfg = cfgs()

    def fresh():
        model = build_model(tcfg, device="cpu", seed=3)
        opt = ttrain.make_optimizer(**LR)
        data = SyntheticStream(tcfg, seed=3, batch=BATCH, seq=SEQ, device="cpu")
        return model, opt, data

    model, opt, data = fresh()
    ref_state, _ = ttrain.train_loop(model, opt, data, steps=20, ber=0.0)
    ref_params = {p: t.clone() for p, t in ref_state.items()
                  if p.startswith("params/")}

    model, opt, data = fresh()
    mgr = CheckpointManager(str(tmp_path), keep=2, scrub=True)
    ttrain.train_loop(model, opt, data, steps=10, ber=0.0,
                      checkpoint_manager=mgr, checkpoint_every=10)
    model, opt, data = fresh()
    like = ttrain.init_train_state(model, opt)
    restored, step0 = load_checkpoint(str(tmp_path), like=like)
    assert step0 == 10 and int(restored["opt/step"]) == 10
    resumed, _ = ttrain.train_loop(model, opt, data, steps=20, ber=0.0,
                                   state=restored, start_step=10)
    assert resumed["params/embed/table"] is model.param_tree()["embed/table"]
    for p, t in ref_params.items():
        assert bits(resumed[p]) == bits(t), p


# ----------------------------------- files in both directions


def test_reference_file_restores_and_continues_in_the_port(tmp_path):
    """The reference trains 3 steps and checkpoints; the port restores that
    file bit for bit and continues 2 steps against the reference's own
    continuation from it."""
    (jm, jopt, jspace, js), (tm, topt, ts0) = pair()
    jstream, tstream = jdata(jm.cfg)
    jmgr = JManager(str(tmp_path), keep=2, scrub=True)
    jstep = jax.jit(jtrain.build_train_step(jm, jopt, space=jspace))
    for i in range(3):
        js, _ = jstep(js, jstream(i))
    jmgr.save(3, jtrain._fold_rule_counts(jspace, js), blocking=True)
    jrest, step = jload(str(tmp_path), like=js)
    assert step == 3
    jcont = jrest
    for i in range(3, 5):
        jcont, _ = jstep(jcont, jstream(i))

    trest, tstep = load_checkpoint(str(tmp_path), like=ts0)
    assert tstep == 3
    want = jflat(jrest)
    got = tflat(trest)
    assert list(got) == list(want)
    for p, w in want.items():
        g = got[p].astype(np.int32) if p == "rule_counts" else got[p]
        assert bits(g) == bits(w), p
    assert trest["rule_counts"].dtype == np.int64
    assert all(type(v) is int for v in trest["stats"].values())
    tcont, _ = ttrain.train_loop(tm, topt, tstream, steps=5, state=trest,
                                 start_step=3)
    lr_sum = sum(float(jopt.lr(jnp.asarray(s))) for s in (4, 5))
    for p, w in jflat(jcont).items():
        got = tcont[p] if p in tcont else None
        if p.startswith("opt/mu/") or p.startswith("opt/nu/"):
            assert max_rel(got, w) <= F32_MOMENT_TOL, (p, max_rel(got, w))
        elif p.startswith("params/"):
            err = float(np.abs(got.detach().numpy() - w).max())
            assert err <= F32_PARAM_LR_SHARE * lr_sum, (p, err)
    assert int(tcont["opt/step"]) == int(jcont["opt"].step) == 5
    assert tcont["stats"] == {k: int(v) for k, v in jcont["stats"].items()}


def test_port_file_reads_bit_equal_in_the_reference(tmp_path):
    """The port trains 2 steps and checkpoints; the reference's
    ``load_checkpoint(like=...)`` reads every leaf bit-equal to the port's
    state."""
    (jm, jopt, jspace, js), (tm, topt, ts) = pair()
    _, tstream = jdata(jm.cfg)
    mgr = CheckpointManager(str(tmp_path), keep=2, scrub=True)
    ts, _ = ttrain.train_loop(tm, topt, tstream, steps=2, state=ts,
                              checkpoint_manager=mgr, checkpoint_every=2)
    jrest, step = jload(str(tmp_path), like=js)
    assert step == 2
    got = jflat(jrest)
    want = tflat(ts)
    assert set(got) == set(want)
    for p, g in got.items():
        w = want[p]
        w = w.astype(np.int32) if isinstance(w, np.ndarray) else w
        w = np.int32(w) if isinstance(w, int) else w
        assert bits(g) == bits(w), p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_both_packages_write_the_same_file(tmp_path, dtype):
    """One train state (with a NaN planted in a weight and an Inf in a
    moment) saved by each package with its default save scrub: the same
    keys in the same order, the same manifest, the same bytes; counts and
    rule stats of the two managers equal."""
    (_, _, _, js), (_, _, ts) = pair(dtype)
    jw = js["params"]["layers"]["mlp"]["w_down"]
    js["params"]["layers"]["mlp"]["w_down"] = jw.at[1, 3, 5].set(jnp.nan)
    jmu = js["opt"].mu["embed"]["table"]
    js = {**js, "opt": js["opt"]._replace(mu={
        **js["opt"].mu, "embed": {"table": jmu.at[7, 2].set(jnp.inf)}})}
    with torch.no_grad():
        ts["params/layers/mlp/w_down"][1, 3, 5] = float("nan")
        ts["opt/mu/embed/table"][7, 2] = float("inf")
    jmgr = JManager(str(tmp_path / "ref"))
    tmgr = CheckpointManager(str(tmp_path / "port"))
    jmgr.save(3, js, blocking=True)
    tmgr.save(3, ts, blocking=True)
    jman, jarr = files(tmp_path / "ref" / "step_00000003")
    tman, tarr = files(tmp_path / "port" / "step_00000003")
    assert tman == jman
    assert list(tarr) == list(jarr)
    for k, a in jarr.items():
        assert tarr[k].dtype == a.dtype, k
        assert tarr[k].tobytes() == a.tobytes(), k
    assert tmgr.space.stats_dict() == jmgr.space.stats_dict()
    assert tmgr.space.stats_dict()["nan_found"] == 1
    assert tmgr.space.rule_stats() == jmgr.space.rule_stats()
    # the live state keeps its plants
    assert bool(torch.isnan(ts["params/layers/mlp/w_down"][1, 3, 5]))
    assert bool(torch.isinf(ts["opt/mu/embed/table"][7, 2]))


def test_bf16_round_trip_from_a_reference_file(tmp_path):
    """The reference writes a bf16 state ('|V2' leaves, the manifest naming
    bfloat16); the port rebuilds each leaf from its bits and restores it
    bit-equal, writes it again byte-equal, and the reference's flat load
    reads the port's file as it reads its own."""
    (_, _, _, js), (_, _, ts) = pair("bfloat16")
    jsave(str(tmp_path / "ref"), 1, js, scrub=False)
    man, arr = files(tmp_path / "ref" / "step_00000001")
    assert man["leaves"]["params/embed/table"]["dtype"] == "bfloat16"
    assert arr["params/embed/table"].dtype == np.dtype("V2")
    restored, _ = load_checkpoint(str(tmp_path / "ref"), like=ts)
    want = jflat(js)
    for p, leaf in tflat(restored).items():
        leaf = leaf.astype(np.int32) if p == "rule_counts" else leaf
        assert bits(leaf) == bits(want[p]), p
    assert restored["params/embed/table"].dtype == torch.bfloat16
    save_checkpoint(str(tmp_path / "port"), 1, restored, scrub=False)
    tman, tarr = files(tmp_path / "port" / "step_00000001")
    assert tman == man
    assert all(tarr[k].tobytes() == a.tobytes() for k, a in arr.items())
    flat, _ = jload(str(tmp_path / "port"))
    for k, a in arr.items():
        assert flat[k].dtype == a.dtype and flat[k].tobytes() == a.tobytes(), k


def _rulesets():
    """Moments under a NaN/Inf rule with a zero fill, the MLP weights
    under a range guard with a constant fill."""
    def build(mod):
        return mod.RuleSet((
            ("opt/.*", mod.RepairRule(detect=mod.Detector(nan=True, inf=True),
                                      fill="zero", label="moments")),
            ("params/layers/mlp/.*", mod.RepairRule(
                detect=mod.Detector(max_magnitude=1e3), fill=0.5,
                label="mlp")),
        ))
    return build(jrules), build(trules)


def test_save_scrub_with_a_ruleset_counts_as_the_reference(tmp_path):
    """A manager built from a ``repair_cfg`` with its own rules: the save
    scrub's counts, rule stats and file equal the reference manager's, and
    the live state keeps its plants."""
    (_, _, _, js), (_, _, ts) = pair()
    jr, tr = _rulesets()
    plants = (("params/layers/mlp/w_gate", (0, 5, 9), -3e4),
              ("params/layers/mlp/w_up", (1, 2, 3), float("nan")),
              ("opt/nu/embed/table", (4, 4), float("inf")),
              ("params/embed/table", (3, 1), float("nan")))
    jflat_params = flatten(jax.tree.map(np.asarray, js["params"]))
    for path, idx, value in plants:
        with torch.no_grad():
            ts[path][idx] = value
    for path, idx, value in plants:
        head, rest = path.split("/", 1)
        if head == "params":
            arr = jflat_params[rest].copy()
            arr[idx] = value
            node = js["params"]
            *keys, last = rest.split("/")
            for k in keys:
                node = node[k]
            node[last] = jnp.asarray(arr)
        else:
            name, rest2 = rest.split("/", 1)
            tree = dict(getattr(js["opt"], name))
            arr = flatten(jax.tree.map(np.asarray, tree))[rest2].copy()
            arr[idx] = value
            *keys, last = rest2.split("/")
            node = tree
            for k in keys:
                node[k] = dict(node[k])
                node = node[k]
            node[last] = jnp.asarray(arr)
            js = {**js, "opt": js["opt"]._replace(**{name: tree})}
    jmgr = JManager(str(tmp_path / "ref"),
                    repair_cfg=JApproxConfig(mode="register", rules=jr))
    tmgr = CheckpointManager(str(tmp_path / "port"),
                             repair_cfg=ApproxConfig(mode="register", rules=tr))
    jmgr.save(1, js, blocking=True)
    tmgr.save(1, ts, blocking=True)
    assert tmgr.space.stats_dict() == jmgr.space.stats_dict()
    assert tmgr.space.rule_stats() == jmgr.space.rule_stats()
    assert tmgr.space.rule_stats()["mlp"] == {"nan_found": 1, "inf_found": 1,
                                              "events": 1}
    _, jarr = files(tmp_path / "ref" / "step_00000001")
    _, tarr = files(tmp_path / "port" / "step_00000001")
    for k, a in jarr.items():
        assert tarr[k].tobytes() == a.tobytes(), k
    assert tarr["params/layers/mlp/w_gate"][0, 5, 9] == 0.5
    assert np.isfinite(tarr["params/embed/table"]).all()
    assert float(ts["params/layers/mlp/w_gate"][0, 5, 9]) == -3e4


# ------------------------------------------------- the small pieces


def test_memory_forced_and_legacy_match_reference():
    kw = dict(mode="register", policy="zero", include_inf=False,
              max_magnitude=7.0)
    j, t = JApproxConfig(**kw), ApproxConfig(**kw)
    for a, b in ((j.memory_forced(), t.memory_forced()), (j, t)):
        assert (a.mode, a.policy, a.include_inf, a.max_magnitude) == \
            (b.mode, b.policy, b.include_inf, b.max_magnitude)
    assert t.memory_forced().mode == "memory" and t.mode == "register"
    jl, tl = j.legacy(), t.legacy()
    assert type(tl).__name__ == type(jl).__name__ == "RepairConfig"
    assert dataclasses.asdict(tl) == dataclasses.asdict(jl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_reference_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    ref = rng.standard_normal((4, 6)).astype(np.float32)
    mask = rng.random((4, 6)) < 0.3
    jx = jnp.asarray(x, dtype)
    want = jpolicies.from_reference(jnp.asarray(ref))(jx, jnp.asarray(mask))
    tx = convert.to_torch(np.asarray(jx))
    pol = tpolicies.from_reference(torch.from_numpy(ref))
    got = pol(tx, torch.from_numpy(mask))
    assert pol.name == "from_reference" and got.dtype == tx.dtype
    assert bits(got) == bits(convert.to_torch(np.asarray(want)))


def test_shim_warns_and_matches_reference():
    """``core.checkpoint_repair.scrub_with_reference`` warns on every call
    and repairs as the reference's shim does, with and without Inf."""
    rng = np.random.default_rng(1)
    tree = {"params/w": rng.standard_normal((6, 8)).astype(np.float32),
            "opt/step": np.array(3, np.int32)}
    tree["params/w"][1, 2] = np.nan
    tree["params/w"][4, 4] = np.inf
    ref = {"params/w": rng.standard_normal((6, 8)).astype(np.float32),
           "opt/step": np.array(0, np.int32)}
    for include_inf in (True, False):
        with pytest.warns(DeprecationWarning):
            jout, jst = jckrep.scrub_with_reference(
                {k: jnp.asarray(v) for k, v in tree.items()},
                {k: jnp.asarray(v) for k, v in ref.items()},
                tstats.zeros(), include_inf=include_inf)
        t = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tout, tst = tckrep.scrub_with_reference(
                t, {k: torch.from_numpy(v) for k, v in ref.items()},
                tstats.zeros(), include_inf=include_inf)
        assert [w.category for w in caught] == [DeprecationWarning]
        assert tout is t
        assert {k: int(v) for k, v in jst.items()} == tst
        for k in tree:
            assert bits(tout[k]) == bits(np.asarray(jout[k]))
