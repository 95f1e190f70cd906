"""The port's example twins run on the CPU (their plain versions), each at
its original's sizes unless the test says otherwise, with the checks the
originals print."""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "starcoder2-15b", "stablelm-1.6b"])
def test_serve_engine_twin_runs_on_the_cpu(arch, capsys):
    out = _example("torch_serve_engine").main(device="cpu", arch=arch)
    assert len(out["results"]) == 8
    assert out["metrics"]["tokens_emitted"] == 80
    assert out["metrics"]["n_preemptions"] > 0          # the pool is short
    assert out["stats"]["flips"] > 0 and out["stats"]["events"] > 0
    assert "served 8 requests" in capsys.readouterr().out


@pytest.mark.parametrize("repair", ["memory", "register"])
def test_serve_approx_twin_runs_on_the_cpu(repair, capsys):
    """At the README's sizes (10 tokens, batch 2): at its defaults (BER
    1e-4 over 48 tokens) the original lets a finite ~1e38 cache lane, which
    the NaN/Inf-only serving scrub keeps, overflow the scores, in both
    packages."""
    out = _example("torch_serve_approx").main(device="cpu", batch=2, tokens=10,
                                              repair=repair)
    assert out["tokens"].shape == (2, 11)
    assert out["stats"]["flips"] > 0
    if repair == "register":
        assert out["scrub_passes"] == 0
    assert "all logits finite: True" in capsys.readouterr().out


def test_repair_rules_twin_runs_on_the_cpu():
    out = _example("torch_repair_rules").main(device="cpu")
    assert out["embed_intact"] and out["kv_resident_after_boundary"]
    assert out["kv_clean"] and out["flips"] > 0
    rs = out["rule_stats"]
    assert rs["embed-exact"] == {"nan_found": 0, "inf_found": 0, "events": 0}
    assert rs[r"(^|/)(k|v)(/|$)"]["nan_found"] == 1
    assert rs[r"(^|/)opt(/|$)"]["inf_found"] >= 1
    assert out["stats"]["flips"] == out["flips"]


def test_train_twin_runs_on_the_cpu(capsys):
    """``--steps 3 --device cpu`` at a short batch (2 x 64 tokens)."""
    hist = _example("torch_train_approx_lm").main(
        ["--steps", "3", "--device", "cpu", "--batch", "2", "--seq", "64"])
    assert [h["step"] for h in hist] == [0, 2]
    assert all(h["loss"] == h["loss"] for h in hist)        # not NaN
    assert hist[-1]["flips"] > 0
    assert "3 steps in" in capsys.readouterr().out


def test_train_twin_checkpoints_on_the_cpu(tmp_path, capsys):
    """``--ckpt-dir`` under ``tmp_path``, a checkpoint after step 2 of 2
    (1 x 32 tokens): the twin prints the original's final line, and the
    directory holds the step-2 checkpoint."""
    _example("torch_train_approx_lm").main(
        ["--steps", "2", "--device", "cpu", "--batch", "1", "--seq", "32",
         "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert "final checkpoint: step 2" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002"]


def test_train_twin_trains_the_xlstm_on_the_cpu(tmp_path, capsys):
    """``--arch xlstm-1.3b`` at the twin's ~100M width, cut to one step of
    1 x 32 tokens, with a checkpoint after it."""
    hist = _example("torch_train_approx_lm").main(
        ["--arch", "xlstm-1.3b", "--steps", "1", "--device", "cpu",
         "--batch", "1", "--seq", "32", "--ckpt-dir", str(tmp_path),
         "--ckpt-every", "1"])
    assert [h["step"] for h in hist] == [0]
    assert hist[0]["loss"] == hist[0]["loss"]                # not NaN
    out = capsys.readouterr().out
    assert "arch=xlstm-1.3b-100m" in out and "final checkpoint: step 1" in out


def test_autopilot_twin_runs_on_the_cpu(capsys):
    """At the original's sizes: 2 groups x 2 refresh points, the frontier,
    and the engine under drift, where the guard tightens the KV group."""
    out = _example("torch_autopilot").main(["--device", "cpu"])
    assert len(out["profile"].cells) == 4
    assert out["profile"].cell("ffn_weights", 2.0).flips > 0
    assert {a.group for a in out["frontier"].assignments} == {"ffn_weights",
                                                             "kv_cache"}
    assert out["metrics"]["autopilot_trips"] == len(out["trips"]) >= 1
    assert len(out["results"][0]["tokens"]) == 8 + 8
    assert "served under drift: autopilot_trips=" in capsys.readouterr().out
