"""Carry weights and decode state between the JAX reference and the port.

Both directions go through numpy, so this module needs no JAX:

  params_from_jax(tree, cfg)   the reference's parameter tree (nested dicts of
                               numpy arrays) → the port's model for
                               ``cfg.family``: a ``TransformerLM``
                               (``layers/...`` stacked (L, ...)) or an
                               ``XLSTMLM`` (``mlstm_groups/...`` stacked
                               (G, M, ...), ``slstm_layers/...`` (G, ...))
                               or a ``ZambaLM`` (``mamba_groups/...`` (G,
                               M, ...), ``shared/...`` (n_shared_blocks,
                               ...), ``proj`` (G, 2D, D), ``mamba_tail/...``
                               (n_tail, ...)), as the models store them; a tied
                               embedding stays one table (``embed/table``,
                               also the readout), an untied head is its
                               own leaf (``lm_head/w``); an MoE block's
                               router is ``layers/mlp/router/w`` (L, D, E)
                               and its experts ``layers/mlp/w_gate`` /
                               ``w_up`` (L, E, D, F) and ``w_down`` (L, E,
                               F, D)
  train_state_from_jax(state, cfg)
                               a reference train state (params, AdamW
                               moments and step, stats, rule_counts) → the
                               port's model and its flat train state
  cache_from_jax(cache, tree)  a reference cache or pool tree → the port's
                               flat ``{path: tensor}`` state, in place (a
                               Zamba cache: ``mamba_groups/{conv,ssm}``,
                               ``shared_kv/{k,v}``, ``mamba_tail/...``)
  cache_to_numpy(cache)        that flat state → the reference's nested layout
                               (for a ``PagedKVPool``, pass ``pool.tree``)

so tests can plant identical faults on both sides and compare them.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .configs.base import ArchConfig
from .core.regions import flatten
from .models import XLSTMLM, build_model


def to_torch(arr: Any, device=None) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a tensor, copied."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device) if device is not None else t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 comes back as ``ml_dtypes.bfloat16``
    when that package is installed (it ships with JAX), else as float32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@torch.no_grad()
def params_from_jax(tree: Any, cfg: ArchConfig, *, device=None):
    """The port's model for ``cfg`` holding the reference's weights: each
    reference leaf copied into the model's tensor under the same path
    (``param_tree``, the layer weights stacked as the reference stacks
    them).  Raises on a path it does not map, on a parameter left unset
    and on a shape that differs."""
    model = build_model(cfg, device=device)
    own = model.param_tree()
    flat = flatten(tree)
    extra = sorted(set(flat) - set(own))
    if extra:
        raise KeyError(f"no ported parameter for reference path {extra[0]!r}")
    missing = sorted(set(own) - set(flat))
    if missing:
        raise KeyError(f"reference tree lacks {len(missing)} parameters, "
                       f"e.g. {missing[:4]}")
    for path, arr in flat.items():
        src = to_torch(arr, model.device)
        if src.shape != own[path].shape:
            raise ValueError(f"{path}: {tuple(src.shape)} vs the port's "
                             f"{tuple(own[path].shape)}")
        own[path].copy_(src)
    return model


def _field(node: Any, name: str) -> Any:
    """``node[name]`` of a dict, or ``node.name`` of the reference's
    ``OptState`` named tuple."""
    return node[name] if isinstance(node, dict) else getattr(node, name)


def train_state_from_jax(state: Any, cfg: ArchConfig, *, device=None):
    """``(model, train state)`` from a reference train state (numpy
    leaves): the model holds its params; the flat state (``launch.train``)
    has those tensors under ``params/``, the moments and step under
    ``opt/``, the stats as host integers and ``rule_counts`` where the
    reference has it."""
    model = params_from_jax(state["params"], cfg, device=device)
    dev = model.device
    params = model.param_tree()
    out: Dict[str, Any] = {f"params/{p}": t for p, t in params.items()}
    opt = state["opt"]
    out["opt/step"] = torch.tensor(int(np.asarray(_field(opt, "step"))),
                                   dtype=torch.int32, device=dev)
    for name in ("mu", "nu"):
        flat = flatten(_field(opt, name))
        if set(flat) != set(params):
            raise KeyError(f"opt/{name} paths differ from the params'")
        for p in params:
            out[f"opt/{name}/{p}"] = to_torch(flat[p], dev).to(torch.float32)
    out["stats"] = {k: int(np.asarray(v)) for k, v in state["stats"].items()}
    if "rule_counts" in state:
        out["rule_counts"] = np.asarray(state["rule_counts"]).astype(np.int64)
    return model, out


def xlstm_params_from_jax(tree: Any, cfg: ArchConfig, *, device=None) -> XLSTMLM:
    """An ``XLSTMLM`` for ``cfg`` holding the reference's weights: leaves
    ``mlstm_groups/<module>/<name>`` stacked (n_groups, m_per_group, ...)
    and ``slstm_layers/<module>/<name>`` stacked (n_groups, ...), as the
    model stores them (``params_from_jax``)."""
    if cfg.family != "ssm":
        raise ValueError(f"{cfg.name} is not an xLSTM config")
    return params_from_jax(tree, cfg, device=device)


@torch.no_grad()
def cache_from_jax(cache: Dict[str, torch.Tensor], tree: Any) -> None:
    """Overwrite the flat state ``cache`` with a reference tree's leaves
    (the same paths, shapes and dtypes)."""
    flat = flatten(tree)
    if set(flat) != set(cache):
        raise KeyError(f"paths differ: {sorted(set(flat) ^ set(cache))}")
    for path, arr in flat.items():
        leaf = cache[path]
        src = to_torch(arr, leaf.device)
        if src.shape != leaf.shape or src.dtype != leaf.dtype:
            raise ValueError(
                f"{path}: {tuple(src.shape)} {src.dtype} vs "
                f"{tuple(leaf.shape)} {leaf.dtype}"
            )
        leaf.copy_(src)


def cache_to_numpy(cache: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The flat state in the reference's nested layout."""
    out: Dict[str, Any] = {}
    for path, leaf in cache.items():
        *heads, name = path.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[name] = to_numpy(leaf)
    return out

