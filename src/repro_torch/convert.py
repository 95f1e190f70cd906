"""Carry weights and decode state between the JAX reference and the port.

Both directions go through numpy, so this module needs no JAX:

  params_from_jax(tree, cfg)   the reference's parameter tree (nested dicts of
                               numpy arrays) → the port's model for
                               ``cfg.family``: a ``TransformerLM``
                               (``layers/...`` stacked on axis 0) or an
                               ``XLSTMLM`` (``xlstm_params_from_jax``); the
                               tied embedding stays one table
  cache_from_jax(cache, tree)  a reference cache or pool tree → the port's
                               flat ``{path: tensor}`` state, in place
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
from .models import TransformerLM, XLSTMLM


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


# reference path (under "layers/") -> (block attribute, parameter name)
_LAYER_PARAMS = {
    "attn/wq": ("attn", "wq"), "attn/wk": ("attn", "wk"),
    "attn/wv": ("attn", "wv"), "attn/wo": ("attn", "wo"),
    "attn/bq": ("attn", "bq"), "attn/bk": ("attn", "bk"),
    "attn/bv": ("attn", "bv"),
    "mlp/w_gate": ("mlp", "w_gate"), "mlp/w_up": ("mlp", "w_up"),
    "mlp/w_down": ("mlp", "w_down"),
    "norm1/scale": ("norm1", "scale"), "norm2/scale": ("norm2", "scale"),
}


@torch.no_grad()
def params_from_jax(tree: Any, cfg: ArchConfig, *, device=None):
    """The port's model for ``cfg`` holding the reference's weights."""
    if cfg.family == "ssm":
        return xlstm_params_from_jax(tree, cfg, device=device)
    model = TransformerLM(cfg, device=device)
    flat = flatten(tree)
    dev = model.device
    seen = set()
    for path, arr in flat.items():
        if path == "embed/table":
            model.embed.table.copy_(to_torch(arr, dev))
        elif path == "final_norm/scale":
            model.final_norm.scale.copy_(to_torch(arr, dev))
        elif path.startswith("layers/") and path[7:] in _LAYER_PARAMS:
            block_attr, name = _LAYER_PARAMS[path[7:]]
            stacked = to_torch(arr, dev)
            if stacked.shape[0] != len(model.layers):
                raise ValueError(
                    f"{path}: {stacked.shape[0]} stacked layers, model has "
                    f"{len(model.layers)}"
                )
            for i, blk in enumerate(model.layers):
                getattr(getattr(blk, block_attr), name).copy_(stacked[i])
        else:
            raise KeyError(f"no ported parameter for reference path {path!r}")
        seen.add(path)
    missing = {"embed/table", "final_norm/scale"} - seen
    if missing:
        raise KeyError(f"reference tree lacks {sorted(missing)}")
    return model


def _block_param(block, module: str, name: str, path: str) -> torch.nn.Parameter:
    p = getattr(getattr(block, module, None), name, None)
    if not isinstance(p, torch.nn.Parameter):
        raise KeyError(f"no ported parameter for reference path {path!r}")
    return p


@torch.no_grad()
def xlstm_params_from_jax(tree: Any, cfg: ArchConfig, *, device=None) -> XLSTMLM:
    """An ``XLSTMLM`` for ``cfg`` holding the reference's weights: leaves
    ``mlstm_groups/<module>/<name>`` stacked (n_groups, m_per_group, ...)
    and ``slstm_layers/<module>/<name>`` stacked (n_groups, ...).  Raises
    on a path it does not map and on a parameter left unset."""
    model = XLSTMLM(cfg, device=device)
    G, M = model.n_groups, model.m_per_group
    dev = model.device
    done = set()

    def put(p, value, path):
        if value.shape != p.shape:
            raise ValueError(f"{path}: {tuple(value.shape)} vs the port's "
                             f"{tuple(p.shape)}")
        p.copy_(value)
        done.add(id(p))

    for path, arr in flatten(tree).items():
        parts = path.split("/")
        src = to_torch(arr, dev)
        if path == "embed/table":
            put(model.embed.table, src, path)
        elif path == "final_norm/scale":
            put(model.final_norm.scale, src, path)
        elif parts[0] == "mlstm_groups" and len(parts) == 3:
            if tuple(src.shape[:2]) != (G, M):
                raise ValueError(f"{path}: stacked {tuple(src.shape[:2])}, "
                                 f"model has ({G}, {M})")
            for g in range(G):
                for i in range(M):
                    put(_block_param(model.mblock(g, i), *parts[1:], path),
                        src[g, i], path)
        elif parts[0] == "slstm_layers" and len(parts) == 3:
            if src.shape[0] != G:
                raise ValueError(f"{path}: {src.shape[0]} stacked groups, "
                                 f"model has {G}")
            for g in range(G):
                put(_block_param(model.slstm_layers[g], *parts[1:], path),
                    src[g], path)
        else:
            raise KeyError(f"no ported parameter for reference path {path!r}")
    unset = [n for n, p in model.named_parameters() if id(p) not in done]
    if unset:
        raise KeyError(f"reference tree lacks {len(unset)} parameters, "
                       f"e.g. {unset[:4]}")
    return model


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

