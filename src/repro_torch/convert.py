"""Carry weights and pool state between the JAX reference and the port.

Both directions go through numpy, so this module needs no JAX:

  params_from_jax(tree, cfg)   the reference's parameter tree (nested dicts of
                               numpy arrays, ``layers/...`` stacked on axis
                               0) → a ``TransformerLM`` whose per-layer
                               modules hold slice ``i``; the tied embedding
                               stays one table
  pool_from_jax(pool, tree)    the reference pool's ``{"layers": {"k", "v"}}``
                               leaves (P, L, pg, Kh, Dh) → ``pool.tree``
  pool_to_numpy(pool)          ``pool.tree`` → that nested numpy layout

so tests can plant identical faults in both pools and compare them.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .configs.base import ArchConfig
from .core.regions import flatten
from .models import TransformerLM


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
def params_from_jax(tree: Any, cfg: ArchConfig, *, device=None) -> TransformerLM:
    """A ``TransformerLM`` for ``cfg`` holding the reference's weights."""
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


@torch.no_grad()
def pool_from_jax(pool, tree: Any) -> None:
    """Overwrite ``pool.tree`` with the reference pool's leaves."""
    for path, arr in flatten(tree).items():
        leaf = pool.tree[path]
        src = to_torch(arr, leaf.device)
        if src.shape != leaf.shape or src.dtype != leaf.dtype:
            raise ValueError(
                f"{path}: {tuple(src.shape)} {src.dtype} vs pool "
                f"{tuple(leaf.shape)} {leaf.dtype}"
            )
        leaf.copy_(src)


def pool_to_numpy(pool) -> Dict[str, Dict[str, np.ndarray]]:
    """``pool.tree`` in the reference's nested layout."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for path, leaf in pool.tree.items():
        head, name = path.split("/")
        out.setdefault(head, {})[name] = to_numpy(leaf)
    return out
