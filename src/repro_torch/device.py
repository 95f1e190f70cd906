"""Device selection for the port's entry points.

``Engine``, ``TransformerLM`` and ``PagedKVPool`` run on the card unless the
caller asks for the CPU.  Asking for the card where there is none is an
error: the port never carries on silently on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

Device = Union[str, torch.device]


def resolve(device: Optional[Device] = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
