"""Kernel wrappers: each sends a CPU tensor to its plain PyTorch version and
a CUDA tensor to its hand-written CUDA kernel (``repro_torch/csrc/``).

``ops`` holds the paper's two fused-repair ops with their memory mode.
Its names are exported here too, except ``repair_matmul`` and ``scrub``:
those stay the submodules of the same name (the reference's package lets
the functions shadow them); use ``ops.repair_matmul`` and ``ops.scrub``.
"""
from . import ops  # noqa: F401
from .ops import (  # noqa: F401
    AT_EV_K, AT_EV_TOTAL, AT_EV_V, AT_INF_K, AT_INF_V, AT_NAN_K, AT_NAN_V,
    MM_EV_A, MM_EV_B, MM_EV_TOTAL, MM_INF_A, MM_INF_B, MM_NAN_A, MM_NAN_B,
    AttentionResult, MatmulResult, flash_attention, scrub_pages,
)
