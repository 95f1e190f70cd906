"""Kernel wrappers: each sends a CPU tensor to its plain PyTorch version and
a CUDA tensor to its hand-written CUDA kernel (``repro_torch/csrc/``)."""
