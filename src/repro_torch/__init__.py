"""PyTorch/CUDA port of the reactive NaN repair system.

The package mirrors ``repro`` (the JAX reference) module for module: the
paged serving engine (``serving.Engine``) drives ``models.TransformerLM``
over a paged approximate-memory KV pool, and the paper's two repair points
run through hand-written CUDA kernels for Hopper (``csrc/``):

  repair at the point of use   the paged attention kernels repair fatal
                               K/V lanes on read (``kernels.paged_attention``)
  repair once at the origin    the reactive page scrub writes repaired
                               values back into the pool (``kernels.scrub``)

The paper's own demonstration runs through ``kernels.ops``: the fused-
repair ``repair_matmul`` and ``flash_attention`` in register and memory
mode (``examples/torch_quickstart.py`` reproduces Fig. 1 and Table 3).

Every kernel wrapper sends CPU tensors to its plain PyTorch version and
CUDA tensors to its kernel.  Importing the package needs neither CUDA nor a
compiler: kernels are built with ``nvcc`` at first use.
"""
