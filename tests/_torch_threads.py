"""One intra-op torch thread for the port's CPU tests.

Every ``tests/test_torch_*.py`` imports this module first.  The suite runs
in several pytest-xdist workers at once, and torch gives each worker as
many intra-op threads as the machine has cores, so the workers oversubscribe
the CPU on the tiny tensors these tests use: eight train steps of the e2e
config take ~20× longer at eight threads than at one.  One thread also gives
the CPU's float sums one order run to run.

The leading underscore keeps pytest from collecting it.  On a machine with a
card (the ``cuda``-marked tests) torch keeps its default.
"""
try:
    import torch
except ImportError:         # the test modules skip themselves without torch
    torch = None

if torch is not None and not torch.cuda.is_available():
    torch.set_num_threads(1)
