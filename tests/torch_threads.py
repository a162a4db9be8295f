"""One torch intra-op thread and one inter-op thread in every process that
runs a port test file: each ``tests/test_torch_*.py`` imports this module
before anything else.

The tests run in several processes at once (pytest-xdist), each beside
JAX's own thread pool, on as many cores as torch would start threads a
process; small ops then spin against the other processes for the cores.
Every bit-for-bit pin between two port runs runs both sides in one
process, so both run on this one thread.
"""
import torch

torch.set_num_threads(1)
try:
    torch.set_num_interop_threads(1)
except RuntimeError:         # the process started its inter-op pool already
    pass
