"""One PyTorch thread in each test process, for the port's tests.

The suite runs under pytest-xdist, six workers on the CPU, each of which
imports every test file and keeps XLA's own thread pool beside PyTorch's.
At PyTorch's default of one OpenMP thread per core the workers' pools
oversubscribe the cores, and the port's small-shape operations wait on
each other: six port test files run at once took 282 s with the default
and 137 s with one thread each (8 cores).  A file run alone is faster at
one thread too (``test_torch_moe_serve.py``: 86 s at 8, 73 s at 1):
XLA's pool takes the cores.  Every ``test_torch_*`` file imports this
module."""
import torch

torch.set_num_threads(1)
