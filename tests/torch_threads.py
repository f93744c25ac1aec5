"""One torch thread in each process that runs the port's CPU tests.

The tier-1 command spreads the test files over 6 xdist workers on the
machine's cores, and every worker imports every test module. Torch's
default of one intra-op thread per core in each of them oversubscribes
the cores (OpenMP threads also spin between parallel regions), which
slows the JAX worker running the longest file, ``tests/
test_train_kernel.py``, that bounds the run. The port's tests use small
tensors, for which one thread costs little. Each ``tests/test_torch_*.py``
imports this module; spawned ranks take ``threads=1`` of ``run_ranks``.
"""

import torch

torch.set_num_threads(1)
