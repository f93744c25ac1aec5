"""Hand-written CUDA kernels for Hopper and their plain-PyTorch versions
(port of ``nic.kernels``). Kernels build on first launch, never at
import (``nic_torch.kernels._build``)."""
