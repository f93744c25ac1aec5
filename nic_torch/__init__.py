"""nic_torch — the PyTorch/CUDA port of ``nic`` for one NVIDIA H100.

The JAX package ``nic`` stays the reference; this package mirrors its
layout module for module so each counterpart is easy to find:

- ``nic_torch.config``   the CLI configuration (``KEY=VALUE`` overrides)
- ``nic_torch.core``     quantization / positional encodings / metrics
- ``nic_torch.grids``    feature pyramid, grid sampling, the folded decode
- ``nic_torch.models``   the tiny-MLP decoder (weights kept ``[in, out]``)
- ``nic_torch.io``       the bit-packed ``.npz`` artifact, checkpoints,
                         JAX ↔ torch params and trainer state
- ``nic_torch.data``     host-side image I/O
- ``nic_torch.kernels``  hand-written CUDA kernels for Hopper (sm_90a) and
                         their plain-PyTorch versions
- ``nic_torch.train``    the NTC trainer
- ``nic_torch.obs``      run logs and scalar records
- ``nic_torch.cli``      entry points mirroring ``nic.cli``

It imports torch and numpy, never jax and never ``nic``.
"""

__version__ = "0.1.0"
