"""The JAX conv-AE trainer and the port's, from one initial state and one
noise stream, step by step on the CPU: misty 64³ (movie_3d_comp's
widths, 8-bit latent, 16/32 channels). The JAX trainer's own jitted
noise step draws its noise from each step's key; the port's step core
gets that same noise; the script prints both losses and their relative
difference at a few steps, showing how long the two trajectories stay
together before fp32 rounding differences grow.

Run (about 1.5 s a step, JAX's im2col convolutions on the CPU):
  JAX_PLATFORMS=cpu python scripts/torch_convae_trajectory.py [STEPS]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(steps: int = 100) -> None:
    import jax
    import torch

    from nic.core.quant import qat_noise
    from nic.io.artifacts import _flatten_tree
    from nic.train.conv_ae import ConvAETrainer as JaxTrainer
    from nic_torch.data.assets import read_clip
    from nic_torch.train.conv_ae import ConvAETrainer

    movie = read_clip(os.path.join(ROOT, "data", "misty_64_64.avi")).astype(
        np.float32) / 255.0
    kw = dict(num_bits=8, latent_channels=16, hidden_channels=32,
              num_epochs=250)
    jt = JaxTrainer(movie, seed=0, **kw)
    pt = ConvAETrainer(movie, device="cpu", seed=0, **kw)
    pt.load_state_arrays(_flatten_tree(jt.params, "params"))
    step = jt._jit_step["noise"]
    params, opt = jt.params, jt.opt_state
    key = jax.random.PRNGKey(123)
    zshape = (1, 16, 16, 16, 16)
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        key, sub = jax.random.split(key)
        noise = np.asarray(qat_noise(sub, zshape, 8))  # the step's own draw
        params, opt, jloss = step(params, opt, jt.image, sub)
        tloss = float(pt.step_core("noise", torch.from_numpy(
            np.ascontiguousarray(np.moveaxis(noise, -1, 1)))))
        if i in (1, 10, 20, 40, 60, 80) or i == steps:
            jl = float(jloss)
            print(f"step {i}: JAX {jl:.8f}, port {tloss:.8f}, rel "
                  f"{abs(jl - tloss) / jl:.2e} ({time.perf_counter() - t0:.0f}"
                  " s)", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 100)
