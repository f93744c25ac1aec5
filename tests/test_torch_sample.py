"""nic_torch.grids.sample.decoder_input against nic.grids.sample: the
[N, F] decoder input and its gradient with respect to both grids, for the
crop lattices of steps 0.25, 0.5, 1 and 2 (the step == 2 raw-sum G1
quirk on and off), triangular and sinusoidal PE. Inputs are numpy-seeded
(C=4, PE 4, a 17-node G0 and 9-node G1, two crops of half the data
size). The values are gathers and fp32 interpolations of the same
numbers (atol 1e-6); the gradients are scatter-added sums whose order
differs (atol 1e-5)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nic.grids import sample as jsample
from nic_torch.grids import sample as tsample

C, PE = 4, 4


def _setup(seed, step):
    rng = np.random.default_rng(seed)
    data = int(round(16 / step))  # the G0 lattice spans 16 cells
    n = data // 2
    g0 = rng.uniform(-0.4, 0.5, (C, 17, 17)).astype(np.float32)
    g1 = rng.uniform(-0.4, 0.5, (C, 9, 9)).astype(np.float32)
    origins = rng.integers(0, data - n + 1, (2, 2)).astype(np.int32)
    w = rng.normal(size=(2, n * n, 5 * C + 2 * PE + 1)).astype(np.float32)
    return g0, g1, origins, w, n


# the quirk only acts at step == 2, so it is switched off there alone
@pytest.mark.parametrize("use_tri_pe", [True, False])
@pytest.mark.parametrize("step,quirk", [(0.25, True), (0.5, True),
                                        (1.0, True), (2.0, True),
                                        (2.0, False)])
def test_decoder_input_and_grad_match_jax(step, quirk, use_tri_pe):
    g0, g1, origins, w, n = _setup(int(step * 8) + 3, step)
    kw = dict(pe_channels=PE, mip_level=2, ndim=2, use_tri_pe=use_tri_pe,
              g1_quirk=quirk)

    def jax_loss(grids):
        x = jax.vmap(lambda o: jsample.decoder_input(
            grids, 0, o, step, n, **kw))(jnp.asarray(origins))
        return jnp.sum(x * w), x

    (_, jx), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
        (jnp.asarray(g0), jnp.asarray(g1)))

    tg = (torch.tensor(g0, requires_grad=True),
          torch.tensor(g1, requires_grad=True))
    x = tsample.decoder_input(tg, 0, torch.tensor(origins), step, n, **kw)
    assert x.shape == jx.shape
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), atol=1e-6,
                               rtol=0)
    torch.sum(x * torch.tensor(w)).backward()
    for t, j in zip(tg, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=0)
    # one origin gives one crop's rows
    one = tsample.decoder_input(tg, 0, torch.tensor(origins[1]), step, n,
                                **kw)
    np.testing.assert_array_equal(one.detach().numpy(),
                                  x[1].detach().numpy())


def test_decoder_input_refuses_3d():
    g = torch.zeros(C, 5, 5, 5)
    with pytest.raises(NotImplementedError, match="item 10"):
        tsample.decoder_input((g, g), 0, torch.zeros(3, dtype=torch.long),
                              1.0, 4, pe_channels=PE, mip_level=0, ndim=3)
