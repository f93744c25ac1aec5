"""The conv-AE trainers' halo recompute under a mesh
(``nic_torch.train.conv_ae.halo_window`` / ``halo_loss``), without
spawning: every rank's share of the loss and of its gradients, computed
in one process for each rank k of D, sums to the whole asset's loss and
gradients. The JAX trainer shards the same axis (sheet rows in 2D,
frames in 3D) and lets its partitioner exchange the convolutions' halos;
its mesh step is held to its single-device step by
``tests/test_multidevice.py``, and the port's 2-rank steps to the port's
one-rank steps by ``tests/test_torch_parallel.py``.
"""

import numpy as np
import pytest
import torch

from nic_torch.train.conv_ae import ConvAETrainer, halo_loss, halo_window


@pytest.mark.parametrize("parts", [2, 4])
def test_halo_windows_cover_the_axis(parts):
    rows = [halo_window(64, parts, k) for k in range(parts)]
    own = [r[2] for r in rows]
    assert [s.start for s in own] == [k * 64 // parts for k in range(parts)]
    assert own[-1].stop == 64
    for inp, lat, out in rows:
        assert inp.start % 4 == 0 and lat.start * 4 - inp.start in (0, 4)
        assert lat.start <= out.start // 4 and lat.stop >= out.stop // 4
    with pytest.raises(ValueError, match="multiple of 4"):
        halo_window(40, 4, 0)


@pytest.mark.parametrize("kind", ["2d", "3d"])
@pytest.mark.parametrize("phase", ["noise", "quantize"])
def test_halo_shares_sum_to_the_whole_step(kind, phase):
    rng = np.random.default_rng(4)
    shape = (32, 24, 3) if kind == "2d" else (16, 8, 8, 3)
    tr = ConvAETrainer(rng.uniform(0, 1, shape).astype(np.float32),
                       num_bits=4, device="cpu")
    noise = tr._draws(phase)[0]
    params = [p for p, _, _ in tr.leaves().values()]

    def qat(z, rows=slice(None)):
        return tr._qat(z, phase, None if noise is None else
                       noise[:, :, rows])

    def grads(loss):
        return torch.autograd.grad(loss, params, allow_unused=True)

    whole = torch.mean((tr.decoder(qat(tr.encoder(tr.image))) - tr.image)
                       ** 2)
    want = grads(whole)
    for parts in (2, 4):
        shares = [halo_loss(tr.encoder, tr.decoder, tr.image,
                            halo_window(shape[0], parts, k), qat)
                  for k in range(parts)]
        torch.testing.assert_close(sum(shares), whole, rtol=1e-6, atol=0)
        got = [grads(s) for s in shares]
        for i, w in enumerate(want):
            if w is None:  # the quantize phase's encoder: no gradient
                assert all(g[i] is None for g in got)
                continue
            total = sum(g[i] for g in got)
            scale = w.abs().max()
            assert (total - w).abs().max() <= 1e-5 * scale, (parts, i)
