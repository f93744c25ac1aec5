"""A numeric model, in torch on the CPU, of the fp32 dots that the decodes'
tensor-core bodies take as three TF32 products (csrc/decode_mma.cuh
``mma_3xtf32``): each operand is split into its TF32 rounding (round to
nearest, ties away: ``cvt.rna.tf32.f32``) and the TF32 rounding of the
rest, and al·bh + ah·bl + ah·bh is summed with al·bl dropped.

K3's ``decode_v1_mma`` takes its first layer x·W1 so, on feature rows
that end in the LOD constant, and both it and K4's ``mlp_tail_mma`` take
W2 and W3 so. On seeded inputs at F = 73 (the flagship) and F = 413, H =
64 and 128, with the LOD feature at 9 (the deepest mip), the modelled MLP
stays within the fp32 tolerance 2e-5 (on the [0, 1] output) of the plain
versions: ``decode_kernel_v1_plain``'s MLP for K3 and ``mlp_tail_plain``
for K4. No JAX here: the plain versions are held to JAX elsewhere
(test_torch_decode_fused.py, test_torch_decode_fused_v3.py).
"""

import numpy as np
import pytest
import torch

from nic_torch.kernels import decode_fused_v3 as tv3
from nic_torch.kernels.decode_fused_v2 import GELUS, _dot

LOD = 9.0    # the LOD feature of the deepest mip
TOL = 2e-5   # the fp32 limit of K3 and K4 against their plain versions
NPIX = 2048


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def dot3(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h·w as three TF32 products (al bh + ah bl + ah bh), summed in
    float64 and returned in fp32: the dropped al·bl term and the TF32
    roundings are the model's only departures from an fp32 product."""
    hh, wh = tf32(h), tf32(w)
    hl, wl = tf32(h - hh), tf32(w - wh)
    return (hl.double() @ wh.double() + hh.double() @ wl.double()
            + hh.double() @ wh.double()).float()


def _inputs(nfeat: int, hidden: int, seed: int):
    """Feature rows [NPIX, nfeat] as K3 forms them (grid and PE features
    in [-1, 1], the LOD last) and an MLP initialised as init_mlp does."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (NPIX, nfeat)).astype(np.float32)
    x[:, -1] = LOD
    dims = (nfeat, hidden, hidden, 3)
    mlp = {}
    for i in range(3):
        b = 1.0 / np.sqrt(dims[i])
        mlp[f"w{i + 1}"] = torch.tensor(
            rng.uniform(-b, b, dims[i:i + 2]).astype(np.float32))
        mlp[f"b{i + 1}"] = torch.tensor(
            rng.uniform(-b, b, dims[i + 1]).astype(np.float32))
    return torch.tensor(x), mlp


def _tail(h1, mlp, dot) -> torch.Tensor:
    act = GELUS["exact"]
    h = act(dot(h1, mlp["w2"]) + mlp["b2"])
    return torch.sigmoid(dot(h, mlp["w3"]) + mlp["b3"])


CASES = [(73, 64), (73, 128), (413, 64), (413, 128)]


@pytest.mark.parametrize("nfeat,hidden", CASES)
def test_k3_first_layer_in_3xtf32_holds_fp32(nfeat, hidden):
    """K3: x·W1 + b1, the GELU and the tail, every dot in 3xTF32, against
    the plain MLP (fp32 dots)."""
    x, mlp = _inputs(nfeat, hidden, seed=nfeat + hidden)
    act = GELUS["exact"]
    want = _tail(act(_dot(x, mlp["w1"]) + mlp["b1"]), mlp, _dot)
    got = _tail(act(dot3(x, mlp["w1"]) + mlp["b1"]), mlp, dot3)
    err = float((got - want).abs().max())
    assert err <= TOL, err
    # the model departs from fp32 at all: the dropped term is visible
    assert not torch.equal(dot3(x, mlp["w1"]), _dot(x, mlp["w1"]))


@pytest.mark.parametrize("nfeat,hidden", CASES)
def test_k4_tail_in_3xtf32_holds_fp32(nfeat, hidden):
    """K4: the tail of the fp32 first-layer accumulator (x·W1 + b1, as
    ``first_layer_acc`` leaves it), W2 and W3 in 3xTF32, against
    ``mlp_tail_plain``."""
    x, mlp = _inputs(nfeat, hidden, seed=2 * nfeat + hidden)
    acc = (_dot(x, mlp["w1"]) + mlp["b1"]).reshape(32, NPIX // 32, hidden)
    want = tv3.mlp_tail_plain(acc, mlp["w2"], mlp["b2"], mlp["w3"],
                              mlp["b3"])
    got = _tail(GELUS["exact"](acc), mlp, dot3)
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= TOL, err


def test_tf32_rounds_to_nearest_ties_away():
    """The model's rounding: 10 mantissa bits kept, halves away from 0."""
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0 ** -10  # TF32's unit in the last place at 1
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 4,
                      1.0 + 3 * ulp / 4], dtype=torch.float32)
    got = tf32(x)
    assert got.tolist() == [1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + ulp]
    assert torch.equal(tf32(one), one)
