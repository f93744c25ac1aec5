"""Tiny-MLP decoder (port of ``nic.models.mlp``).

Linear(F→H) → GELU → Linear(H→H) → GELU → Linear(H→3) → sigmoid, with
exact-erf GELUs. Weights are kept in the JAX package's ``[in, out]``
layout (not ``nn.Linear``'s ``[out, in]``): a transposed load still gives
a plausible image, so the layout is fixed at the public boundary and the
tests compare against JAX outputs. The functions take any mapping with
keys ``w1 b1 w2 b2 w3 b3``; :class:`MLPDecoder` is one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MLPDecoder", "init_mlp", "apply_mlp", "apply_mlp_tail",
           "mlp_param_bits"]

PARAM_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


class MLPDecoder(nn.Module):
    """The decoder's six parameters, ``w*`` of shape ``[in, out]``.

    ``mlp["w2"]`` indexes a parameter by name, so the module goes wherever
    the functions below take a parameter mapping."""

    def __init__(self, params: dict, requires_grad: bool = True):
        super().__init__()
        for name in PARAM_NAMES:
            self.register_parameter(
                name, nn.Parameter(params[name], requires_grad=requires_grad))

    def __getitem__(self, name: str) -> torch.Tensor:
        if name not in PARAM_NAMES:
            raise KeyError(name)
        return getattr(self, name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_mlp(self, x)


def _linear_init(generator: torch.Generator, fan_in: int, fan_out: int,
                 dtype: torch.dtype):
    """U(±1/√fan_in) weights and bias, torch.nn.Linear's default bound."""
    bound = 1.0 / math.sqrt(fan_in)

    def draw(*shape):
        u = torch.rand(shape, generator=generator, dtype=dtype,
                       device=generator.device)
        return (2.0 * u - 1.0) * bound

    return draw(fan_in, fan_out), draw(fan_out)


def init_mlp(generator: torch.Generator, in_features: int, hidden: int,
             out_features: int = 3, *, device,
             dtype: torch.dtype = torch.float32) -> MLPDecoder:
    w1, b1 = _linear_init(generator, in_features, hidden, dtype)
    w2, b2 = _linear_init(generator, hidden, hidden, dtype)
    w3, b3 = _linear_init(generator, hidden, out_features, dtype)
    params = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3}
    return MLPDecoder({k: v.to(device) for k, v in params.items()})


def _dot(a: torch.Tensor, w: torch.Tensor, matmul_dtype) -> torch.Tensor:
    """``a @ w``; with ``matmul_dtype`` the inputs are rounded to it and the
    products summed in fp32 (JAX's ``preferred_element_type=float32``)."""
    if matmul_dtype is None:
        return a @ w
    return a.to(matmul_dtype).float() @ w.to(matmul_dtype).float()


def _layer(params, x: torch.Tensor, i: int, matmul_dtype) -> torch.Tensor:
    b = params[f"b{i}"]
    return _dot(x, params[f"w{i}"], matmul_dtype) + (
        b if matmul_dtype is None else b.float())


def apply_mlp_tail(params, acc: torch.Tensor, matmul_dtype=None):
    """Layers 2..3 on a first-layer preactivation ``acc`` [N, H]. Same
    ``matmul_dtype`` semantics as :func:`apply_mlp`."""
    h = F.gelu(acc if matmul_dtype is None else acc.float())
    h = F.gelu(_layer(params, h, 2, matmul_dtype))
    return torch.sigmoid(_layer(params, h, 3, matmul_dtype))


def apply_mlp(params, x: torch.Tensor, matmul_dtype=None) -> torch.Tensor:
    """x: [N, F] → [N, 3] in (0, 1). ``matmul_dtype`` (e.g. bf16) rounds
    only the dot inputs and sums in fp32; biases, GELU and sigmoid stay
    fp32."""
    return apply_mlp_tail(params, _layer(params, x, 1, matmul_dtype),
                          matmul_dtype)


def mlp_param_bits(params) -> int:
    """Payload bits of the decoder weights (for bpp accounting)."""
    return sum(int(params[k].numel()) * params[k].element_size() * 8
               for k in PARAM_NAMES)
