"""The two-stage v3 decode: the folded first-layer accumulator in
PyTorch, then the MLP tail in one CUDA kernel (port of
``nic.kernels.decode_fused_v3``).

:func:`decode_image_fused_v3` computes ``first_layer_acc`` (the folded
decode up to the first GELU, ``nic_torch.grids.fastdecode``) as an
[S, S, H] tensor in device memory, and :func:`mlp_tail` runs GELU → W2 →
GELU → W3 → sigmoid over it: dots on ``w2.dtype`` inputs with fp32 sums,
the A&S erf GELU. The accumulator makes the trade explicit: at 2048² in
fp32 it is 1.07 GB written and read back, which K1 keeps in registers.

A CUDA tensor launches ``csrc/decode_fused_v3.cu`` (at H = 64 and 128
``mlp_tail_mma``: K1's tensor-core tail, ``csrc/decode_mma.cuh``, on
accumulator rows streamed by asynchronous copies; fp32 dots as three TF32
products, the GELU's exponential and reciprocal from the hardware); a CPU
tensor runs :func:`mlp_tail_plain`, the same tail in torch ops (the
port's A&S ``_gelu_exact``, as K1's plain version), so the two differ in
summation order and by a few ulp.
"""

from __future__ import annotations

import torch

from nic_torch.grids.fastdecode import first_layer_acc
from nic_torch.kernels._widths import (decode_body, kernel_width,
                                       pad_hidden, pad_mlp)
from nic_torch.kernels.decode_fused_v2 import GELUS, _dot
from nic_torch.models.mlp import PARAM_NAMES

__all__ = ["decode_image_fused_v3", "mlp_tail", "mlp_tail_plain"]

_FLOATS = (torch.float32, torch.bfloat16)
# the per-pixel bodies by their id in csrc/decode_fused_v3.cu (enum Body)
_BODY_IDS = {"mlp_tail_kernel": 0, "mlp_tail_mma": 1, "mlp_tail_wide": 2}


def _check(acc, w2, b2, w3, b3) -> None:
    tensors = (acc, w2, b2, w3, b3)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("mlp_tail: operands on different devices: "
                         f"{sorted(str(t.device) for t in tensors)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mlp_tail: operands must be contiguous")
    if acc.dtype not in _FLOATS or w2.dtype not in _FLOATS:
        raise ValueError(f"mlp_tail takes float32 or bfloat16 accumulators "
                         f"and weights, not {acc.dtype} and {w2.dtype}")
    if w3.dtype != w2.dtype:
        raise ValueError("w2 and w3 must share one dtype")
    hidden = acc.shape[-1]
    want = {"w2": (hidden, hidden), "b2": (hidden,), "w3": (hidden, 3),
            "b3": (3,)}
    for name, t in zip(("w2", "b2", "w3", "b3"), tensors[1:]):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want[name]}")


def mlp_tail_plain(acc, w2, b2, w3, b3) -> torch.Tensor:
    """The kernel's tail in torch ops: [.., H] → [.., 3] fp32."""
    _check(acc, w2, b2, w3, b3)
    act = GELUS["exact"]
    h = act(acc.float())
    h = act(_dot(h, w2) + b2.float())
    return torch.sigmoid(_dot(h, w3) + b3.float())


def mlp_tail(acc, w2, b2, w3, b3, *, block: int = 4096,
             out_dtype=torch.float32) -> torch.Tensor:
    """[S, S, H] pre-GELU accumulator → [S, S, 3] (K4). ``block``: the
    pixels each CUDA block covers (the JAX pipeline block, halved until it
    divides S²).

    A CUDA tensor launches the hand-written kernel (and raises if it does
    not build or launch) with the body
    :func:`~nic_torch.kernels._widths.decode_body` names: the tensor-core
    ``mlp_tail_mma`` at H = 64 and 128 (dots by ``w2.dtype``: bf16, or
    fp32 as three TF32 products), the CUDA-core body at H = 16 (which
    alone reads ``block``), ``mlp_tail_wide`` at the multiples of 64 past
    128; another width is zero-padded to the next of those (the
    accumulator too: a copy). A CPU tensor runs :func:`mlp_tail_plain`. ``mlp_tail.launches`` counts
    kernel launches."""
    if acc.dim() != 3:
        raise ValueError(f"acc must be [S, S, H], not {tuple(acc.shape)}")
    _check(acc, w2, b2, w3, b3)
    s, cols, hidden = acc.shape
    npix = s * cols
    while npix % block:
        block //= 2
    if acc.device.type == "cpu":
        return mlp_tail_plain(acc, w2, b2, w3, b3).to(out_dtype)
    if acc.device.type != "cuda":
        raise ValueError(f"mlp_tail runs on cuda or cpu, not {acc.device}")
    width = kernel_width("decode_v3", hidden)
    if width != hidden:
        _, _, w2, b2, w3, b3 = pad_mlp(None, None, w2, b2, w3, b3, width)
        return mlp_tail(pad_hidden(acc, width), w2, b2, w3, b3, block=block,
                        out_dtype=out_dtype)
    if acc.data_ptr() % 16:
        raise ValueError("acc must be 16-byte aligned")
    from nic_torch.kernels import _build

    lib = _build.load()
    # fp32 weights for the kernel; bf16 values upcast exactly
    w = [t.float().contiguous() for t in (w2, b2, w3, b3)]
    out = torch.empty((s, cols, 3), dtype=torch.float32, device=acc.device)
    dot_bf16 = w2.dtype == torch.bfloat16
    body = decode_body("decode_v3", hidden, "bf16" if dot_bf16 else "fp32")
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        rc = lib.nic_mlp_tail(
            acc.data_ptr(), *(t.data_ptr() for t in w), out.data_ptr(),
            npix, hidden, block, int(acc.dtype == torch.bfloat16),
            int(dot_bf16), _BODY_IDS[body], stream)
    if rc != 0:
        raise RuntimeError("decode_fused_v3 kernel launch failed: "
                           + lib.nic_cuda_error_string(rc).decode())
    mlp_tail.launches += 1
    return out.to(out_dtype)


mlp_tail.launches = 0


def decode_image_fused_v3(fp, mlp, mip_level: int, *, image_size: int,
                          mip_to_level: dict, pe_channels: int,
                          use_tri_pe: bool = True, sparse_g0: bool = False,
                          g1_quirk: bool = True, dtype=None,
                          out_dtype=torch.float32) -> torch.Tensor:
    """Full-image 2D decode: the folded first-layer accumulator, then the
    MLP tail kernel → [N, N, 3]. ``dtype`` (e.g. bf16) rounds the grids
    and the MLP to it first, as the JAX package does."""
    if dtype is not None:
        fp = tuple(g.to(dtype) for g in fp)
        mlp = {k: mlp[k].to(dtype) for k in PARAM_NAMES}
    acc = first_layer_acc(
        fp, mlp, mip_level, image_size=image_size, mip_to_level=mip_to_level,
        pe_channels=pe_channels, use_tri_pe=use_tri_pe, ndim=2,
        sparse_g0=sparse_g0, g1_quirk=g1_quirk)
    return mlp_tail(acc.contiguous(), mlp["w2"], mlp["b2"], mlp["w3"],
                    mlp["b3"], out_dtype=out_dtype)
