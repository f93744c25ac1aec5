"""The hidden widths the CUDA kernels are built for, and the zero padding
that runs any narrower width on them.

Each CUDA source instantiates its kernels for a few hidden widths H (the
``.cu`` files dispatch on exactly these). A model whose H lies between
two of them runs at the next one up: the wrapper zero-pads the hidden
axis, launches, and slices the results back. The padding is exact:

- a padded unit gets zero first-layer weights (W1 columns, b1, the
  folded P/C1 planes or volumes), so its z1 is 0;
- its outgoing weights (W2 rows, W3 rows) are zero, so whatever its
  activation (the poly GELU gives 6.06e-6 at 0) adds exactly 0
  downstream, and W2's zero columns and b2 keep its second-layer unit at
  0 as well;
- in the backward its dz2 and dz1 are exactly 0, so it adds nothing to
  the real units' gradients, and its own gradients are sliced off;
- the counter-hash feature noise indexes (pixel, feature), never H, so
  the noise stream is unchanged.

A width that is already instantiated passes through untouched: no copy
and no launch (the flagship's H = 64). Feature counts F have no bound in
any kernel (the ``.cu`` files stage what fits in shared memory and read
the rest from device memory).

Past the widest built width, the families whose JAX gates check no
hidden width (K6/K7/K9 ``train_mlp`` and every decode) take any H up to
:data:`WIDEST`: it runs at the next multiple of 64, by the same padding,
on a body that walks the hidden axis in 64-unit column blocks with H a
runtime value (``mlp_pixel_wide``, ``decode_v2_mma``, ``decode_z1mm_wide``,
``decode_v1_wide``, ``mlp_tail_wide``). Those bodies hold a tile of
pixels' activations in shared memory as [rows][H] and shrink the tile as
H grows; :data:`WIDEST` is the last multiple of 64 at which a 16-pixel
tile still fits (the ``.cu`` files refuse past it). K11 (``train_ff``,
2H ≤ 128) and K12 (``train_ff3``, H ≤ 128) keep their gates' bounds.

The train families have two per-pixel bodies each at the built widths,
which compute the same step: one on the bf16 tensor cores (``*_mma``,
built at H = 64 for bf16 dot inputs) and one for fp32 dots: K11's and
K12's on the tensor cores as three TF32 products a dot (``ff_pixel_tf32``,
``ff3_pixel_tf32``, at H = 64), K6/K7/K9's on the fp32 CUDA cores
(``mlp_pixel``); K12 runs its CUDA-core body ``ff3_pixel`` at H = 128 in
both modes. K6/K7/K9 (``train_mlp``) run bf16
dots from H = 128 up to :data:`WIDEST_MMA` on a wide tensor-core body
(``mlp_pixel_mma_wide``, the 64-unit column-block walk of
``mlp_pixel_wide`` with every product on the tensor cores), and fp32 dots
at H = 128 on ``mlp_pixel``, past it on ``mlp_pixel_wide`` (so do bf16
dots past :data:`WIDEST_MMA`). :func:`kernel_body` is the one place that
picks between them; the wrappers pass its choice to the ``.cu`` entry point,
which runs that body or refuses the call, and size their grids by
:data:`BODY_BLOCKS_PER_SM`. :func:`decode_body` does the same for the
decodes by plane mode (:data:`DECODE_BODIES`): K1/K5 run ``decode_v2_mma``
on the tensor cores at H ≥ 64 in every plane mode (fp32 through the
three-product TF32 split) and their CUDA-core body at H = 16; K3 and K4
run ``decode_v1_mma`` and ``mlp_tail_mma`` (the same tensor-core tail,
``csrc/decode_mma.cuh``) at H = 64 and 128, their CUDA-core bodies at
H = 16 and their wide bodies past 128; K2 runs ``decode_z1mm_mma`` (its
z1 product, a warp's 16 image rows of one column against the S rows
they read, and that tail, on the tensor cores) at H = 64 and 128 in its
three plane modes, a narrower model zero-padded to 64, and its wide body
past 128. Each decode wrapper passes the body's id (its ``_BODY_IDS``)
as the entry point's ``body`` argument.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["KERNEL_WIDTHS", "WIDEST", "WIDE", "WIDE_MMA", "WIDEST_MMA",
           "KERNEL_BODIES",
           "DECODE_BODIES", "PLANE_MODES", "BODY_BLOCKS_PER_SM",
           "kernel_width", "kernel_body", "decode_body", "body_blocks",
           "pad_hidden", "pad_mlp", "unpad", "unpad_all"]

# hidden widths each CUDA source instantiates, by the wrapper family
KERNEL_WIDTHS = {
    "decode_v2": (16, 64),        # K1 and K5, csrc/decode_fused_v2.cu
    "decode_z1mm": (64, 128),     # K2, csrc/decode_z1mm.cu
    "decode_v1": (16, 64, 128),   # K3, csrc/decode_fused.cu
    "decode_v3": (16, 64, 128),   # K4, csrc/decode_fused_v3.cu
    "train_ff": (64,),            # K11, csrc/train_fused_ff.cu
    "train_ff3": (64, 128),       # K12, csrc/train_fused_ff3.cu
    "train_mlp": (64, 128),       # K6, K7, K9, csrc/train_fused.cu
}


# the widest hidden width of the families whose gates check no width: the
# last multiple of 64 at which the wide body's 16-pixel tile fits in the
# 227 KB of shared memory a block may hold (each .cu states its layout)
WIDEST = {
    "train_mlp": 1344,    # mlp_pixel_wide: 4 (37 H + 6436) bytes
    "decode_v2": 2432,    # decode_v2_mma, fp32, one warp: 80 H + 37,584 bytes
    "decode_z1mm": 3264,  # decode_z1mm_wide: 4 (16 H + 5280) bytes
    "decode_v1": 3264,    # decode_v1_wide: the same layout
    "decode_v3": 3264,    # mlp_tail_wide: the same layout
}
WIDE = "wide"  # the width key of the bodies past the built widths

# the widest hidden width of the wide tensor-core train body: a 64-pixel
# tile's z1, z2 (fp32) and h1b, dz2b (bf16) [64][H + 8] beside two 64 x 64
# bf16 weight tiles fit in the 227 KB of shared memory up to H = 256
# (229,904 bytes; csrc/train_fused_mma_wide.cu wide_mma_smem)
WIDEST_MMA = {"train_mlp": 256}
WIDE_MMA = "wide_mma"  # its width key: past the built widths, up to it

# the per-pixel CUDA body each train family runs, by (built width, WIDE or
# WIDE_MMA, bf16 dot inputs): the bf16 tensor-core bodies take bf16 dots at
# H = 64 and, for train_mlp, from 128 up to WIDEST_MMA; K11's and K12's
# 3xTF32 tensor-core bodies take fp32 dots at H = 64
KERNEL_BODIES = {
    "train_ff": {(64, True): "ff_pixel_mma", (64, False): "ff_pixel_tf32"},
    "train_ff3": {(64, True): "ff3_pixel_mma", (64, False): "ff3_pixel_tf32",
                  (128, True): "ff3_pixel", (128, False): "ff3_pixel"},
    "train_mlp": {(64, True): "mlp_pixel_mma", (64, False): "mlp_pixel",
                  (128, True): "mlp_pixel_mma_wide",
                  (128, False): "mlp_pixel",
                  (WIDE_MMA, True): "mlp_pixel_mma_wide",
                  (WIDE, True): "mlp_pixel_wide",
                  (WIDE, False): "mlp_pixel_wide"},
}

# the plane modes of the folded decodes (the .cu's PlaneMode order); K3
# and K4 take "fp32" and "bf16" (grid or accumulator and dot dtype)
PLANE_MODES = ("fp32", "bf16", "i16", "surgical")

# the per-pixel CUDA body each decode family runs, by (built width or
# WIDE, plane mode). K1/K5 keep their CUDA-core body at H = 16: at 2048²
# it took 0.3784 ms in fp32·exact and 0.2603 in bf16·poly, against 2.0245
# and 1.2582 for the same model zero-padded to 64 onto decode_v2_mma
# (chip_smoke.py phase 26; H100 80GB HBM3, 700 W). K3 and K4 run their
# tensor-core bodies (on K1's tail, csrc/decode_mma.cuh) at H = 64 and 128
# in fp32 (3xTF32) and bf16, their CUDA-core bodies at H = 16 and their
# wide bodies past 128. K2 runs decode_z1mm_mma at H = 64 and 128 (fp32
# planes by two TF32 products and a 3xTF32 tail, bf16 and surgical with
# bf16 dots) and its wide body past 128
DECODE_BODIES = {
    "decode_v2": {**{(16, m): "decode_fused_v2_kernel" for m in PLANE_MODES},
                  **{(w, m): "decode_v2_mma" for w in (64, WIDE)
                     for m in PLANE_MODES}},
    "decode_z1mm": {**{(w, m): "decode_z1mm_mma" for w in (64, 128)
                       for m in PLANE_MODES if m != "i16"},
                    **{(WIDE, m): "decode_z1mm_wide" for m in PLANE_MODES
                       if m != "i16"}},
    "decode_v1": {**{(16, m): "decode_fused_v1_kernel" for m in ("fp32",
                                                                 "bf16")},
                  **{(w, m): "decode_v1_mma" for w in (64, 128)
                     for m in ("fp32", "bf16")},
                  **{(WIDE, m): "decode_v1_wide" for m in ("fp32", "bf16")}},
    "decode_v3": {**{(16, m): "mlp_tail_kernel" for m in ("fp32", "bf16")},
                  **{(w, m): "mlp_tail_mma" for w in (64, 128)
                     for m in ("fp32", "bf16")},
                  **{(WIDE, m): "mlp_tail_wide" for m in ("fp32", "bf16")}},
}

# the blocks per SM each body is built for (its __launch_bounds__); a
# wrapper launches that many per SM, and where shared memory holds fewer
# (mlp_pixel_mma at F > 80) the rest run as a second wave. The 3xTF32
# bodies' fp32 tiles and hi/lo weights take ~206 KB (K11, F = 73) and
# ~226 KB (K12, F = 127): one block of 8 warps an SM
BODY_BLOCKS_PER_SM = {"ff_pixel_mma": 2, "ff_pixel_tf32": 1, "ff3_pixel": 1,
                      "ff3_pixel_mma": 2, "ff3_pixel_tf32": 1,
                      "mlp_pixel": 1,
                      "mlp_pixel_mma": 2, "mlp_pixel_wide": 1,
                      "mlp_pixel_mma_wide": 1}


def kernel_width(family: str, hidden: int) -> int:
    """The width that runs hidden width ``hidden`` for the kernels of
    ``family`` (a key of :data:`KERNEL_WIDTHS`): the smallest instantiated
    one ≥ ``hidden`` or, past them, for the families of :data:`WIDEST`,
    the next multiple of 64. Raises ValueError past the widest."""
    widths = KERNEL_WIDTHS[family]
    fits = [w for w in widths if 1 <= hidden <= w]
    if fits:
        return fits[0]
    top = WIDEST.get(family)
    if top is not None and max(widths) < hidden <= top:
        return -(-hidden // 64) * 64
    if top is not None and hidden > top:
        raise ValueError(f"the {family} CUDA kernels take hidden widths up "
                         f"to {top} (their widest, where a 16-pixel tile "
                         f"still fits in shared memory), not {hidden}")
    raise ValueError(f"the {family} CUDA kernels are built for hidden "
                     f"widths {widths} (narrower ones are zero-padded to "
                     f"the next), not {hidden}")


def _width_key(family: str, hidden: int):
    width = kernel_width(family, hidden)
    return width if width in KERNEL_WIDTHS[family] else WIDE


def kernel_body(family: str, hidden: int, bf16: bool) -> str:
    """The per-pixel CUDA body that runs hidden width ``hidden`` for the
    train kernels of ``family`` (a key of :data:`KERNEL_BODIES`) with bf16
    (True) or fp32 (False) dot inputs."""
    key = _width_key(family, hidden)
    if key == WIDE and bf16 and (kernel_width(family, hidden)
                                 <= WIDEST_MMA.get(family, 0)):
        key = WIDE_MMA
    return KERNEL_BODIES[family][(key, bool(bf16))]


def decode_body(family: str, hidden: int, mode: str) -> str:
    """The per-pixel CUDA body that runs hidden width ``hidden`` for the
    decode kernels of ``family`` (a key of :data:`DECODE_BODIES`) in plane
    mode ``mode`` (:data:`PLANE_MODES`)."""
    key = (_width_key(family, hidden), mode)
    if key not in DECODE_BODIES[family]:
        raise ValueError(f"the {family} CUDA kernels take no {mode} planes")
    return DECODE_BODIES[family][key]


def body_blocks(body: str, tiles: int, device) -> int:
    """Blocks of a launch of ``body`` over ``tiles`` 128-pixel tiles on
    ``device``: its blocks per SM on every SM, at most one per tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(tiles, BODY_BLOCKS_PER_SM[body] * sms)


def pad_hidden(t: torch.Tensor | None, width: int, dims=(-1,)):
    """``t`` zero-padded at the end of each axis in ``dims`` to ``width``
    (the hidden axes), or ``t`` itself when they already have it."""
    if t is None:
        return None
    pad = [0] * (2 * t.dim())
    for d in dims:
        d = d % t.dim()
        pad[2 * (t.dim() - 1 - d) + 1] = width - t.shape[d]
    if not any(pad):
        return t
    return F.pad(t, pad)


def pad_mlp(w1, b1, w2, b2, w3, b3, width: int) -> tuple:
    """The MLP's parameters with the hidden axis zero-padded to ``width``:
    W1 [F, H] columns, b1, W2 [H, H] rows and columns, b2, W3 [H, 3]
    rows; b3 as it is. ``w1``/``b1`` may be None (kernels that take the
    first layer folded)."""
    return (pad_hidden(w1, width), pad_hidden(b1, width),
            pad_hidden(w2, width, (0, 1)), pad_hidden(b2, width),
            pad_hidden(w3, width, (0,)), b3)


def unpad(t: torch.Tensor | None, hidden: int, dims=(-1,)):
    """``t`` sliced back to the first ``hidden`` entries of each axis in
    ``dims`` (a view; ``t`` itself when nothing was padded)."""
    if t is None:
        return None
    idx = [slice(None)] * t.dim()
    for d in dims:
        idx[d] = slice(0, hidden)
    return t[tuple(idx)] if any(t.shape[d] != hidden for d in dims) else t


def unpad_all(outs, hidden: int, dims) -> tuple:
    """Each of ``outs`` sliced back by :func:`unpad` along its entry of
    ``dims`` (None: kept as it is, for values without a hidden axis)."""
    return tuple(t if d is None else unpad(t, hidden, d)
                 for t, d in zip(outs, dims))
