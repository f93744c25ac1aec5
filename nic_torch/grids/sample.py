"""Grid corner sampling and the decoder-input assembly (port of
``nic.grids.sample``, 2D).

A crop of n×n pixels at integer origin (o0, o1) samples the G0 grid at
``t = (arange(n) + o)·step`` per axis: the four corners ``floor(t) +
(0|1)`` are fed to the MLP unweighted. G1 sits at half resolution:
``t1 = t/2``, its four corners are summed with bilinear weights, except
that the reference skips the weights when ``step == 2`` (G1 coordinates
then land on nodes and the corners are summed raw; ``tf_g1_quirk``).

Decoder-input row layout, as in the JAX package:

    [ G0 corner (0,0) | (0,1) | (1,0) | (1,1) | Σ G1 corners | PE (2·pe) | lod ]

Corner order is ``itertools.product((0, 1), repeat=2)`` over (row, col)
offsets. Here a batch of crops is assembled at once (the JAX package vmaps
one origin at a time); autograd gives the grid gradient (the backward of
the corner indexing is a scatter-add), for either ``grid_vjp`` setting of
the JAX package, whose two VJPs compute the same values. The 3D corners
(methods 3/4) come with ROADMAP.md queue 1, item 10.
"""

from __future__ import annotations

import itertools

import torch

from nic_torch.core.encodings import sinusoidal_pe, triangular_pe

__all__ = ["effective_pe_flags", "EVEN_PARITY_CORNERS_3D", "axis_coords",
           "corner_features", "interp_weights", "apply_g1_weights",
           "decoder_input"]


def effective_pe_flags(compression_method: int, ndim: int,
                       tf_use_tri_pe: bool) -> tuple[bool, bool]:
    """(use_tri_pe, sparse_g0) from the training configuration: method 4
    uses the sparse 4-corner G0 with sinusoidal PE, 3D method 3 uses
    triangular PE, otherwise ``tf_use_tri_pe`` decides."""
    sparse_g0 = compression_method == 4
    if sparse_g0:
        use_tri_pe = False
    elif ndim == 3:
        use_tri_pe = True
    else:
        use_tri_pe = bool(tf_use_tri_pe)
    return use_tri_pe, sparse_g0


# method-4 sparse G0: the four even-parity cube corners, in the reference's
# order
EVEN_PARITY_CORNERS_3D = ((0, 0, 0), (0, 1, 1), (1, 0, 1), (1, 1, 0))


def _g1_weights_active(step: float, quirk: bool = True) -> bool:
    """G1 interpolation weights are applied unless ``int(1 // (step/2)) ==
    1``, i.e. they are skipped exactly when step == 2 (the reference's
    raw-sum quirk); ``quirk=False`` always applies them."""
    if not quirk:
        return True
    return int(1 // (step / 2)) != 1


def axis_coords(origin: torch.Tensor, step: float, n: int):
    """Continuous G0 coordinates ``(arange(n) + origin)·step`` for a batch
    of origins ``[B]`` → (t [B, n] float32, floor(t) [B, n] int64)."""
    origin = torch.as_tensor(origin)
    ar = torch.arange(n, dtype=torch.float32, device=origin.device)
    t = (ar[None, :] + origin.to(torch.float32)[:, None]) * step
    return t, torch.floor(t).long()


def corner_features(grid: torch.Tensor, idxs, offsets) -> dict:
    """Lattice corners of ``grid`` [C, S0, S1] for per-axis index batches
    ``idxs`` = (i0 [B, n0], i1 [B, n1]) → {offset: [C, B, n0, n1]}."""
    i0, i1 = idxs
    return {tuple(off): grid[:, (i0 + off[0])[:, :, None],
                             (i1 + off[1])[:, None, :]]
            for off in offsets}


def interp_weights(fracs, offset) -> torch.Tensor:
    """Bilinear weight Π_k (frac_k if offset_k else 1 − frac_k) for
    per-axis fractions (f0 [B, n0], f1 [B, n1]) → [B, n0, n1]."""
    f0, f1 = fracs
    w0 = f0 if offset[0] else 1.0 - f0
    w1 = f1 if offset[1] else 1.0 - f1
    return w0[:, :, None] * w1[:, None, :]


def apply_g1_weights(corners: dict, fracs, step: float,
                     quirk: bool = True) -> torch.Tensor:
    """Σ over G1 corners, bilinearly weighted unless the step == 2 quirk
    disables the weights (then the corners are summed raw)."""
    if _g1_weights_active(step, quirk):
        total = None
        for off, g in corners.items():
            term = g * interp_weights(fracs, off)[None]
            total = term if total is None else total + term
        return total
    return sum(corners.values())


def decoder_input(fp, fl: int, origins: torch.Tensor, step: float, n: int, *,
                  pe_channels: int, mip_level: int, ndim: int = 2,
                  use_tri_pe: bool = True, sparse_g0: bool = False,
                  g1_quirk: bool = True) -> torch.Tensor:
    """Decoder-input rows for crops at ``origins`` [B, 2] (or one origin
    [2]) → [B, n², F] (or [n², F]) float32, F = 5·C + 2·pe + 1."""
    if ndim != 2 or sparse_g0:
        raise NotImplementedError(
            "decoder_input: the 3D and sparse-G0 corners (methods 3/4) are "
            "not ported yet (ROADMAP.md, queue 1, item 10)")
    origins = torch.as_tensor(origins)
    single = origins.dim() == 1
    if single:
        origins = origins[None]
    g0, g1 = fp[fl * 2], fp[fl * 2 + 1]
    c = g0.shape[0]
    b = origins.shape[0]
    npts = n * n

    ts, i0s = zip(*(axis_coords(origins[:, d], step, n) for d in range(2)))
    offsets = tuple(itertools.product((0, 1), repeat=2))
    g0_corners = corner_features(g0, i0s, offsets)
    t1s = [t / 2.0 for t in ts]
    i1s = [torch.floor(t1).long() for t1 in t1s]
    f1s = [t1 - i1.to(torch.float32) for t1, i1 in zip(t1s, i1s)]
    g1_sum = apply_g1_weights(corner_features(g1, i1s, offsets), f1s, step,
                              g1_quirk)                      # [C, B, n, n]

    # PE over the continuous G1-resolution coordinates, row-major per crop
    coords = torch.stack([t1s[0][:, :, None].expand(b, n, n).reshape(-1),
                          t1s[1][:, None, :].expand(b, n, n).reshape(-1)])
    pe_fn = triangular_pe if use_tri_pe else sinusoidal_pe
    pe = pe_fn(coords, pe_channels).reshape(-1, b, npts)    # [2·pe, B, N]
    lod = torch.full((1, b, npts), float(mip_level), dtype=torch.float32,
                     device=g0.device)
    feats = [g0_corners[off].reshape(c, b, npts) for off in offsets]
    feats += [g1_sum.reshape(c, b, npts), pe, lod]
    x = torch.cat(feats, dim=0).permute(1, 2, 0)            # [B, N, F]
    return x[0] if single else x
