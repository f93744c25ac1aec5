"""Grid corner sampling and the decoder-input assembly (port of
``nic.grids.sample``, 2D and 3D).

A crop of n^d pixels at integer origin o samples the G0 grid at ``t =
(arange(n) + o)·step`` per axis: the corners ``floor(t) + (0|1)`` are fed
to the MLP unweighted (all 2^d of them; method 4's sparse G0 takes the
four even-parity cube corners). G1 sits at half resolution: ``t1 = t/2``,
its 2^d corners are summed with multilinear weights, except that the
reference skips the weights when ``step == 2`` (G1 coordinates then land
on nodes and the corners are summed raw; ``tf_g1_quirk``).

Decoder-input row layout, as in the JAX package:

    [ G0 corners (C each) | Σ G1 corners (C) | PE (d·pe) | lod ]

Corner order is ``itertools.product((0, 1), repeat=d)`` over axis offsets
(``EVEN_PARITY_CORNERS_3D`` for the sparse G0). Here a batch of crops is
assembled at once (the JAX package vmaps one origin at a time); autograd
gives the grid gradient (the backward of the corner indexing is a
scatter-add), for either ``grid_vjp`` setting of the JAX package, whose
two VJPs compute the same values.
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
    """Lattice corners of ``grid`` [C, S0, S1(, S2)] for per-axis index
    batches ``idxs`` = (i0 [B, n0], i1 [B, n1](, i2 [B, n2])) → {offset:
    [C, B, n0, n1(, n2)]}."""
    nd = len(idxs)

    def axis(i, d):  # [B, n] → broadcast along output axis d
        shape = [i.shape[0]] + [1] * nd
        shape[1 + d] = i.shape[1]
        return i.reshape(shape)

    return {tuple(off): grid[(slice(None),) + tuple(
        axis(i + o, d) for d, (i, o) in enumerate(zip(idxs, off)))]
        for off in offsets}


def interp_weights(fracs, offset) -> torch.Tensor:
    """Multilinear weight Π_k (frac_k if offset_k else 1 − frac_k) for
    per-axis fractions (f0 [B, n0], f1 [B, n1](, f2 [B, n2])) → [B, n0,
    n1(, n2)]."""
    nd = len(fracs)
    w = None
    for d, (f, o) in enumerate(zip(fracs, offset)):
        shape = [f.shape[0]] + [1] * nd
        shape[1 + d] = f.shape[1]
        fd = (f if o else 1.0 - f).reshape(shape)
        w = fd if w is None else w * fd
    return w


def apply_g1_weights(corners: dict, fracs, step: float,
                     quirk: bool = True) -> torch.Tensor:
    """Σ over G1 corners, multilinearly weighted unless the step == 2
    quirk disables the weights (then the corners are summed raw)."""
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
    """Decoder-input rows for crops at ``origins`` [B, ndim] (or one origin
    [ndim]) → [B, n^ndim, F] (or [n^ndim, F]) float32, F = C·(corners + 1)
    + pe·ndim + 1; rows are row-major per crop (axis 0 outermost), on the
    grids' device. A corner past a grid's last node raises (the JAX
    gather reads NaN there; the 3D trainer pads the grids of a LOD whose
    crops reach that far, ``nic_torch.train.ntc.pad_to_reach``)."""
    if ndim not in (2, 3):
        raise ValueError(f"decoder_input: ndim must be 2 or 3, not {ndim}")
    if sparse_g0 and ndim != 3:
        raise ValueError("the sparse 4-corner G0 (method 4) is 3D only")
    origins = torch.as_tensor(origins)
    single = origins.dim() == 1
    if single:
        origins = origins[None]
    g0, g1 = fp[fl * 2], fp[fl * 2 + 1]
    c = g0.shape[0]
    b = origins.shape[0]
    npts = n**ndim
    origins = origins.to(g0.device)

    ts, i0s = zip(*(axis_coords(origins[:, d], step, n) for d in range(ndim)))
    g0_offsets = (EVEN_PARITY_CORNERS_3D if sparse_g0
                  else tuple(itertools.product((0, 1), repeat=ndim)))
    g1_offsets = tuple(itertools.product((0, 1), repeat=ndim))
    g0_corners = corner_features(g0, i0s, g0_offsets)
    t1s = [t / 2.0 for t in ts]
    i1s = [torch.floor(t1).long() for t1 in t1s]
    f1s = [t1 - i1.to(torch.float32) for t1, i1 in zip(t1s, i1s)]
    g1_sum = apply_g1_weights(corner_features(g1, i1s, g1_offsets),
                              f1s, step, g1_quirk)       # [C, B, n..]

    # PE over the continuous G1-resolution coordinates, row-major per crop
    grid = torch.meshgrid(*(torch.arange(n, device=origins.device),)
                          * ndim, indexing="ij")
    coords = torch.stack([t1s[d][:, grid[d].reshape(-1)].reshape(-1)
                          for d in range(ndim)])         # [ndim, B·N]
    pe_fn = triangular_pe if use_tri_pe else sinusoidal_pe
    pe = pe_fn(coords, pe_channels).reshape(-1, b, npts)    # [pe·nd, B, N]
    lod = torch.full((1, b, npts), float(mip_level), dtype=torch.float32,
                     device=g0.device)
    feats = [g0_corners[off].reshape(c, b, npts) for off in g0_offsets]
    feats += [g1_sum.reshape(c, b, npts), pe, lod]
    x = torch.cat(feats, dim=0).permute(1, 2, 0)            # [B, N, F]
    return x[0] if single else x
