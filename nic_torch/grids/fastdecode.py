"""Folded first-layer decode (port of ``nic.grids.fastdecode``).

The decoder input concatenates gathered grid features, PE and a LOD
constant, so the MLP's first layer distributes over the parts and
commutes with gather and interpolation. The fold computes, once per
decode and on the grid,

    P[i, j]  = Σ_off G0[:, i+off0, j+off1] · W1_off      [cells.., H]
    C1[i, j] = G1[:, i, j] · W1_g1                        [S1.., H]

and the per-pixel first layer becomes a nearest sample of P, a
multilinear sample of C1, separable row/column PE vectors and a constant.
This is the plain decode of the port (the ``fast`` backend) and the
reference its CUDA kernel is held to. ndim-generic; rectangular ``n``;
the G1 step == 2 raw-sum quirk is kept. ``origin=`` places a tile or crop
of ``n`` samples at an integer lattice origin and ``planes=`` takes a
:func:`precompute_first_layer` result, so a caller that samples many tiles
(the tiled decode) or crops (the ``TRAIN_FORWARD=folded`` step) folds W1
once.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from nic_torch.core.encodings import sinusoidal_pe, triangular_pe
from nic_torch.grids.sample import EVEN_PARITY_CORNERS_3D, _g1_weights_active

__all__ = ["precompute_first_layer", "first_layer_acc", "fast_decode"]


def _axis_take_up(plane: torch.Tensor, e: int, n: int, axis: int,
                  origin: int = 0) -> torch.Tensor:
    """``plane`` sampled at floor((origin + arange(n)) · 2^e) along
    ``axis``: at origin 0 a repeat (e < 0) or a strided slice (e ≥ 0), no
    gather; elsewhere an index gather."""
    if origin != 0:
        t = (torch.arange(n, dtype=torch.float32, device=plane.device)
             + origin) * (2.0**e)
        return torch.index_select(plane, axis, torch.floor(t).long())
    if e < 0:
        up = torch.repeat_interleave(plane, 1 << (-e), dim=axis)
        return up.narrow(axis, 0, n)
    s = 1 << e
    index = [slice(None)] * plane.dim()
    index[axis] = slice(0, (n - 1) * s + 1, s)
    return plane[tuple(index)]


def precompute_first_layer(fp, fl: int, mlp, *, ndim: int, channels: int,
                           pe_channels: int, sparse_g0: bool = False):
    """Fold W1 into the grids. Returns (P, C1, w1_pe_blocks, w1_lod, b1)."""
    g0, g1 = fp[fl * 2], fp[fl * 2 + 1]
    w1 = mlp["w1"]  # [F, H]
    c = channels
    g0_offsets = (EVEN_PARITY_CORNERS_3D if sparse_g0
                  else tuple(itertools.product((0, 1), repeat=ndim)))
    n_corners = len(g0_offsets)

    cells = tuple(s - 1 for s in g0.shape[1:])
    p_plane = None
    for k, off in enumerate(g0_offsets):
        sl = g0
        for d, o in enumerate(off):
            sl = sl.narrow(1 + d, o, cells[d])
        term = torch.tensordot(sl, w1[k * c:(k + 1) * c], dims=([0], [0]))
        p_plane = term if p_plane is None else p_plane + term

    w_g1 = w1[n_corners * c:(n_corners + 1) * c]
    c1_plane = torch.tensordot(g1, w_g1, dims=([0], [0]))  # [S1.., H]

    base = (n_corners + 1) * c
    pe_blocks = [w1[base + d * pe_channels:base + (d + 1) * pe_channels]
                 for d in range(ndim)]
    w_lod = w1[base + ndim * pe_channels]
    return p_plane, c1_plane, pe_blocks, w_lod, mlp["b1"]


def first_layer_acc(fp, mlp, mip_level: int, *, image_size: int,
                    mip_to_level: dict, pe_channels: int,
                    use_tri_pe: bool = True, ndim: int = 2,
                    sparse_g0: bool = False, origin=None, n=None,
                    g1_quirk: bool = True, planes=None) -> torch.Tensor:
    """The pre-GELU first-layer accumulator ``[n.., H]`` of the folded
    decode (everything in :func:`fast_decode` before the MLP tail), for
    the ``n`` samples per axis from integer ``origin`` (default 0)."""
    fl = mip_to_level[mip_level]
    e = mip_level - (fl + 1) * 2
    channels = fp[fl * 2].shape[0]
    if n is None:
        n = image_size // (2**mip_level)
    ns = (n,) * ndim if isinstance(n, int) else tuple(n)
    origin = (0,) * ndim if origin is None else tuple(int(o) for o in origin)
    device = fp[0].device

    p_plane, c1_plane, pe_blocks, w_lod, b1 = (
        planes if planes is not None else precompute_first_layer(
            fp, fl, mlp, ndim=ndim, channels=channels,
            pe_channels=pe_channels, sparse_g0=sparse_g0))

    # G0 term: nearest sample of P at floor(t) per axis
    acc = p_plane
    for d in range(ndim):
        acc = _axis_take_up(acc, e, ns[d], axis=d, origin=origin[d])

    # G1 term: multilinear sample of C1 (or the step == 2 raw sum)
    step = 2.0**e
    t1s, i1s, f1s = [], [], []
    for d in range(ndim):
        t = (torch.arange(ns[d], dtype=torch.float32, device=device)
             + origin[d]) * (step / 2.0)
        i1 = torch.floor(t).long()
        t1s.append(t)
        i1s.append(i1)
        f1s.append(t - i1.to(torch.float32))
    # a rectangular image's coarsest G1 can end on its last sample's
    # coordinate (512×768 at mip 8: 3 columns on 2 nodes); the corner past
    # it, of weight 0, reads a zero node (JAX's gather reads NaN there)
    pad = []
    for d in reversed(range(ndim)):
        pad += [0, max(int(i1s[d].max()) + 2 - c1_plane.shape[d], 0)]
    if any(pad):
        c1_plane = F.pad(c1_plane, [0, 0] + pad)
    weights_on = _g1_weights_active(step, g1_quirk)
    for off in itertools.product((0, 1), repeat=ndim):
        g = c1_plane
        w = None
        for d, o in enumerate(off):
            g = torch.index_select(g, d, i1s[d] + o)
            if weights_on:
                fd = f1s[d] if o else (1.0 - f1s[d])
                shape = [1] * (ndim + 1)
                shape[d] = ns[d]
                fd = fd.reshape(shape)
                w = fd if w is None else w * fd
        acc = acc + (g * w if weights_on else g)

    # separable PE terms + LOD-folded bias
    pe_fn = triangular_pe if use_tri_pe else sinusoidal_pe
    for d in range(ndim):
        vec = pe_fn(t1s[d][None, :], pe_channels).T @ pe_blocks[d]  # [n, H]
        shape = [1] * (ndim + 1)
        shape[d] = ns[d]
        shape[-1] = vec.shape[-1]
        acc = acc + vec.reshape(shape)
    return acc + b1 + float(mip_level) * w_lod


def fast_decode(fp, mlp, mip_level: int, *, image_size: int,
                mip_to_level: dict, pe_channels: int,
                use_tri_pe: bool = True, ndim: int = 2,
                sparse_g0: bool = False, origin=None, n=None,
                g1_quirk: bool = True, planes=None) -> torch.Tensor:
    """Full (or tile) decode via the folded first layer → ``[n.., 3]`` on
    the grids' device; ``n`` (an int or per-axis tuple) defaults to
    ``image_size >> mip_level``, ``origin`` and ``planes`` as in
    :func:`first_layer_acc`."""
    acc = first_layer_acc(
        fp, mlp, mip_level, image_size=image_size, mip_to_level=mip_to_level,
        pe_channels=pe_channels, use_tri_pe=use_tri_pe, ndim=ndim,
        sparse_g0=sparse_g0, origin=origin, n=n, g1_quirk=g1_quirk,
        planes=planes,
    )
    h = F.gelu(acc)
    h = F.gelu(h @ mlp["w2"] + mlp["b2"])
    return torch.sigmoid(h @ mlp["w3"] + mlp["b3"])
