"""The feature-free fused train step in 3D, kernel3 for methods 3 and 4
(port of ``nic.kernels.train_fused_ff3``; the CUDA kernel is
``csrc/train_fused_ff3.cu``).

One step of the 3D objective without the [N, F] decoder-input matrix. The
MLP's first layer is folded into the grids (``P = Σ_k shift_k(G0)·W1_k``
over the 8 dense or method 4's 4 even-parity corners at cell resolution,
``C1 = G1·W1_g1`` at node resolution, :func:`fold_volumes`, torch ops),
the three PE axes become per-crop [n, H] tables of PE(t)·W1_pe computed
with the real encodings (so triangular and sinusoidal PE both work), and
for every voxel of a crop at absolute (S, A, B) the step rebuilds

    z1 = P[S//f, A//f, B//f] + trilinear(C1 at (S, A, B)/f1)
         + pe0[s] + pe1[a] + pe2[b] + (b1 + lod·w_lod)
         + ε·W1                                  (feature noise, if on)

then runs the MLP tail, the MSE over crops·n³·3 values and the full
backward. It emits the loss, ``out``, the W2/W3/bias grads, the slab, a1
and a2 sums of dz1 (contracted here with the PE tables into dW1's PE
rows, and summed to db1), εᵀ·dz1, and the node-resolution cotangents of
the P and C1 volumes (cell sums and trilinear-weighted sums of dz1),
accumulated into full-grid volumes. The backward of the autograd function
(:func:`_unfold_ff3`, torch ops) contracts them with W1 for dG0/dG1 and
with the grid values for dW1's grid rows.

Counterparts, as for the 2D kernel3: :func:`fused_train_ff3_plain` (torch
ops; autograd through the tail with the kernel's GELU derivative and bf16
rounding, its gradient with respect to the padded volumes being the
accumulated dP/dC1); :func:`fused_train_ff3_kernel` (the CUDA kernel on a
CUDA tensor, the plain version on a CPU tensor); and
:func:`fused_train_ff3`, the ``torch.autograd.Function`` the trainer calls.

The in-kernel feature noise is the JAX kernel's stream: counter (flat
voxel index + pixel base)·pad8(F) + j, the flat index in (crop, slab, a1,
a2) order, which is the JAX kernel's ((crop·nb + b)·R + irow).
"""

from __future__ import annotations

import torch

from nic_torch.core.encodings import sinusoidal_pe, triangular_pe
from nic_torch.kernels.train_fused import (_CORNERS_3D_DENSE,
                                           _CORNERS_3D_SPARSE, GELU_IDS,
                                           _accumulate_node_planes, _cd,
                                           _CdDot, _Gelu, _pad8,
                                           _unfold_node_grads,
                                           _window_extents_3d,
                                           pick_block_rows)
from nic_torch.kernels.train_fused_ff import _noise

__all__ = ["fused_train_ff3", "fused_train_ff3_kernel",
           "fused_train_ff3_plain", "ff3_geometry", "fold_volumes",
           "pe_tables"]

_KERNEL_HIDDEN = (64,)  # widths the .cu instantiates


def ff3_geometry(*, crops: int, n: int, rowsb: int, f: int, hidden: int,
                 pe_channels: int, oc: int = 3, nfeat: int = 0) -> bool:
    """The JAX kernel's eligibility gate, kept so the same geometries take
    kernel3 in both packages (the CUDA kernel has no block or lane limits
    of its own beyond its instantiated width and F ≤ 128)."""
    f1 = 2 * f
    rows = rowsb * n * n
    fslot = _pad8(nfeat) if nfeat else 8
    return (
        hidden <= 128
        and oc <= 8
        and pe_channels <= 8
        and f1 <= 8
        and 1 <= rowsb <= n
        and n % rowsb == 0
        and rows <= 2048
        and rows % 128 == 0
        and (n + 8) % f == 0
        and (n + 8) % f1 == 0
        and crops >= 1
        and crops * n**3 * fslot < 2**31
    )


def slab_rows(crops: int, n: int) -> int | None:
    """The JAX trainer's 3D slab block (rows per block of n² voxels), or
    None when the block-row picker refuses the voxel count."""
    cap = pick_block_rows(crops * n**3)
    return None if cap is None else min(max(cap // (n * n), 1), n)


def _corners(sparse_g0: bool):
    return _CORNERS_3D_SPARSE if sparse_g0 else _CORNERS_3D_DENSE


# ---- the fold and the PE tables (torch ops, as the JAX package leaves
# them to XLA) --------------------------------------------------------------

def fold_volumes(g0: torch.Tensor, g1: torch.Tensor, w1: torch.Tensor,
                 sparse_g0: bool = False, cd=None):
    """P [cells³, H] = Σ_k shift_k(G0)ᵀ·W1_k over the G0 corners and C1
    [g1n³, H] = G1ᵀ·W1_g1, with dot inputs rounded to ``cd`` and fp32
    sums."""
    corners = _corners(sparse_g0)
    ch = g0.shape[0]
    cells = [s - 1 for s in g0.shape[1:]]
    p_vol = None
    for k, off in enumerate(corners):
        sl = g0[:, off[0]:off[0] + cells[0], off[1]:off[1] + cells[1],
                off[2]:off[2] + cells[2]].permute(1, 2, 3, 0)
        term = _cd(sl, cd) @ _cd(w1[k * ch:(k + 1) * ch], cd)
        p_vol = term if p_vol is None else p_vol + term
    kg1 = len(corners)
    c1_vol = _cd(g1.permute(1, 2, 3, 0), cd) @ _cd(
        w1[kg1 * ch:(kg1 + 1) * ch], cd)
    return p_vol.contiguous(), c1_vol.contiguous()


def pe_tables(origins, n: int, f: int, npe: int,
              use_tri_pe: bool) -> torch.Tensor:
    """[3, crops, n, npe]: the PE of each crop's slab, a1 and a2
    coordinates t = (origin + arange(n)) / 2f (G1 units)."""
    org = torch.as_tensor(origins)
    crops = org.shape[0]
    t = (org.float()[:, :, None]
         + torch.arange(n, dtype=torch.float32, device=org.device)) * (
        1.0 / (2 * f))                                      # [crops, 3, n]
    pe_fn = triangular_pe if use_tri_pe else sinusoidal_pe
    table = pe_fn(t.permute(1, 0, 2).reshape(1, -1), npe)   # [npe, 3·crops·n]
    return table.T.reshape(3, crops, n, npe)


def _split_w1(w1, npe: int, sparse_g0: bool):
    """(channels, the three PE blocks [npe, H], the LOD row)."""
    ncor = len(_corners(sparse_g0))
    ch = (w1.shape[0] - 3 * npe - 1) // (ncor + 1)
    base = (ncor + 1) * ch
    return (ch, [w1[base + d * npe:base + (d + 1) * npe] for d in range(3)],
            w1[base + 3 * npe])


# ---- the plain version -------------------------------------------------

def fused_train_ff3_plain(p_vol, c1_vol, w1, b1, w2, b2, w3, b3, tgt,
                          origins, seed, *, n: int, f: int, npe: int,
                          lodf: float, sparse_g0: bool = False,
                          use_tri_pe: bool = True, cd=None,
                          gelu: str = "erf",
                          nbits: int | None = None) -> tuple:
    """The kernel's step in torch ops. ``p_vol`` [cells³, H] and ``c1_vol``
    [g1n³, H] from :func:`fold_volumes`; ``tgt`` [crops·n³, 3];
    ``origins`` [crops, 3] int; ``seed`` [≥3] int32 (s0, s1, pixel base),
    read only when ``nbits`` is set.

    Returns (loss, out [N, 3], dw2, db2, dw3, db3, dpe0, dpe1, dpe2, db1,
    P_acc [(g0n+1)³, H], C1_acc [(g1n+2)³, H], dw1e or None)."""
    device = p_vol.device
    hidden = w2.shape[0]
    crops = origins.shape[0]
    f1 = 2 * f
    g0n = p_vol.shape[0] + 1
    g1n = c1_vol.shape[0]
    _, pe_blocks, w_lod = _split_w1(w1, npe, sparse_g0)
    with torch.enable_grad():
        pacc = torch.zeros((g0n + 1,) * 3 + (hidden,), device=device)
        pacc[:g0n - 1, :g0n - 1, :g0n - 1] = p_vol.detach()
        c1acc = torch.zeros((g1n + 2,) * 3 + (hidden,), device=device)
        c1acc[:g1n, :g1n, :g1n] = c1_vol.detach()
        leaves = {"pacc": pacc, "c1acc": c1acc,
                  **{f"wpe{d}": pe_blocks[d].detach().float()
                     for d in range(3)},
                  "bvec": (b1.float() + lodf * w_lod.float()).detach(),
                  "w2": w2.detach().float(), "b2": b2.detach().float(),
                  "w3": w3.detach().float(), "b3": b3.detach().float()}
        if nbits is not None:
            leaves["w1n"] = w1.detach().float()
        for t in leaves.values():
            t.requires_grad_(True)

        org = torch.as_tensor(origins, device=device).long()
        ar = torch.arange(n, device=device)
        co = [org[:, d, None] + ar for d in range(3)]        # [crops, n]

        def axis(t, d):  # [crops, n] → broadcast along voxel axis d
            shape = [crops, 1, 1, 1]
            shape[1 + d] = n
            return t.reshape(shape)

        z1 = pacc[tuple(axis(c // f, d) for d, c in enumerate(co))]
        us = [axis((c % f1).float() * (1.0 / f1), d)[..., None]
              for d, c in enumerate(co)]
        nodes = [c // f1 for c in co]
        for k in range(8):
            offs = ((k >> 2) & 1, (k >> 1) & 1, k & 1)
            w = None
            for d, o in enumerate(offs):
                wd = us[d] if o else 1.0 - us[d]
                w = wd if w is None else w * wd
            z1 = z1 + w * c1acc[tuple(axis(nodes[d] + o, d)
                                      for d, o in enumerate(offs))]
        tables = pe_tables(org, n, f, npe, use_tri_pe)     # [3, crops, n, npe]
        for d in range(3):
            shape = [crops] + [n if e == d else 1 for e in range(3)]
            z1 = z1 + (tables[d] @ leaves[f"wpe{d}"]).reshape(shape
                                                               + [hidden])
        z1 = (z1 + leaves["bvec"]).reshape(-1, hidden)
        if nbits is not None:
            eps = _noise(crops * n**3, w1.shape[0], seed, nbits, device)
            z1 = z1 + _CdDot.apply(eps, leaves["w1n"], cd)
        h1 = _Gelu.apply(z1, gelu)
        h2 = _Gelu.apply(_CdDot.apply(h1, leaves["w2"], cd) + leaves["b2"],
                         gelu)
        out = torch.sigmoid(_CdDot.apply(h2, leaves["w3"], cd) + leaves["b3"])
        diff = out - tgt.float()
        loss = torch.sum(diff * diff) * (1.0 / diff.numel())
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
    return (loss.detach(), out.detach(), grads["w2"], grads["b2"],
            grads["w3"], grads["b3"], grads["wpe0"], grads["wpe1"],
            grads["wpe2"], grads["bvec"], grads["pacc"], grads["c1acc"],
            grads.get("w1n"))


# ---- the CUDA wrapper --------------------------------------------------

def _check(p_vol, c1_vol, w1, b1, w2, b2, w3, b3, tgt, origins, n, f, npe,
           sparse_g0, cd, gelu) -> None:
    tensors = (p_vol, c1_vol, w1, b1, w2, b2, w3, b3, tgt)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("fused_train_ff3: operands on different devices: "
                         f"{sorted(str(t.device) for t in tensors)}")
    if gelu not in GELU_IDS:
        raise ValueError(f"unknown train gelu {gelu!r}; one of "
                         f"{list(GELU_IDS)}")
    if cd not in (None, torch.bfloat16):
        raise ValueError(f"matmul dtype must be None or bfloat16, not {cd}")
    if f < 1 or f & (f - 1):
        raise ValueError(f"f={f} must be a power of two")
    hidden = w2.shape[0]
    crops = origins.shape[0]
    ps, cs = p_vol.shape[0], c1_vol.shape[0]
    want = {"p_vol": (ps, ps, ps, hidden), "c1_vol": (cs, cs, cs, hidden),
            "w1": (w1.shape[0], hidden), "b1": (hidden,),
            "w2": (hidden, hidden), "b2": (hidden,), "w3": (hidden, 3),
            "b3": (3,), "tgt": (crops * n**3, 3), "origins": (crops, 3)}
    got = dict(zip(want, (p_vol.shape, c1_vol.shape, w1.shape, b1.shape,
                          w2.shape, b2.shape, w3.shape, b3.shape, tgt.shape,
                          origins.shape)))
    for k, shape in want.items():
        if tuple(got[k]) != shape:
            raise ValueError(f"{k} has shape {tuple(got[k])}, expected "
                             f"{shape}")
    ncor = len(_corners(sparse_g0))
    if (w1.shape[0] - 3 * npe - 1) % (ncor + 1) or npe > 8:
        raise ValueError(f"W1 has {w1.shape[0]} rows: not {ncor + 1}·C + "
                         f"3·{npe} + 1 with pe ≤ 8")
    # every crop inside the volumes: the kernel indexes them unchecked
    org = origins.cpu()
    last = int(org.max()) + n - 1
    if int(org.min()) < 0 or last // f >= ps or last // (2 * f) >= cs:
        raise ValueError(f"crop origins {org.tolist()} with n={n}, f={f} "
                         f"reach outside the {ps}³ P volume")


def fused_train_ff3_kernel(p_vol, c1_vol, w1, b1, w2, b2, w3, b3, tgt,
                           origins, seed, *, n: int, f: int, npe: int,
                           lodf: float, sparse_g0: bool = False,
                           use_tri_pe: bool = True, cd=None,
                           gelu: str = "erf",
                           nbits: int | None = None) -> tuple:
    """The step on the volumes' device → the tuple of
    :func:`fused_train_ff3_plain`.

    A CUDA tensor launches ``nic_train_fused_ff3`` (and raises if it does
    not build or launch); a CPU tensor runs :func:`fused_train_ff3_plain`.
    ``fused_train_ff3_kernel.launches`` counts kernel launches."""
    origins = torch.as_tensor(origins)
    _check(p_vol, c1_vol, w1, b1, w2, b2, w3, b3, tgt, origins, n, f, npe,
           sparse_g0, cd, gelu)
    kw = dict(n=n, f=f, npe=npe, lodf=lodf, sparse_g0=sparse_g0,
              use_tri_pe=use_tri_pe, cd=cd, gelu=gelu, nbits=nbits)
    device = p_vol.device
    if device.type == "cpu":
        return fused_train_ff3_plain(p_vol, c1_vol, w1, b1, w2, b2, w3, b3,
                                     tgt, origins, seed, **kw)
    if device.type != "cuda":
        raise ValueError(f"fused_train_ff3 runs on cuda or cpu, not {device}")
    hidden = w2.shape[0]
    nfeat = w1.shape[0]
    if hidden not in _KERNEL_HIDDEN or nfeat > 128:
        raise ValueError(f"the CUDA kernel is built for hidden widths "
                         f"{_KERNEL_HIDDEN} and at most 128 features, not "
                         f"H={hidden}, F={nfeat}")
    from nic_torch.kernels import _build

    lib = _build.load()
    f32 = torch.float32
    crops = origins.shape[0]
    npix = crops * n**3
    _, pe_blocks, w_lod = _split_w1(w1, npe, sparse_g0)

    def prep(t):
        return t.detach().to(f32).contiguous()

    # the per-crop PE rows through W1, b1 + lod·w_lod folded into the a1
    # rows (as the JAX kernel folds them into its staged P planes)
    tables = pe_tables(origins.to(device), n, f, npe, use_tri_pe)
    pe = torch.stack([tables[d] @ pe_blocks[d].detach().float()
                      for d in range(3)])
    pe[1] += (b1.float() + lodf * w_lod.float()).detach()
    pe = pe.contiguous()
    w1f, w2f, b2f, w3f, b3f = (prep(t) for t in (w1, w2, b2, w3, b3))
    p_c, c1_c, tgt_c = prep(p_vol), prep(c1_vol), prep(tgt)
    org = origins.to(device=device, dtype=torch.int32).contiguous()
    s0, s1, pixel_base = (0, 0, 0) if nbits is None else (
        int(v) for v in torch.as_tensor(seed).tolist()[:3])

    ext0, ext1 = _window_extents_3d(n, f)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-npix // 128)
    nblk_mlp = min(tiles, sms)
    nblk_eps = min(tiles, 2 * sms) if nbits is not None else 0
    empty = lambda *s: torch.empty(s, dtype=f32, device=device)  # noqa: E731
    out = empty(npix, 3)
    dz1 = empty(npix, hidden)
    part_mlp = empty(nblk_mlp, 4 + 4 * hidden + hidden * hidden)
    win_p = empty(crops, *ext0, hidden)
    win_c1 = empty(crops, *ext1, hidden)
    sums = empty(3, crops, n, hidden)
    part_eps = empty(max(nblk_eps, 1), nfeat, hidden)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.nic_train_fused_ff3(
            p_c.data_ptr(), c1_c.data_ptr(), w1f.data_ptr(), pe.data_ptr(),
            w2f.data_ptr(), b2f.data_ptr(), w3f.data_ptr(), b3f.data_ptr(),
            tgt_c.data_ptr(), org.data_ptr(), out.data_ptr(), dz1.data_ptr(),
            part_mlp.data_ptr(), win_p.data_ptr(), win_c1.data_ptr(),
            sums.data_ptr(), part_eps.data_ptr(), crops, n, f,
            p_c.shape[0], c1_c.shape[0], hidden, nfeat, _pad8(nfeat),
            int(cd is not None), GELU_IDS[gelu],
            0 if nbits is None else int(nbits), s0, s1, pixel_base,
            nblk_mlp, nblk_eps, stream)
    if rc != 0:
        raise RuntimeError("train_fused_ff3 kernel launch failed: "
                           + lib.nic_cuda_error_string(rc).decode())
    fused_train_ff3_kernel.launches += 1

    # fixed-order sums of the per-block partials, the PE rows as table
    # contractions of the dz1 sums (as the JAX package does in XLA), then
    # the per-crop node volumes into full-grid volumes
    part = part_mlp.sum(dim=0)
    o = 4 + 3 * hidden
    loss, db3 = part[0], part[1:4]
    dw3 = part[4:o].reshape(hidden, 3)
    db2 = part[o:o + hidden]
    dw2 = part[o + hidden:].reshape(hidden, hidden)
    dpe = [torch.einsum("cnp,cnh->ph", tables[d], sums[d]) for d in range(3)]
    db1 = sums[0].sum(dim=(0, 1))
    dw1e = part_eps.sum(dim=0) if nbits is not None else None
    g0n, g1n = p_c.shape[0] + 1, c1_c.shape[0]
    pacc, c1acc = _accumulate_node_planes(win_p, win_c1, origins, f=f,
                                          g0_nodes=g0n, g1_nodes=g1n)
    return (loss, out, dw2, db2, dw3, db3, *dpe, db1, pacc, c1acc, dw1e)


fused_train_ff3_kernel.launches = 0


# ---- the backward tail and the autograd function -----------------------

def _unfold_ff3(pacc, c1acc, g0, g1, w1, db1, dpes, *, lodf: float,
                sparse_g0: bool, grids: bool = True):
    """Contract the accumulated node volumes with W1 for (dG0, dG1) and
    with the grid values for dW1's grid rows; the PE rows from the kernel,
    the LOD row lod·db1. ``grids=False`` skips dG0/dG1 (frozen grids)."""
    corners = _corners(sparse_g0)
    ch = g0.shape[0]
    hidden = w1.shape[1]
    g0n, g1n = g0.shape[1], g1.shape[1]
    dg0 = dg1 = None
    if grids:
        dg0, dg1 = _unfold_node_grads(pacc, c1acc, w1, g0_nodes=g0n,
                                      g1_nodes=g1n, channels=ch,
                                      corners=corners)
    pad = (0, 2, 0, 2, 0, 2)
    g0p = torch.nn.functional.pad(g0.detach().float(), pad)
    g1p = torch.nn.functional.pad(g1.detach().float(), pad)
    pflat = pacc.reshape(-1, hidden)
    rows = [g0p[:, a:a + g0n + 1, b:b + g0n + 1, c:c + g0n + 1].reshape(
        ch, -1) @ pflat for a, b, c in corners]
    rows.append(g1p.reshape(ch, -1) @ c1acc.reshape(-1, hidden))
    rows += [*dpes, lodf * db1[None, :]]
    return dg0, dg1, torch.cat(rows, dim=0)


class _FusedTrainFF3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g0, g1, w1, b1, w2, b2, w3, b3, tgt, origins, seed,
                n, f, npe, lodf, sparse_g0, use_tri_pe, cd, gelu, nbits):
        p_vol, c1_vol = fold_volumes(g0, g1, w1, sparse_g0, cd)
        (loss, out, dw2, db2, dw3, db3, dpe0, dpe1, dpe2, db1, pacc, c1acc,
         dw1e) = fused_train_ff3_kernel(
            p_vol, c1_vol, w1, b1, w2, b2, w3, b3, tgt, origins, seed, n=n,
            f=f, npe=npe, lodf=lodf, sparse_g0=sparse_g0,
            use_tri_pe=use_tri_pe, cd=cd, gelu=gelu, nbits=nbits)
        ctx.save_for_backward(g0, g1, w1, pacc, c1acc, dpe0, dpe1, dpe2, db1,
                              dw2, db2, dw3, db3,
                              *(() if dw1e is None else (dw1e,)))
        ctx.lodf, ctx.sparse_g0 = lodf, sparse_g0
        ctx.mark_non_differentiable(out)
        return loss, out

    @staticmethod
    def backward(ctx, g_loss, _g_out):
        (g0, g1, w1, pacc, c1acc, dpe0, dpe1, dpe2, db1, dw2, db2, dw3, db3,
         *dw1e) = ctx.saved_tensors
        grids = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        dg0, dg1, dw1 = _unfold_ff3(pacc, c1acc, g0, g1, w1, db1,
                                    (dpe0, dpe1, dpe2), lodf=ctx.lodf,
                                    sparse_g0=ctx.sparse_g0, grids=grids)
        if dw1e:
            dw1 = dw1 + dw1e[0]
        scale = lambda t: None if t is None else t * g_loss  # noqa: E731
        return (scale(dg0), scale(dg1), scale(dw1), scale(db1), scale(dw2),
                scale(db2), scale(dw3), scale(db3)) + (None,) * 12


def fused_train_ff3(g0, g1, mlp, tgt, origins, seed, n: int, f: int,
                    npe: int, lodf: float, sparse_g0: bool = False,
                    use_tri_pe: bool = True, matmul_dtype=None,
                    gelu: str = "erf", noise_bits: int | None = None):
    """(loss, out) of the 3D objective with the feature build fused into
    the kernel; gradients reach ``g0``/``g1`` (the active, possibly
    node-noised grids, [C, s+1, s+1, s+1]) and every MLP parameter through
    the hand-built backward. ``origins`` [crops, 3] int; ``seed`` [≥3]
    int32 (s0, s1, pixel base), read when ``noise_bits`` is set.
    Methods 3 (dense G0) and 4 (``sparse_g0``) and both PE families; the
    caller checks :func:`ff3_geometry`."""
    return _FusedTrainFF3.apply(
        g0, g1, mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], mlp["w3"],
        mlp["b3"], tgt, origins, seed, n, f, npe, lodf, sparse_g0,
        use_tri_pe, matmul_dtype, gelu, noise_bits)
