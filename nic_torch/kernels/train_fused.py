"""The fused MLP train kernels on gather-built features (port of
``nic.kernels.train_fused``, 2D and 3D), and the helpers kernel3 shares
with them. The CUDA kernels are ``csrc/train_fused.cu``.

For decoder-input rows x [N, F] (the gather's features, QAT noise already
added) and targets [N, 3], both kernels compute in one pass

    loss = mean((sigmoid(W3·gelu(W2·gelu(W1·x + b1) + b2) + b3) − tgt)²)

``out`` and every MLP gradient, in the JAX package's surgical-bf16
semantics: with ``cd`` = bfloat16 the dot inputs (x, h1, h2, the weights,
and the cotangents dz3, dz2, dz1 on their way into a dot) are rounded to
bf16, and every sum and elementwise op stays fp32. They differ in what
leaves the kernel beside the MLP gradients:

- K6 (``_kernel``, TRAIN_FORWARD=kernel) writes dx = dz1·W1ᵀ [N, F], which
  :func:`fused_mlp_loss` hands to autograd, so it flows back into the
  gather's scatter-add;
- K7 (``_kernel_ng``, kernel2; K8, ``_kernel_ng2``, is the same math
  lane-packed for the TPU and is not carried over) reduces dz1, in fp32,
  to node resolution instead: dP[cell] = Σ dz1 over the pixels of each G0
  cell at period f, dC1[node] = Σ (1−u)·dz1 to the floor node and u·dz1
  to the next one per axis at period 2f. :func:`fused_mlp_loss_ng` unfolds
  them (:func:`_unfold_node_grads`) into dG0/dG1;
- K9 (``_kernel_ng3``, kernel2 in 3D; K10, ``_kernel_ng3_2``, is its
  lane-packed twin and the same kernel here) does the same over crop
  volumes: P cell sums and trilinear C1 sums per crop, unfolded over the
  8 dense or 4 even-parity (method 4) G0 corners
  (:func:`fused_mlp_loss_ng3`).

Counterparts of each kernel, as for kernel3: ``*_plain`` (torch ops; the
node sums as the formula above), ``*_kernel`` (launches the CUDA kernel on
a CUDA tensor, runs the plain version on a CPU tensor; ``.launches``
counts launches) and the ``torch.autograd.Function`` the trainer calls.

Shared helpers: :func:`pick_block_rows` and :func:`_pad8` of the JAX gates;
the GELU pair (``"erf"``: the Abramowitz & Stegun erf of the decode
kernel, |Δerf| ≤ 1.5e-7; ``"poly"``: the 8-FMA even polynomial, exact
saturation outside ±4) with its hand-written derivative; the bf16 dot of
the plain versions; :func:`_accumulate_node_planes`, which places per-crop
node windows into full-grid planes per crop in a fixed order (no atomics);
and the unfold. The node helpers take 2D or 3D by the width of the crop
origins (or the rank of the windows).
"""

from __future__ import annotations

import itertools

import torch

from nic_torch.grids.sample import EVEN_PARITY_CORNERS_3D
from nic_torch.kernels._widths import (body_blocks, kernel_body,
                                       kernel_width, pad_mlp, unpad_all)
from nic_torch.kernels.decode_fused_v2 import _GELU_POLY_C, _erf

__all__ = ["pick_block_rows", "fused_mlp_loss", "fused_mlp_loss_kernel",
           "fused_mlp_loss_plain", "fused_mlp_loss_ng",
           "fused_mlp_loss_ng_kernel", "fused_mlp_loss_ng_plain",
           "fused_mlp_loss_ng3", "fused_mlp_loss_ng3_kernel",
           "fused_mlp_loss_padded", "node_windows", "node_windows_plain",
           "node_volumes", "node_volumes_plain"]

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT2PI = 0.3989422804014327
GELU_IDS = {"erf": 0, "poly": 1}
# the per-pixel bodies by their id in csrc/train_fused.cu (enum Body)
BODY_IDS = {"mlp_pixel": 0, "mlp_pixel_mma": 1, "mlp_pixel_wide": 2,
            "mlp_pixel_mma_wide": 3}
_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))
# the 3D G0 corners: dense (method 3) and the sparse even-parity four
# (method 4), in the gather's order
_CORNERS_3D_DENSE = tuple(itertools.product((0, 1), repeat=3))
_CORNERS_3D_SPARSE = EVEN_PARITY_CORNERS_3D


def _gelu_fwd(z: torch.Tensor, kind: str):
    """(gelu(z), aux for the backward); for "erf" aux is Φ(z)."""
    if kind == "erf":
        cdf = 0.5 * (1.0 + _erf(z * _INV_SQRT2))
        return z * cdf, cdf
    u = z * z
    acc = torch.full_like(z, _GELU_POLY_C[-1])
    for c in _GELU_POLY_C[-2::-1]:
        acc = acc * u + c
    h = 0.5 * z + acc
    return torch.where(z > 4.0, z, torch.where(z < -4.0, 0.0, h)), None


def _gelu_bwd(z: torch.Tensor, aux, kind: str) -> torch.Tensor:
    """gelu'(z): Φ(z) + z·φ(z) for "erf"; ½ + 2z·q'(z²) for "poly"."""
    if kind == "erf":
        return aux + z * (_INV_SQRT2PI * torch.exp(-0.5 * z * z))
    u = z * z
    acc = torch.full_like(z, 8.0 * _GELU_POLY_C[8])
    for k in range(7, 0, -1):
        acc = acc * u + k * _GELU_POLY_C[k]
    g = 0.5 + 2.0 * z * acc
    return torch.where(z > 4.0, 1.0, torch.where(z < -4.0, 0.0, g))


def pick_block_rows(n_rows: int, max_r: int = 2048) -> int | None:
    """Largest power-of-two row block (≤ ``max_r``, ≥ 8) dividing
    ``n_rows``, or None."""
    r = max_r
    while r >= 8:
        if n_rows % r == 0:
            return r
        r //= 2
    return None


def _pad8(v: int) -> int:
    return -(-v // 8) * 8


def _node_counts(nodes, nd: int = 2) -> tuple:
    return (nodes,) * nd if isinstance(nodes, int) else tuple(nodes)


def _window_extents(n: int, f: int) -> tuple[int, int, int, int]:
    """Per-crop node-window extents (rows0, cols0, rows1, cols1): a crop's
    dz1 reaches at most these many P cells and C1 nodes per axis."""
    f1 = 2 * f
    return ((n + f - 2) // f + 1, (n + f - 2) // f + 1,
            (n + f1 - 2) // f1 + 2, n // f1 + 2)


def _window_extents_3d(n: int, f: int) -> tuple[tuple, tuple]:
    """Per-crop node-volume extents in 3D: ((r0, r0, r0) P cells, (r1, c1,
    c1) C1 nodes), the JAX package's na0 and rows1/na1."""
    r0, _, r1, c1 = _window_extents(n, f)
    return (r0,) * 3, (r1, c1, c1)


def _window_extents_nd(n: int, f: int, nd: int) -> tuple[tuple, tuple]:
    """(P extents, C1 extents) per axis of a crop's node windows in 2D
    (``nd`` = 2) or node volumes in 3D."""
    if nd == 3:
        return _window_extents_3d(n, f)
    rows0, cols0, rows1, cols1 = _window_extents(n, f)
    return (rows0, cols0), (rows1, cols1)


def _accumulate_node_planes(win_p, win_c1, origins, *, f: int, g0_nodes,
                            g1_nodes):
    """Per-crop node windows → full-grid planes (2D) or volumes (3D): P
    [g0+1 per axis, H] of cell sums of dz1, C1 [g1+2 per axis, H] of
    interp-weighted sums.

    ``win_p`` [crops, *P extents, H] and ``win_c1`` [crops, *C1 extents,
    H] (:func:`_window_extents`, :func:`_window_extents_3d`) are each
    crop's windows, whose corners sit at origin // f and origin // 2f;
    ``origins`` [crops, d]. The windows are added one crop after the
    other."""
    nd = win_p.dim() - 2
    g0 = _node_counts(g0_nodes, nd)
    g1 = _node_counts(g1_nodes, nd)
    orgs = torch.as_tensor(origins).cpu().tolist()
    planes = []
    for win, shape, step in ((win_p, tuple(g + 1 for g in g0), f),
                             (win_c1, tuple(g + 2 for g in g1), 2 * f)):
        plane = win.new_zeros(shape + win.shape[nd + 1:])
        ext = win.shape[1:nd + 1]
        for i, org in enumerate(orgs):
            plane[tuple(slice(o // step, o // step + e)
                        for o, e in zip(org, ext))] += win[i]
        planes.append(plane)
    return tuple(planes)


def _unfold_node_grads(pacc, c1acc, w1, *, g0_nodes, g1_nodes,
                       channels: int, corners=_CORNERS):
    """(dG0 [C, g0..], dG1 [C, g1..]) from the accumulated node planes or
    volumes (the JAX package's ``_unfold_node_grads``/``_3d`` after its
    accumulation): dG0 is the shifted adds of P·W1_kᵀ over the G0
    ``corners``, with W1_k the rows k·C:(k+1)·C; dG1 is C1·W1_g1ᵀ with the
    rows after the corners'; both cropped to the grids."""
    nd = pacc.dim() - 1
    g0 = _node_counts(g0_nodes, nd)
    g1 = _node_counts(g1_nodes, nd)
    ch = channels
    w1 = w1.detach().to(torch.float32)
    dg0 = pacc.new_zeros(tuple(g + 2 for g in g0) + (ch,))
    for k, off in enumerate(corners):
        dg0[tuple(slice(o, o + g + 1) for o, g in zip(off, g0))] += (
            pacc @ w1[k * ch:(k + 1) * ch].T)
    kg1 = len(corners)
    dg1 = (c1acc @ w1[kg1 * ch:(kg1 + 1) * ch].T)[
        tuple(slice(0, g) for g in g1)]
    dg0 = dg0[tuple(slice(0, g) for g in g0)]
    return dg0.movedim(-1, 0), dg1.movedim(-1, 0)


# ---- the plain versions ------------------------------------------------

def _cd(x: torch.Tensor, cd) -> torch.Tensor:
    """Round to the dot-input type (bf16) and back to fp32; identity for
    fp32."""
    return x if cd is None else x.to(cd).float()


class _CdDot(torch.autograd.Function):
    """a·w with dot inputs rounded to ``cd`` and fp32 sums; the backward
    rounds the cotangent to ``cd`` before both products, as the kernels
    do (dh = gb·wbᵀ, dw = abᵀ·gb)."""

    @staticmethod
    def forward(ctx, a, w, cd):
        ab, wb = _cd(a, cd), _cd(w, cd)
        ctx.save_for_backward(ab, wb)
        ctx.cd = cd
        return ab @ wb

    @staticmethod
    def backward(ctx, g):
        ab, wb = ctx.saved_tensors
        gb = _cd(g, ctx.cd)
        return gb @ wb.T, ab.T @ gb, None


class _Gelu(torch.autograd.Function):
    """The train kernels' GELU with its hand-written derivative."""

    @staticmethod
    def forward(ctx, z, kind):
        h, aux = _gelu_fwd(z, kind)
        ctx.save_for_backward(z, *(() if aux is None else (aux,)))
        ctx.kind = kind
        return h

    @staticmethod
    def backward(ctx, g):
        z, *aux = ctx.saved_tensors
        return g * _gelu_bwd(z, aux[0] if aux else None, ctx.kind), None


def _plain_step(x, tgt, weights, cd, gelu, with_dx: bool):
    """The fused step in torch ops → (loss, out, dz1, [dx,] dw1, db1, dw2,
    db2, dw3, db3); autograd runs through the kernels' GELU derivative and
    bf16 rounding, so dz1 is the fp32 cotangent the kernels reduce."""
    with torch.enable_grad():
        ws = [w.detach().float().requires_grad_(True) for w in weights]
        w1, b1, w2, b2, w3, b3 = ws
        xl = x.detach().float().requires_grad_(with_dx)
        z1 = _CdDot.apply(xl, w1, cd) + b1
        h1 = _Gelu.apply(z1, gelu)
        h2 = _Gelu.apply(_CdDot.apply(h1, w2, cd) + b2, gelu)
        out = torch.sigmoid(_CdDot.apply(h2, w3, cd) + b3)
        diff = out - tgt.float()
        loss = torch.sum(diff * diff) * (1.0 / diff.numel())
        grads = torch.autograd.grad(loss, [z1] + ([xl] if with_dx else [])
                                    + ws)
    return (loss.detach(), out.detach()) + tuple(grads)


def fused_mlp_loss_plain(x, tgt, w1, b1, w2, b2, w3, b3, *, cd=None,
                         gelu: str = "erf") -> tuple:
    """K6's step in torch ops → (loss, out [N, 3], dx [N, F], dw1, db1,
    dw2, db2, dw3, db3)."""
    loss, out, _dz1, *grads = _plain_step(
        x, tgt, (w1, b1, w2, b2, w3, b3), cd, gelu, with_dx=True)
    return (loss, out, *grads)


def _node_sums(dz1, origins, *, n: int, f: int, g0_nodes, g1_nodes):
    """The node-resolution cotangents of dz1 [crops·n^d, H] (crops of n^d
    pixels at ``origins`` [crops, d], row-major per crop), as the formula:
    P [g0+1 per axis, H] with P[cell] = Σ dz1 over the pixels of each G0
    cell at period f, and C1 [g1+2 per axis, H], where each pixel adds its
    dz1 to its 2^d G1 nodes at period 2f with the multilinear weights
    Π_k (u_k or 1 − u_k) (u_k the phases of the absolute coordinate)."""
    org = origins.to(dz1.device).long()
    crops, nd = org.shape
    g0 = _node_counts(g0_nodes, nd)
    g1 = _node_counts(g1_nodes, nd)
    hidden = dz1.shape[1]
    f1 = 2 * f
    ar = torch.arange(n, device=dz1.device)
    cs = [org[:, d, None] + ar for d in range(nd)]          # [crops, n]

    def axis(t, d):  # [crops, n] → broadcast along pixel axis d
        shape = [crops] + [1] * nd
        shape[1 + d] = n
        return t.reshape(shape)

    dv = dz1.reshape((crops,) + (n,) * nd + (hidden,))
    pacc = dz1.new_zeros(tuple(g + 1 for g in g0) + (hidden,))
    pacc.index_put_(tuple(axis(c // f, d) for d, c in enumerate(cs)), dv,
                    accumulate=True)
    us = [(c % f1).float() * (1.0 / f1) for c in cs]
    c1acc = dz1.new_zeros(tuple(g + 2 for g in g1) + (hidden,))
    for off in itertools.product((0, 1), repeat=nd):
        w = None
        for d, o in enumerate(off):
            wd = axis(us[d] if o else 1.0 - us[d], d)
            w = wd if w is None else w * wd
        c1acc.index_put_(tuple(axis(c // f1 + o, d)
                               for d, (c, o) in enumerate(zip(cs, off))),
                         w[..., None] * dv, accumulate=True)
    return pacc, c1acc


def _windows_plain(dz1, origins, n: int, f: int) -> tuple:
    """Each crop's node windows (2D) or volumes (3D, by the origins'
    width) of dz1 [crops·n^d, H] in torch ops, with the kernels' extents
    (:func:`_window_extents_nd`); a contribution past an extent is
    dropped, as the kernels drop it."""
    org = torch.as_tensor(origins).to(dz1.device).long()
    crops, nd = org.shape
    ext0, ext1 = _window_extents_nd(n, f, nd)
    hidden = dz1.shape[1]
    f1 = 2 * f
    ar = torch.arange(n, device=dz1.device)
    cs = [org[:, d, None] + ar for d in range(nd)]          # [crops, n]

    def axis(t, d):  # [crops, n] → broadcast along pixel axis d
        shape = [crops] + [1] * nd
        shape[1 + d] = n
        return t.reshape(shape)

    dv = dz1.float().reshape((crops,) + (n,) * nd + (hidden,))
    ci = torch.arange(crops, device=dz1.device).reshape([crops] + [1] * nd)
    win_p = dv.new_zeros((crops, *ext0, hidden))
    win_p.index_put_((ci, *(axis(c // f - org[:, d:d + 1] // f, d)
                            for d, c in enumerate(cs))), dv,
                     accumulate=True)
    win_c1 = dv.new_zeros((crops, *ext1, hidden))
    us = [(c % f1).float() * (1.0 / f1) for c in cs]
    for off in itertools.product((0, 1), repeat=nd):
        w, idx = None, []
        for d, o in enumerate(off):
            q = cs[d] // f1 - org[:, d:d + 1] // f1 + o
            wd = axis((us[d] if o else 1.0 - us[d]) * (q < ext1[d]), d)
            w = wd if w is None else w * wd
            idx.append(axis(q.clamp(max=ext1[d] - 1), d))
        win_c1.index_put_((ci, *idx), w[..., None] * dv, accumulate=True)
    return win_p, win_c1


def node_windows_plain(dz1, origins, n: int, f: int) -> tuple:
    """Each crop's node windows of dz1 [crops·n², H] (row-major per crop,
    ``origins`` [crops, 2]) in torch ops → (win_p [crops, rows0, cols0, H]
    of the P cell sums at period f, win_c1 [crops, rows1, cols1, H] where
    each pixel adds its dz1 to its four C1 nodes at period 2f with the
    bilinear weights of its phase), extents :func:`_window_extents`. Window
    node q of a crop at origin o is the absolute cell o//f + q (o//2f + q
    for C1); a contribution past a window's extent is dropped, as the
    kernel drops it. :func:`_accumulate_node_planes` of the windows is
    :func:`_node_sums` of dz1."""
    return _windows_plain(dz1, origins, n, f)


def node_volumes_plain(dz1, origins, n: int, f: int) -> tuple:
    """:func:`node_windows_plain` in 3D: each crop's node volumes of dz1
    [crops·n³, H] (row-major per crop, ``origins`` [crops, 3]) → (win_p
    [crops, r0, r0, r0, H] of the P cell sums at period f, win_c1 [crops,
    r1, c1, c1, H] where each voxel adds its dz1 to its eight C1 nodes at
    period 2f with the trilinear weights of its phase), extents
    :func:`_window_extents_3d`, what lies past them dropped.
    :func:`_accumulate_node_planes` of the volumes is :func:`_node_sums`
    of dz1."""
    return _windows_plain(dz1, origins, n, f)


def fused_mlp_loss_ng_plain(x, tgt, origins, w1, b1, w2, b2, w3, b3, *,
                            n: int, f: int, g0_nodes, g1_nodes, cd=None,
                            gelu: str = "erf") -> tuple:
    """K7's step (2D origins [crops, 2]) or K9's (3D origins [crops, 3]) in
    torch ops → (loss, out [N, 3], dw1, db1, dw2, db2, dw3, db3, P_acc
    [g0+1 per axis, H], C1_acc [g1+2 per axis, H]); the node planes or
    volumes are :func:`_node_sums` of the fp32 dz1."""
    loss, out, dz1, *grads = _plain_step(x, tgt, (w1, b1, w2, b2, w3, b3),
                                         cd, gelu, with_dx=False)
    planes = _node_sums(dz1, torch.as_tensor(origins), n=n, f=f,
                        g0_nodes=g0_nodes, g1_nodes=g1_nodes)
    return (loss, out, *grads, *planes)


# ---- the CUDA wrappers -------------------------------------------------

def _check(name, x, tgt, w1, b1, w2, b2, w3, b3, cd, gelu) -> None:
    tensors = (x, tgt, w1, b1, w2, b2, w3, b3)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: operands on different devices: "
                         f"{sorted(str(t.device) for t in tensors)}")
    if gelu not in GELU_IDS:
        raise ValueError(f"unknown train gelu {gelu!r}; one of "
                         f"{list(GELU_IDS)}")
    if cd not in (None, torch.bfloat16):
        raise ValueError(f"matmul dtype must be None or bfloat16, not {cd}")
    npix, feat = x.shape
    hidden = w2.shape[0]
    want = {"x": (npix, feat), "tgt": (npix, 3), "w1": (feat, hidden),
            "b1": (hidden,), "w2": (hidden, hidden), "b2": (hidden,),
            "w3": (hidden, 3), "b3": (3,)}
    for k, t in zip(want, tensors):
        if tuple(t.shape) != want[k]:
            raise ValueError(f"{name}: {k} has shape {tuple(t.shape)}, "
                             f"expected {want[k]}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


# the hidden axes of the K6 (dx) and K7/K9 (node) tuples (None: none)
_DX_OUT_DIMS = (None, None, None, (-1,), (-1,), (0, 1), (-1,), (0,), None)
_NG_OUT_DIMS = (None, None, (-1,), (-1,), (0, 1), (-1,), (0,), None, (-1,),
                (-1,))


def fused_mlp_loss_padded(fn, width: int, *args, **kw) -> tuple:
    """``fn`` (any kernel or plain step of this module, called as
    ``fn(x, tgt[, origins], w1, b1, w2, b2, w3, b3, **kw)``) at hidden
    width ``width`` ≥ H on weights zero-padded along the hidden axis,
    with every result sliced back to H: the same step (``_widths``)."""
    *lead, w1, b1, w2, b2, w3, b3 = args
    hidden = w2.shape[0]
    outs = fn(*lead, *pad_mlp(w1, b1, w2, b2, w3, b3, width), **kw)
    dims = _DX_OUT_DIMS if len(outs) == len(_DX_OUT_DIMS) else _NG_OUT_DIMS
    return unpad_all(outs, hidden, dims)


def _call(entry: str, tensors, ints, device) -> None:
    """One call of a ``csrc/train_fused.cu`` entry point on the device's
    current stream: the tensors' pointers, then the int arguments."""
    from nic_torch.kernels import _build

    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*(t.data_ptr() for t in tensors), *ints,
                                 stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: "
                           + lib.nic_cuda_error_string(rc).decode())


def _prep(*tensors):
    """fp32, contiguous and 16-byte aligned (the kernels read weight rows
    as float4)."""
    out = [t.detach().to(torch.float32).contiguous() for t in tensors]
    return [t.clone() if t.data_ptr() % 16 else t for t in out]


def _body_weights(body: str, w1, b1, w2, b2, w3, b3) -> tuple:
    """The prepared weights as ``body`` reads them: fp32, but W1 and W2 as
    bf16 for ``mlp_pixel_mma_wide``, whose 64 x 64 tiles of them stream
    into shared memory by 16-byte copies (rounded here to nearest even, as
    the plain version and the other bodies round them)."""
    if body == "mlp_pixel_mma_wide":
        w1, w2 = (w.to(torch.bfloat16).contiguous() for w in (w1, w2))
    return w1, b1, w2, b2, w3, b3


def _partials(npix: int, feat: int, hidden: int, body: str, device):
    """(per-block partial rows [nblk, 4 + 5H + H² + F·H], nblk): as many
    blocks of 128-pixel tiles per SM as ``body`` is built for."""
    nblk = body_blocks(body, -(-npix // 128), device)
    part = torch.empty((nblk, 4 + 5 * hidden + hidden * hidden
                        + feat * hidden), dtype=torch.float32, device=device)
    return part, nblk


def _sum_partials(part, hidden: int, feat: int):
    """Fixed-order sum of the per-block partial rows → (loss, dw1, db1,
    dw2, db2, dw3, db3)."""
    p = part.sum(dim=0)
    o_w2 = 4 + 4 * hidden
    o_b1 = o_w2 + hidden * hidden
    return (p[0], p[o_b1 + hidden:].reshape(feat, hidden),
            p[o_b1:o_b1 + hidden], p[o_w2:o_b1].reshape(hidden, hidden),
            p[4 + 3 * hidden:o_w2], p[4:4 + 3 * hidden].reshape(hidden, 3),
            p[1:4])


def fused_mlp_loss_kernel(x, tgt, w1, b1, w2, b2, w3, b3, *, cd=None,
                          gelu: str = "erf") -> tuple:
    """K6 on the operands' device → the tuple of
    :func:`fused_mlp_loss_plain`.

    A CUDA tensor launches ``nic_train_fused_dx`` of ``csrc/
    train_fused.cu`` (and raises if it does not build or launch) with the
    per-pixel body :func:`~nic_torch.kernels._widths.kernel_body` names
    (for bf16 dots ``mlp_pixel_mma`` at H = 64 and ``mlp_pixel_mma_wide``
    from 128 to 256; ``mlp_pixel`` for fp32 dots at 64 and 128;
    ``mlp_pixel_wide`` past those), a hidden width below an instantiated one
    (64, 128) or, past them, below a multiple of 64 zero-padded to it
    (:func:`fused_mlp_loss_padded`); a CPU tensor runs
    :func:`fused_mlp_loss_plain`.
    ``fused_mlp_loss_kernel.launches`` counts kernel launches."""
    _check("fused_mlp_loss", x, tgt, w1, b1, w2, b2, w3, b3, cd, gelu)
    weights = (w1, b1, w2, b2, w3, b3)
    if x.device.type == "cpu":
        return fused_mlp_loss_plain(x, tgt, *weights, cd=cd, gelu=gelu)
    device = x.device
    npix, feat = x.shape
    hidden = w2.shape[0]
    width = kernel_width("train_mlp", hidden)
    if width != hidden:
        return fused_mlp_loss_padded(fused_mlp_loss_kernel, width, x, tgt,
                                     *weights, cd=cd, gelu=gelu)
    out = torch.empty((npix, 3), dtype=torch.float32, device=device)
    dx = torch.empty((npix, feat), dtype=torch.float32, device=device)
    body = kernel_body("train_mlp", hidden, cd is not None)
    part, nblk = _partials(npix, feat, hidden, body, device)
    xs, tg, *ws = _prep(x, tgt, *weights)
    _call("nic_train_fused_dx", (xs, tg, *_body_weights(body, *ws), out, dx,
                                 part),
          (npix, feat, hidden, int(cd is not None), GELU_IDS[gelu],
           BODY_IDS[body], nblk), device)
    fused_mlp_loss_kernel.launches += 1
    loss, *grads = _sum_partials(part, hidden, feat)
    return (loss, out, dx, *grads)


fused_mlp_loss_kernel.launches = 0


def _check_origins(origins, n: int, f: int, g0_nodes, g1_nodes) -> None:
    """Every crop's node windows inside the full-grid planes or volumes
    (the wrapper places them by slicing, which would clip silently)."""
    org = origins.cpu()
    nd = org.shape[1] if org.dim() == 2 else 0
    ok = nd in (2, 3) and int(org.min()) >= 0
    if ok:
        ext0, ext1 = _window_extents_nd(n, f, nd)
        last = org.max(dim=0).values.tolist()
        ok = all(o // f + e <= g + 1 for o, e, g in
                 zip(last, ext0, _node_counts(g0_nodes, nd))) and all(
            o // (2 * f) + e <= g + 2 for o, e, g in
            zip(last, ext1, _node_counts(g1_nodes, nd)))
    if not ok:
        raise ValueError(f"crop origins {org.tolist()} with n={n}, f={f} "
                         f"reach outside grids of {g0_nodes} and "
                         f"{g1_nodes} nodes")


def _ng_kernel(wrapper, entry: str, x, tgt, origins, weights, *, n: int,
               f: int, g0_nodes, g1_nodes, cd, gelu) -> tuple:
    """The node-gradient step on the operands' device, 2D or 3D by the
    origins' width: the plain version for a CPU tensor, else one launch of
    ``entry``, counted on ``wrapper.launches``, and the placement of its
    per-crop windows."""
    _check(entry, x, tgt, *weights, cd, gelu)
    origins = torch.as_tensor(origins)
    if f < 1 or f & (f - 1):
        raise ValueError(f"f={f} must be a power of two")
    crops, nd = origins.shape
    if x.shape[0] != crops * n**nd:
        raise ValueError(f"x has {x.shape[0]} rows, not crops·n^{nd} = "
                         f"{crops}·{n}^{nd}")
    _check_origins(origins, n, f, g0_nodes, g1_nodes)
    kw = dict(n=n, f=f, g0_nodes=g0_nodes, g1_nodes=g1_nodes, cd=cd,
              gelu=gelu)
    if x.device.type == "cpu":
        return fused_mlp_loss_ng_plain(x, tgt, origins, *weights, **kw)
    device = x.device
    npix, feat = x.shape
    hidden = weights[2].shape[0]
    width = kernel_width("train_mlp", hidden)
    if width != hidden:
        return fused_mlp_loss_padded(wrapper, width, x, tgt, origins,
                                     *weights, **kw)
    empty = lambda *s: torch.empty(s, dtype=torch.float32,  # noqa: E731
                                   device=device)
    ext0, ext1 = _window_extents_nd(n, f, nd)
    corners = empty(crops, *ext1, 2**nd, hidden)  # C1 cell corners
    out, dz1 = empty(npix, 3), empty(npix, hidden)
    win_p = empty(crops, *ext0, hidden)
    win_c1 = empty(crops, *ext1, hidden)
    org = origins.to(device=device, dtype=torch.int32).contiguous()
    body = kernel_body("train_mlp", hidden, cd is not None)
    part, nblk = _partials(npix, feat, hidden, body, device)
    xs, tg, *ws = _prep(x, tgt, *weights)
    _call(entry, (xs, tg, org, *_body_weights(body, *ws), out, dz1, part,
                  win_p, win_c1, corners),
          (crops, n, f, feat, hidden, int(cd is not None), GELU_IDS[gelu],
           BODY_IDS[body], nblk), device)
    wrapper.launches += 1
    loss, *grads = _sum_partials(part, hidden, feat)
    planes = _accumulate_node_planes(win_p, win_c1, origins, f=f,
                                     g0_nodes=g0_nodes, g1_nodes=g1_nodes)
    return (loss, out, *grads, *planes)


def fused_mlp_loss_ng_kernel(x, tgt, origins, w1, b1, w2, b2, w3, b3, *,
                             n: int, f: int, g0_nodes, g1_nodes, cd=None,
                             gelu: str = "erf") -> tuple:
    """K7 on the operands' device → the tuple of
    :func:`fused_mlp_loss_ng_plain`. ``x`` [crops·n², F] row-major per
    crop, ``origins`` [crops, 2] (host or device), f the G0 cell period
    in pixels.

    A CUDA tensor launches ``nic_train_fused_ng`` of ``csrc/
    train_fused.cu`` (and raises if it does not build or launch), whose
    per-crop node windows are placed into the planes by
    :func:`_accumulate_node_planes`; a CPU tensor runs
    :func:`fused_mlp_loss_ng_plain`. ``fused_mlp_loss_ng_kernel.launches``
    counts kernel launches."""
    if torch.as_tensor(origins).shape[-1] != 2:
        raise ValueError("fused_mlp_loss_ng_kernel takes 2D origins; 3D "
                         "crops go to fused_mlp_loss_ng3_kernel")
    return _ng_kernel(fused_mlp_loss_ng_kernel, "nic_train_fused_ng", x,
                      tgt, origins, (w1, b1, w2, b2, w3, b3), n=n, f=f,
                      g0_nodes=g0_nodes, g1_nodes=g1_nodes, cd=cd, gelu=gelu)


fused_mlp_loss_ng_kernel.launches = 0


def _windows_kernel(wrapper, entry: str, nd: int, dz1, origins, n: int,
                    f: int) -> tuple:
    """The node windows (``nd`` = 2) or volumes (3) of dz1 on its device:
    :func:`_windows_plain` for a CPU tensor, else one launch of ``entry``,
    counted on ``wrapper.launches``."""
    origins = torch.as_tensor(origins)
    crops = origins.shape[0]
    hidden = dz1.shape[1]
    name = wrapper.__name__
    if tuple(origins.shape) != (crops, nd) or dz1.shape[0] != crops * n**nd:
        raise ValueError(f"{name}: dz1 {tuple(dz1.shape)} is not "
                         f"[crops·n{'²' if nd == 2 else '³'}, H] for "
                         f"origins {tuple(origins.shape)} and n={n}")
    if f < 1 or f & (f - 1):
        raise ValueError(f"{name}: f={f} must be a power of two")
    if dz1.device.type == "cpu":
        return _windows_plain(dz1, origins, n, f)
    if dz1.device.type != "cuda" or hidden % 64:
        raise ValueError(f"{name} runs H a multiple of 64 on cuda or any H "
                         f"on cpu, not H={hidden} on {dz1.device}")
    device = dz1.device
    ext0, ext1 = _window_extents_nd(n, f, nd)
    empty = lambda *s: torch.empty(s, dtype=torch.float32,  # noqa: E731
                                   device=device)
    win_p = empty(crops, *ext0, hidden)
    win_c1 = empty(crops, *ext1, hidden)
    corners = empty(crops, *ext1, 2**nd, hidden)
    org = origins.to(device=device, dtype=torch.int32).contiguous()
    _call(entry, (*_prep(dz1), org, win_p, win_c1, corners),
          (crops, n, f, hidden), device)
    wrapper.launches += 1
    return win_p, win_c1


def node_windows(dz1, origins, n: int, f: int) -> tuple:
    """The node windows on dz1's device → the pair of
    :func:`node_windows_plain`. A CUDA tensor launches ``nic_node_windows``
    of ``csrc/train_fused.cu`` (``node_windows`` and ``node_corners`` of
    ``csrc/train_common.cuh``, the pass that K11 and K7 run on their dz1;
    H a multiple of 64) and raises if it does not launch; a CPU tensor
    runs :func:`node_windows_plain`. ``node_windows.launches`` counts
    launches."""
    return _windows_kernel(node_windows, "nic_node_windows", 2, dz1,
                           origins, n, f)


node_windows.launches = 0


def node_volumes(dz1, origins, n: int, f: int) -> tuple:
    """The node volumes on dz1's device → the pair of
    :func:`node_volumes_plain`. A CUDA tensor launches ``nic_node_volumes``
    of ``csrc/train_fused.cu`` (``node_volumes`` and
    ``node_volume_corners`` of ``csrc/train_common.cuh``, the pass that
    K12 and K9 run on their dz1; H a multiple of 64) and raises if it does
    not launch; a CPU tensor runs :func:`node_volumes_plain`.
    ``node_volumes.launches`` counts launches."""
    return _windows_kernel(node_volumes, "nic_node_volumes", 3, dz1,
                           origins, n, f)


node_volumes.launches = 0


def fused_mlp_loss_ng3_kernel(x, tgt, origins, w1, b1, w2, b2, w3, b3, *,
                              n: int, f: int, g0_nodes, g1_nodes, cd=None,
                              gelu: str = "erf") -> tuple:
    """K9 (the 3D kernel2) on the operands' device → the tuple of
    :func:`fused_mlp_loss_ng_plain` with node volumes. ``x`` [crops·n³,
    F] row-major per crop, ``origins`` [crops, 3].

    A CUDA tensor launches ``nic_train_fused_ng3`` of ``csrc/
    train_fused.cu`` (the per-voxel kernel in its node-gradient mode, then
    the node-volume kernel), whose per-crop volumes are placed by
    :func:`_accumulate_node_planes`; a CPU tensor runs the plain version.
    ``fused_mlp_loss_ng3_kernel.launches`` counts kernel launches."""
    if torch.as_tensor(origins).shape[-1] != 3:
        raise ValueError("fused_mlp_loss_ng3_kernel takes 3D origins")
    return _ng_kernel(fused_mlp_loss_ng3_kernel, "nic_train_fused_ng3", x,
                      tgt, origins, (w1, b1, w2, b2, w3, b3), n=n, f=f,
                      g0_nodes=g0_nodes, g1_nodes=g1_nodes, cd=cd, gelu=gelu)


fused_mlp_loss_ng3_kernel.launches = 0


# ---- the autograd functions (the JAX custom VJPs) ----------------------

class _FusedMlpLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tgt, w1, b1, w2, b2, w3, b3, cd, gelu):
        loss, out, dx, *grads = fused_mlp_loss_kernel(
            x, tgt, w1, b1, w2, b2, w3, b3, cd=cd, gelu=gelu)
        ctx.save_for_backward(dx, *grads)
        ctx.mark_non_differentiable(out)
        return loss, out

    @staticmethod
    def backward(ctx, g_loss, _g_out):
        dx, *grads = ctx.saved_tensors
        return (dx * g_loss, None, *(g * g_loss for g in grads), None, None)


def fused_mlp_loss(mlp, x, tgt, matmul_dtype=None, gelu: str = "erf"):
    """(loss, out) of the decoder MLP and the MSE against ``tgt`` [N, 3],
    with the fused kernel's backward: dx·g reaches ``x`` [N, F] (so a
    gather-built ``x`` passes it on to the grids) and dW·g the MLP. Only
    the loss cotangent propagates; ``out`` is aux (the JAX package's
    ``fused_mlp_loss``). ``matmul_dtype``: None (fp32 dots) or
    torch.bfloat16 (bf16 dot inputs, fp32 sums)."""
    return _FusedMlpLoss.apply(x, tgt, mlp["w1"], mlp["b1"], mlp["w2"],
                               mlp["b2"], mlp["w3"], mlp["b3"],
                               matmul_dtype, gelu)


class _FusedMlpLossNg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g0, g1, x, tgt, origins, w1, b1, w2, b2, w3, b3, n, f,
                cd, gelu, corners):
        g0_nodes, g1_nodes = tuple(g0.shape[1:]), tuple(g1.shape[1:])
        kernel = (fused_mlp_loss_ng_kernel if g0.dim() == 3
                  else fused_mlp_loss_ng3_kernel)
        loss, out, *grads, pacc, c1acc = kernel(
            x.detach(), tgt, origins, w1, b1, w2, b2, w3, b3, n=n, f=f,
            g0_nodes=g0_nodes, g1_nodes=g1_nodes, cd=cd, gelu=gelu)
        ctx.save_for_backward(w1, pacc, c1acc, *grads)
        ctx.geometry = (g0_nodes, g1_nodes, g0.shape[0], corners)
        ctx.mark_non_differentiable(out)
        return loss, out

    @staticmethod
    def backward(ctx, g_loss, _g_out):
        w1, pacc, c1acc, *grads = ctx.saved_tensors
        dg0 = dg1 = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            g0_nodes, g1_nodes, channels, corners = ctx.geometry
            dg0, dg1 = _unfold_node_grads(pacc, c1acc, w1, g0_nodes=g0_nodes,
                                          g1_nodes=g1_nodes,
                                          channels=channels, corners=corners)
            dg0, dg1 = dg0 * g_loss, dg1 * g_loss
        return ((dg0, dg1, None, None, None)
                + tuple(g * g_loss for g in grads) + (None,) * 5)


def fused_mlp_loss_ng(g0, g1, mlp, x, tgt, origins, n: int, f: int,
                      matmul_dtype=None, gelu: str = "erf"):
    """(loss, out) with the grid gradients delivered at node resolution
    (the JAX package's ``fused_mlp_loss_ng``). ``g0``/``g1`` [C, s, s] are
    the active grids, whose values the primal does not read: ``x``
    [crops·n², F] already holds the gathered features and arrives detached,
    so dG0/dG1 come only from the unfold of the kernel's node planes, and
    dW·g reaches the MLP. ``origins`` [crops, 2] int crop origins in
    pixels; ``f`` = 1/step the G0 cell period (the caller checks the JAX
    kernel2 gate). Frozen grids (no grad) skip the unfold."""
    return _FusedMlpLossNg.apply(
        g0, g1, x, tgt, origins, mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"],
        mlp["w3"], mlp["b3"], n, f, matmul_dtype, gelu, _CORNERS)


def fused_mlp_loss_ng3(g0, g1, mlp, x, tgt, origins, n: int, f: int,
                       sparse_g0: bool = False, matmul_dtype=None,
                       gelu: str = "erf"):
    """:func:`fused_mlp_loss_ng` in 3D (the JAX package's
    ``fused_mlp_loss_ng3``): grids [C, s, s, s], ``x`` [crops·n³, F],
    ``origins`` [crops, 3]; ``sparse_g0`` unfolds dG0 over method 4's four
    even-parity corners instead of the eight."""
    corners = _CORNERS_3D_SPARSE if sparse_g0 else _CORNERS_3D_DENSE
    return _FusedMlpLossNg.apply(
        g0, g1, x, tgt, origins, mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"],
        mlp["w3"], mlp["b3"], n, f, matmul_dtype, gelu, corners)
