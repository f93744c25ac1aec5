"""The fused MLP train kernels on gather-built features (port of
``nic.kernels.train_fused``, 2D), and the helpers kernel3 shares with them.
The CUDA kernels are ``csrc/train_fused.cu``.

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
  them (:func:`_unfold_node_grads`) into dG0/dG1.

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
and the unfold.
"""

from __future__ import annotations

import torch

from nic_torch.kernels.decode_fused_v2 import _GELU_POLY_C, _erf

__all__ = ["pick_block_rows", "fused_mlp_loss", "fused_mlp_loss_kernel",
           "fused_mlp_loss_plain", "fused_mlp_loss_ng",
           "fused_mlp_loss_ng_kernel", "fused_mlp_loss_ng_plain"]

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT2PI = 0.3989422804014327
_KERNEL_HIDDEN = (64,)  # widths the .cu files instantiate
_KERNEL_MAX_FEAT = 80   # decoder-input widths csrc/train_fused.cu takes
GELU_IDS = {"erf": 0, "poly": 1}
_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


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


def _node_counts(nodes) -> tuple[int, int]:
    return (nodes, nodes) if isinstance(nodes, int) else tuple(nodes)


def _window_extents(n: int, f: int) -> tuple[int, int, int, int]:
    """Per-crop node-window extents (rows0, cols0, rows1, cols1): a crop's
    dz1 reaches at most these many P cells and C1 nodes per axis."""
    f1 = 2 * f
    return ((n + f - 2) // f + 1, (n + f - 2) // f + 1,
            (n + f1 - 2) // f1 + 2, n // f1 + 2)


def _accumulate_node_planes(win_p, win_c1, origins, *, f: int, g0_nodes,
                            g1_nodes):
    """Per-crop node windows → full-grid planes (P [g0_rows+1, g0_cols+1, H]
    of cell sums of dz1, C1 [g1_rows+2, g1_cols+2, H] of interp-weighted
    sums).

    ``win_p`` [crops, rows0, cols0, H] and ``win_c1`` [crops, rows1, cols1,
    H] (the extents of :func:`_window_extents`) are each crop's windows,
    whose corners sit at origin // f and origin // 2f; ``origins`` [crops,
    2]. The windows are added into the planes one crop after the other."""
    g0r, g0c = _node_counts(g0_nodes)
    g1r, g1c = _node_counts(g1_nodes)
    orgs = torch.as_tensor(origins).cpu().tolist()
    planes = []
    for win, shape, step in ((win_p, (g0r + 1, g0c + 1), f),
                             (win_c1, (g1r + 2, g1c + 2), 2 * f)):
        plane = win.new_zeros(shape + win.shape[3:])
        rows, cols = win.shape[1:3]
        for i, (o0, o1) in enumerate(orgs):
            r0, c0 = o0 // step, o1 // step
            plane[r0:r0 + rows, c0:c0 + cols] += win[i]
        planes.append(plane)
    return tuple(planes)


def _unfold_node_grads(pacc, c1acc, w1, *, g0_nodes, g1_nodes,
                       channels: int):
    """(dG0 [C, g0r, g0c], dG1 [C, g1r, g1c]) from the accumulated node
    planes (the JAX package's ``_unfold_node_grads`` after its
    accumulation): dG0 is the four shifted adds of P·W1_kᵀ in the corner
    order (0,0), (0,1), (1,0), (1,1), with W1_k the rows k·C:(k+1)·C; dG1
    is C1·W1_g1ᵀ with the rows 4C:5C; both cropped to the grids."""
    g0r, g0c = _node_counts(g0_nodes)
    g1r, g1c = _node_counts(g1_nodes)
    ch = channels
    w1 = w1.detach().to(torch.float32)
    dg0 = pacc.new_zeros((g0r + 2, g0c + 2, ch))
    for k, (a, b) in enumerate(_CORNERS):
        dg0[a:a + g0r + 1, b:b + g0c + 1] += pacc @ w1[k * ch:(k + 1) * ch].T
    dg1 = (c1acc @ w1[4 * ch:5 * ch].T)[:g1r, :g1c]
    return dg0[:g0r, :g0c].permute(2, 0, 1), dg1.permute(2, 0, 1)


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
    """The node-resolution cotangents of dz1 [crops·n², H] (crops of n²
    pixels at ``origins`` [crops, 2], row-major per crop), as the formula:
    P [g0r+1, g0c+1, H] with P[cell] = Σ dz1 over the pixels of each G0
    cell at period f, and C1 [g1r+2, g1c+2, H], where each pixel adds its
    dz1 with bilinear weights (1−u)(1−v), (1−u)v, u(1−v), uv to its four G1
    nodes at period 2f (u, v the phases of the absolute coordinate)."""
    g0r, g0c = _node_counts(g0_nodes)
    g1r, g1c = _node_counts(g1_nodes)
    hidden = dz1.shape[1]
    crops = origins.shape[0]
    f1 = 2 * f
    org = origins.to(dz1.device).long()
    ar = torch.arange(n, device=dz1.device)
    ys, xs = org[:, 0, None] + ar, org[:, 1, None] + ar    # [crops, n]
    d = dz1.reshape(crops, n, n, hidden)
    pacc = dz1.new_zeros((g0r + 1, g0c + 1, hidden))
    pacc.index_put_(((ys // f)[:, :, None], (xs // f)[:, None, :]), d,
                    accumulate=True)
    u = (ys % f1).float() * (1.0 / f1)
    v = (xs % f1).float() * (1.0 / f1)
    r1, c1 = ys // f1, xs // f1
    c1acc = dz1.new_zeros((g1r + 2, g1c + 2, hidden))
    for a, wr in ((0, 1.0 - u), (1, u)):
        for b, wc in ((0, 1.0 - v), (1, v)):
            w = wr[:, :, None, None] * wc[:, None, :, None]
            c1acc.index_put_(((r1 + a)[:, :, None], (c1 + b)[:, None, :]),
                             w * d, accumulate=True)
    return pacc, c1acc


def fused_mlp_loss_ng_plain(x, tgt, origins, w1, b1, w2, b2, w3, b3, *,
                            n: int, f: int, g0_nodes, g1_nodes, cd=None,
                            gelu: str = "erf") -> tuple:
    """K7's step in torch ops → (loss, out [N, 3], dw1, db1, dw2, db2, dw3,
    db3, P_acc [g0r+1, g0c+1, H], C1_acc [g1r+2, g1c+2, H]); the node
    planes are :func:`_node_sums` of the fp32 dz1."""
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
    if x.device.type == "cuda" and (hidden not in _KERNEL_HIDDEN
                                    or feat > _KERNEL_MAX_FEAT):
        raise ValueError(f"the CUDA kernel is built for hidden widths "
                         f"{_KERNEL_HIDDEN} and at most {_KERNEL_MAX_FEAT} "
                         f"features, not H={hidden}, F={feat}")


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
    return [t.detach().to(torch.float32).contiguous() for t in tensors]


def _partials(npix: int, feat: int, hidden: int, device):
    """(per-block partial rows [nblk, 4 + 5H + H² + F·H], nblk): one block
    of 128-pixel tiles per SM (the kernel's shared memory allows one)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    nblk = min(-(-npix // 128), sms)
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
    train_fused.cu`` (and raises if it does not build or launch); a CPU
    tensor runs :func:`fused_mlp_loss_plain`.
    ``fused_mlp_loss_kernel.launches`` counts kernel launches."""
    _check("fused_mlp_loss", x, tgt, w1, b1, w2, b2, w3, b3, cd, gelu)
    weights = (w1, b1, w2, b2, w3, b3)
    if x.device.type == "cpu":
        return fused_mlp_loss_plain(x, tgt, *weights, cd=cd, gelu=gelu)
    device = x.device
    npix, feat = x.shape
    hidden = w2.shape[0]
    out = torch.empty((npix, 3), dtype=torch.float32, device=device)
    dx = torch.empty((npix, feat), dtype=torch.float32, device=device)
    part, nblk = _partials(npix, feat, hidden, device)
    _call("nic_train_fused_dx", (*_prep(x, tgt, *weights), out, dx, part),
          (npix, feat, hidden, int(cd is not None), GELU_IDS[gelu], nblk),
          device)
    fused_mlp_loss_kernel.launches += 1
    loss, *grads = _sum_partials(part, hidden, feat)
    return (loss, out, dx, *grads)


fused_mlp_loss_kernel.launches = 0


def _check_origins(origins, n: int, f: int, g0_nodes, g1_nodes) -> None:
    """Every crop's node windows inside the full-grid planes (the wrapper
    places them by slicing, which would clip silently)."""
    rows0, cols0, rows1, cols1 = _window_extents(n, f)
    g0r, g0c = _node_counts(g0_nodes)
    g1r, g1c = _node_counts(g1_nodes)
    org = origins.cpu()
    ok = org.dim() == 2 and org.shape[1] == 2 and int(org.min()) >= 0
    if ok:
        last = org.max(dim=0).values
        ok = (int(last[0]) // f + rows0 <= g0r + 1
              and int(last[1]) // f + cols0 <= g0c + 1
              and int(last[0]) // (2 * f) + rows1 <= g1r + 2
              and int(last[1]) // (2 * f) + cols1 <= g1c + 2)
    if not ok:
        raise ValueError(f"crop origins {org.tolist()} with n={n}, f={f} "
                         f"reach outside grids of {(g0r, g0c)} and "
                         f"{(g1r, g1c)} nodes")


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
    _check("fused_mlp_loss_ng", x, tgt, w1, b1, w2, b2, w3, b3, cd, gelu)
    origins = torch.as_tensor(origins)
    if f < 1 or f & (f - 1):
        raise ValueError(f"f={f} must be a power of two")
    crops = origins.shape[0]
    if x.shape[0] != crops * n * n:
        raise ValueError(f"x has {x.shape[0]} rows, not crops·n² = "
                         f"{crops}·{n}²")
    _check_origins(origins, n, f, g0_nodes, g1_nodes)
    weights = (w1, b1, w2, b2, w3, b3)
    kw = dict(n=n, f=f, g0_nodes=g0_nodes, g1_nodes=g1_nodes, cd=cd,
              gelu=gelu)
    if x.device.type == "cpu":
        return fused_mlp_loss_ng_plain(x, tgt, origins, *weights, **kw)
    device = x.device
    npix, feat = x.shape
    hidden = w2.shape[0]
    rows0, cols0, rows1, cols1 = _window_extents(n, f)
    empty = lambda *s: torch.empty(s, dtype=torch.float32,  # noqa: E731
                                   device=device)
    out, dz1 = empty(npix, 3), empty(npix, hidden)
    win_p = empty(crops, rows0, cols0, hidden)
    win_c1 = empty(crops, rows1, cols1, hidden)
    org = origins.to(device=device, dtype=torch.int32).contiguous()
    part, nblk = _partials(npix, feat, hidden, device)
    xs, tg, *ws = _prep(x, tgt, *weights)
    _call("nic_train_fused_ng",
          (xs, tg, org, *ws, out, dz1, part, win_p, win_c1),
          (crops, n, f, feat, hidden, int(cd is not None), GELU_IDS[gelu],
           nblk), device)
    fused_mlp_loss_ng_kernel.launches += 1
    loss, *grads = _sum_partials(part, hidden, feat)
    planes = _accumulate_node_planes(win_p, win_c1, origins, f=f,
                                     g0_nodes=g0_nodes, g1_nodes=g1_nodes)
    return (loss, out, *grads, *planes)


fused_mlp_loss_ng_kernel.launches = 0


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
                cd, gelu):
        g0_nodes, g1_nodes = tuple(g0.shape[1:]), tuple(g1.shape[1:])
        loss, out, *grads, pacc, c1acc = fused_mlp_loss_ng_kernel(
            x.detach(), tgt, origins, w1, b1, w2, b2, w3, b3, n=n, f=f,
            g0_nodes=g0_nodes, g1_nodes=g1_nodes, cd=cd, gelu=gelu)
        ctx.save_for_backward(w1, pacc, c1acc, *grads)
        ctx.geometry = (g0_nodes, g1_nodes, g0.shape[0])
        ctx.mark_non_differentiable(out)
        return loss, out

    @staticmethod
    def backward(ctx, g_loss, _g_out):
        w1, pacc, c1acc, *grads = ctx.saved_tensors
        dg0 = dg1 = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            g0_nodes, g1_nodes, ch = ctx.geometry
            dg0, dg1 = _unfold_node_grads(pacc, c1acc, w1, g0_nodes=g0_nodes,
                                          g1_nodes=g1_nodes, channels=ch)
            dg0, dg1 = dg0 * g_loss, dg1 * g_loss
        return ((dg0, dg1, None, None, None)
                + tuple(g * g_loss for g in grads) + (None,) * 4)


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
        mlp["w3"], mlp["b3"], n, f, matmul_dtype, gelu)
