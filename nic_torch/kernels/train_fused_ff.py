"""The feature-free fused train step, kernel3 (port of
``nic.kernels.train_fused_ff``; the CUDA kernel is
``csrc/train_fused_ff.cu``).

One step of the flagship objective without the [N, F] decoder-input
matrix. The MLP's first layer is folded into the grids at node resolution
(``P = Σ_k shift_k(G0)·W1_k``, ``C1 = G1·W1_g1``, :func:`fold_planes`,
torch ops), and for every crop pixel at absolute (y, x) the step rebuilds

    z1 = P[y//f, x//f] + bilinear(C1 at (y/f1, x/f1))
         + tri_row(y/f1)·Wpe0 + tri_col(x/f1)·Wpe1 + (b1 + lod·w_lod)
         + ε·W1                                  (feature noise, if on)

then runs GELU → W2 → GELU → W3 → sigmoid, the MSE loss over all
crops·n²·3 values and the full backward. It emits the loss, ``out``, the
W2/W3/bias grads, the PE grads (PE tables against row/column sums of
dz1), db1, εᵀ·dz1 and the node-resolution cotangents of the P and C1
planes (cell sums and interpolation-weighted sums of dz1), accumulated
into full-grid planes. The backward of the autograd function
(:func:`_unfold_ff`, torch ops) contracts those planes with W1 for
dG0/dG1 and with the grid values for dW1's grid rows.

Counterparts:

- :func:`fused_train_ff_plain`: the same step in torch ops; z1 is built
  from the planes by indexing and autograd runs through the tail (with
  the kernel's hand-written GELU derivative and bf16 rounding of dot
  inputs and of their cotangents), so autograd's gradient with respect
  to the planes is the accumulated dP/dC1;
- :func:`fused_train_ff_kernel`: launches the CUDA kernel for CUDA
  tensors and runs :func:`fused_train_ff_plain` for CPU tensors;
- :func:`fused_train_ff`: the ``torch.autograd.Function`` the trainer
  calls, the counterpart of the JAX ``custom_vjp``.

The in-kernel feature noise is the JAX package's counter hash
(:func:`eps_uniform`): ε = u(hash(gid·fslot + j)) with gid the flat pixel
index in (crop, row-major) order plus a pixel base, bit-exact with JAX.
"""

from __future__ import annotations

import torch

from nic_torch.kernels._widths import (body_blocks, kernel_body,
                                       kernel_width, pad_hidden, pad_mlp,
                                       unpad_all)
from nic_torch.kernels.train_fused import (_CORNERS, GELU_IDS,
                                           _accumulate_node_planes, _cd,
                                           _CdDot, _Gelu, _pad8,
                                           _unfold_node_grads, _window_extents)

__all__ = ["fused_train_ff", "fused_train_ff_kernel", "fused_train_ff_plain",
           "fused_train_ff_padded", "ff_geometry", "eps_uniform",
           "fold_planes", "eps_grad", "eps_grad_plain"]

_M32 = 0xFFFFFFFF


# ---- counter-hash feature noise (bit-exact with the JAX package) ---------

def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32-style avalanche on uint32 values held in int64: logical
    shifts and multiplies wrapped to 32 bits (both constants are < 2^31,
    so every product fits in int64 before the mask)."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def eps_uniform(ctr, s0: int, s1: int, bits: int) -> torch.Tensor:
    """Uniform noise in [−0.5, 0.5)·2^−bits (float32) for int32 counters
    ``ctr`` (any integer tensor; taken mod 2^32) and int32 stream words
    ``s0``/``s1``."""
    x = torch.as_tensor(ctr).to(torch.int64) & _M32
    x = _mix32(x ^ (int(s0) & _M32))
    x = _mix32(x ^ (int(s1) & _M32))
    m = (x >> 9) | 0x3F800000
    u = m.to(torch.int32).view(torch.float32) - 1.5
    return u * (2.0 ** (-bits))


def ff_geometry(*, crops: int, n: int, rowsb: int, f: int, hidden: int,
                pe_channels: int, oc: int = 3) -> bool:
    """The JAX kernel's eligibility gate, kept so the same geometries take
    kernel3 in both packages (the CUDA kernel has no lane or tile limits
    of its own; every H it admits runs at the instantiated H = 64,
    zero-padded, and any F runs)."""
    f1 = 2 * f
    nb = n // rowsb
    return (
        2 * hidden <= 128
        and 2 * oc <= 8
        and pe_channels <= 8
        and f1 <= 8
        and rowsb >= f1
        and rowsb % f1 == 0
        and n % rowsb == 0
        and nb % 2 == 0
        and (rowsb * n) % 128 == 0
        and (n + 8) % f == 0
        and (n + 8) % f1 == 0
    )


def _tri_slot_consts(npe: int) -> list[tuple[float, float, float]]:
    """Per PE row (valid, 1/2^octave, offset) of the triangular encoding,
    including the skipped (octave 0, offset 0.5) zero row."""
    octs = npe // 2
    out = []
    for r in range(npe):
        j = npe - 1 - r
        if j == 0 or j >= 2 * octs:
            out.append((0.0, 1.0, 0.0))
        else:
            out.append((1.0, 1.0 / (2.0 ** (j // 2)),
                        0.5 if j % 2 == 0 else 0.0))
    return out


def _tri_table(t: torch.Tensor, npe: int) -> torch.Tensor:
    """[..] coordinates (G1 units) → [.., npe] triangle-wave table."""
    cols = []
    for valid, inv_div, off in _tri_slot_consts(npe):
        u = t * inv_div - off
        m = u - 2.0 * torch.floor(u * 0.5)
        cols.append(valid * (2.0 * torch.abs(m - 1.0) - 1.0))
    return torch.stack(cols, dim=-1)


# ---- the fold (torch ops, as the JAX package leaves it to XLA) ---------

def fold_planes(g0: torch.Tensor, g1: torch.Tensor, w1: torch.Tensor,
                cd=None) -> tuple[torch.Tensor, torch.Tensor]:
    """P [g0r−1, g0c−1, H] = Σ_k shift_k(G0)ᵀ·W1_k and C1 [g1r, g1c, H] =
    G1ᵀ·W1_g1, with dot inputs rounded to ``cd`` and fp32 sums."""
    ch = g0.shape[0]
    cells_r, cells_c = g0.shape[1] - 1, g0.shape[2] - 1
    p_plane = None
    for k, (a, b) in enumerate(_CORNERS):
        sl = g0[:, a:a + cells_r, b:b + cells_c].permute(1, 2, 0)
        term = _cd(sl, cd) @ _cd(w1[k * ch:(k + 1) * ch], cd)
        p_plane = term if p_plane is None else p_plane + term
    c1_plane = _cd(g1.permute(1, 2, 0), cd) @ _cd(w1[4 * ch:5 * ch], cd)
    return p_plane.contiguous(), c1_plane.contiguous()


# ---- the plain version -------------------------------------------------

def _noise(npix: int, nfeat: int, seed, nbits: int, device):
    """ε [npix, nfeat] of the in-kernel stream; counters gid·fslot + j
    with gid = flat pixel index + seed[2]."""
    s0, s1, base = (int(v) for v in torch.as_tensor(seed).tolist()[:3])
    fslot = _pad8(nfeat)
    gid = torch.arange(npix, dtype=torch.int64, device=device) + base
    ctr = gid[:, None] * fslot + torch.arange(nfeat, device=device)[None]
    return eps_uniform(ctr, s0, s1, nbits)


def _node_plane_shapes(g0_nodes, g1_nodes):
    return ((g0_nodes[0] + 1, g0_nodes[1] + 1),
            (g1_nodes[0] + 2, g1_nodes[1] + 2))


def fused_train_ff_plain(p_plane, c1_plane, w1, b1, w2, b2, w3, b3, tgt,
                         origins, seed, *, n: int, f: int, npe: int,
                         lodf: float, cd=None, gelu: str = "erf",
                         nbits: int | None = None,
                         with_dz1: bool = False) -> tuple:
    """The kernel's step in torch ops. ``p_plane`` [g0r−1, g0c−1, H] and
    ``c1_plane`` [g1r, g1c, H] from :func:`fold_planes`; ``tgt``
    [crops·n², 3]; ``origins`` [crops, 2] int; ``seed`` [4] int32
    (s0, s1, pixel base, 0), read only when ``nbits`` is set.

    Returns (loss, out [N, 3], dw2, db2, dw3, db3, dpe0, dpe1, db1,
    P_acc [g0r+1, g0c+1, H], C1_acc [g1r+2, g1c+2, H], dw1e or None), and
    with ``with_dz1`` then dz1 [N, H], the fp32 cotangent of z1 that the
    kernel reduces to everything after dw1e."""
    device = p_plane.device
    hidden = w2.shape[0]
    ch = (w1.shape[0] - 2 * npe - 1) // 5
    crops = origins.shape[0]
    f1 = 2 * f
    g0_nodes = (p_plane.shape[0] + 1, p_plane.shape[1] + 1)
    g1_nodes = tuple(c1_plane.shape[:2])
    (pr, pc), (cr, cc) = _node_plane_shapes(g0_nodes, g1_nodes)
    with torch.enable_grad():
        pacc = torch.zeros((pr, pc, hidden), device=device)
        pacc[:g0_nodes[0] - 1, :g0_nodes[1] - 1] = p_plane.detach()
        c1acc = torch.zeros((cr, cc, hidden), device=device)
        c1acc[:g1_nodes[0], :g1_nodes[1]] = c1_plane.detach()
        base = 5 * ch
        leaves = {
            "pacc": pacc, "c1acc": c1acc,
            "wpe0": w1[base:base + npe].detach().float(),
            "wpe1": w1[base + npe:base + 2 * npe].detach().float(),
            "bvec": (b1.float() + lodf * w1[base + 2 * npe].float()).detach(),
            "w2": w2.detach().float(), "b2": b2.detach().float(),
            "w3": w3.detach().float(), "b3": b3.detach().float(),
        }
        if nbits is not None:
            leaves["w1n"] = w1.detach().float()
        for t in leaves.values():
            t.requires_grad_(True)

        org = torch.as_tensor(origins, device=device).long()
        ar = torch.arange(n, device=device)
        ys = org[:, 0, None] + ar                      # [B, n] absolute rows
        xs = org[:, 1, None] + ar
        g0t = pacc[(ys // f)[:, :, None], (xs // f)[:, None, :]]
        r1, c1 = (ys // f1)[:, :, None], (xs // f1)[:, None, :]
        fu_r = ((ys % f1).float() * (1.0 / f1))[:, :, None, None]
        fu_c = ((xs % f1).float() * (1.0 / f1))[:, None, :, None]
        ra = (1.0 - fu_c) * c1acc[r1, c1] + fu_c * c1acc[r1, c1 + 1]
        rb = (1.0 - fu_c) * c1acc[r1 + 1, c1] + fu_c * c1acc[r1 + 1, c1 + 1]
        c1t = (1.0 - fu_r) * ra + fu_r * rb
        peu = _tri_table(ys.float() * (1.0 / f1), npe) @ leaves["wpe0"]
        colterm = _tri_table(xs.float() * (1.0 / f1), npe) @ leaves["wpe1"]
        z1 = (g0t + c1t + peu[:, :, None, :] + colterm[:, None, :, :]
              + leaves["bvec"]).reshape(-1, hidden)
        if nbits is not None:
            eps = _noise(crops * n * n, w1.shape[0], seed, nbits, device)
            z1 = z1 + _CdDot.apply(eps, leaves["w1n"], cd)
        h1 = _Gelu.apply(z1, gelu)
        h2 = _Gelu.apply(_CdDot.apply(h1, leaves["w2"], cd) + leaves["b2"],
                         gelu)
        out = torch.sigmoid(_CdDot.apply(h2, leaves["w3"], cd) + leaves["b3"])
        diff = out - tgt.float()
        loss = torch.sum(diff * diff) * (1.0 / diff.numel())
        names = list(leaves)
        grads = dict(zip(names + ["z1"], torch.autograd.grad(
            loss, [leaves[k] for k in names] + ([z1] if with_dz1 else []))))
    return (loss.detach(), out.detach(), grads["w2"], grads["b2"],
            grads["w3"], grads["b3"], grads["wpe0"], grads["wpe1"],
            grads["bvec"], grads["pacc"], grads["c1acc"], grads.get("w1n")
            ) + ((grads["z1"],) if with_dz1 else ())


def eps_grad_plain(dz1, nfeat: int, fslot: int, s0: int, s1: int,
                   nbits: int, pixel_base: int = 0,
                   bf16: bool = False) -> torch.Tensor:
    """εᵀ·dz1 [nfeat, H] in torch ops, for dz1 [npix, H] and the counter-
    hash ε [npix, nfeat] of :func:`eps_uniform` (counter (pixel +
    ``pixel_base``)·``fslot`` + feature, stream words ``s0``/``s1``,
    2^−``nbits``); with ``bf16`` both rounded to bf16 before the product,
    which sums in fp32 (the kernels' dot, and the plain step's dw1e)."""
    gid = torch.arange(dz1.shape[0], dtype=torch.int64,
                       device=dz1.device) + int(pixel_base)
    ctr = gid[:, None] * fslot + torch.arange(nfeat, device=dz1.device)[None]
    cd = torch.bfloat16 if bf16 else None
    return _cd(eps_uniform(ctr, s0, s1, nbits), cd).T @ _cd(dz1.float(), cd)


def eps_grad(dz1, nfeat: int, fslot: int, s0: int, s1: int, nbits: int,
             pixel_base: int = 0, bf16: bool = False,
             feat_pass: int = 80) -> torch.Tensor:
    """εᵀ·dz1 on dz1's device → :func:`eps_grad_plain`'s [nfeat, H]. A
    CUDA tensor launches ``nic_eps_grad`` of ``csrc/train_fused_ff.cu``
    (``ff_epsgrad`` of ``csrc/train_common.cuh``, the pass K11 and K12 run
    on their dz1, with the features in passes of ``feat_pass``: K11's H =
    64 with 80, K12's 64 with 128 or 128 with 64), 2 blocks an SM whose
    partials are summed in a fixed order, and raises if it does not
    launch; a CPU tensor runs :func:`eps_grad_plain`.
    ``eps_grad.launches`` counts launches."""
    if dz1.device.type == "cpu":
        return eps_grad_plain(dz1, nfeat, fslot, s0, s1, nbits, pixel_base,
                              bf16)
    if dz1.device.type != "cuda":
        raise ValueError(f"eps_grad runs on cuda or cpu, not {dz1.device}")
    from nic_torch.kernels import _build

    lib = _build.load()
    device = dz1.device
    npix, hidden = dz1.shape
    dz = dz1.detach().to(torch.float32).contiguous()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    nblk = min(-(-npix // 128), 2 * sms)
    part = torch.empty((nblk, nfeat, hidden), dtype=torch.float32,
                       device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.nic_eps_grad(dz.data_ptr(), part.data_ptr(), npix, nfeat,
                              fslot, hidden, feat_pass, int(bf16), nbits,
                              s0, s1, pixel_base, nblk, stream)
    if rc != 0:
        raise RuntimeError("eps_grad kernel launch failed: "
                           + lib.nic_cuda_error_string(rc).decode())
    eps_grad.launches += 1
    return part.sum(dim=0)


eps_grad.launches = 0


# ---- hidden-width padding ----------------------------------------------

# the hidden axes of the step's results, in the order of
# fused_train_ff_plain's tuple (None: no hidden axis)
_OUT_DIMS = (None, None, (0, 1), (-1,), (0,), None, (-1,), (-1,), (-1,),
             (-1,), (-1,), (-1,))


def fused_train_ff_padded(fn, width: int, p_plane, c1_plane, w1, b1, w2, b2,
                          w3, b3, tgt, origins, seed, **kw) -> tuple:
    """``fn`` (:func:`fused_train_ff_kernel` or
    :func:`fused_train_ff_plain`) at hidden width ``width`` ≥ H on
    operands zero-padded along the hidden axis (the planes' last axis,
    W1's columns, b1, W2's rows and columns, b2, W3's rows), with every
    result sliced back to H: the same step (``_widths``)."""
    hidden = w2.shape[0]
    outs = fn(pad_hidden(p_plane, width), pad_hidden(c1_plane, width),
              *pad_mlp(w1, b1, w2, b2, w3, b3, width), tgt, origins, seed,
              **kw)
    return unpad_all(outs, hidden, _OUT_DIMS)


# ---- the CUDA wrapper --------------------------------------------------

def _check(p_plane, c1_plane, w1, b1, w2, b2, w3, b3, tgt, origins, n, f,
           npe, cd, gelu) -> None:
    tensors = (p_plane, c1_plane, w1, b1, w2, b2, w3, b3, tgt)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("fused_train_ff: operands on different devices: "
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
    want = {"p_plane": (p_plane.shape[0], p_plane.shape[1], hidden),
            "c1_plane": (c1_plane.shape[0], c1_plane.shape[1], hidden),
            "w1": (w1.shape[0], hidden), "b1": (hidden,),
            "w2": (hidden, hidden), "b2": (hidden,), "w3": (hidden, 3),
            "b3": (3,), "tgt": (crops * n * n, 3), "origins": (crops, 2)}
    got = {"p_plane": p_plane.shape, "c1_plane": c1_plane.shape,
           "w1": w1.shape, "b1": b1.shape, "w2": w2.shape, "b2": b2.shape,
           "w3": w3.shape, "b3": b3.shape, "tgt": tgt.shape,
           "origins": origins.shape}
    for k, shape in want.items():
        if tuple(got[k]) != shape:
            raise ValueError(f"{k} has shape {tuple(got[k])}, expected "
                             f"{shape}")
    if (w1.shape[0] - 2 * npe - 1) % 5 or npe > 8:
        raise ValueError(f"W1 has {w1.shape[0]} rows: not 5·C + 2·{npe} + 1 "
                         "with pe ≤ 8")
    # every crop inside the planes: the kernel indexes them unchecked
    org = origins.cpu()
    last = org.max(dim=0).values + n - 1
    if int(org.min()) < 0 or any(int(last[d]) // f >= p_plane.shape[d]
                                 for d in (0, 1)):
        raise ValueError(f"crop origins {org.tolist()} with n={n}, f={f} "
                         f"reach outside the {tuple(p_plane.shape[:2])} P "
                         "plane")


def fused_train_ff_kernel(p_plane, c1_plane, w1, b1, w2, b2, w3, b3, tgt,
                          origins, seed, *, n: int, f: int, npe: int,
                          lodf: float, cd=None, gelu: str = "erf",
                          nbits: int | None = None) -> tuple:
    """The step on the planes' device → the tuple of
    :func:`fused_train_ff_plain`.

    A CUDA tensor launches ``csrc/train_fused_ff.cu`` (and raises if it
    does not build or launch), a hidden width below the instantiated 64
    zero-padded to it (:func:`fused_train_ff_padded`); a CPU tensor runs
    :func:`fused_train_ff_plain`. ``fused_train_ff_kernel.launches``
    counts kernel launches."""
    origins = torch.as_tensor(origins)
    _check(p_plane, c1_plane, w1, b1, w2, b2, w3, b3, tgt, origins, n, f,
           npe, cd, gelu)
    kw = dict(n=n, f=f, npe=npe, lodf=lodf, cd=cd, gelu=gelu, nbits=nbits)
    device = p_plane.device
    if device.type == "cpu":
        return fused_train_ff_plain(p_plane, c1_plane, w1, b1, w2, b2, w3, b3,
                                    tgt, origins, seed, **kw)
    if device.type != "cuda":
        raise ValueError(f"fused_train_ff runs on cuda or cpu, not {device}")
    hidden = w2.shape[0]
    width = kernel_width("train_ff", hidden)
    if width != hidden:
        return fused_train_ff_padded(fused_train_ff_kernel, width, p_plane,
                                     c1_plane, w1, b1, w2, b2, w3, b3, tgt,
                                     origins, seed, **kw)
    from nic_torch.kernels import _build

    lib = _build.load()
    f32 = torch.float32
    crops = origins.shape[0]
    npix = crops * n * n
    nfeat = w1.shape[0]
    ch = (nfeat - 2 * npe - 1) // 5
    base = 5 * ch
    g0_nodes = (p_plane.shape[0] + 1, p_plane.shape[1] + 1)
    g1_nodes = tuple(c1_plane.shape[:2])

    def prep(t):
        return t.detach().to(f32).contiguous()

    w1f = prep(w1)
    if w1f.data_ptr() % 16:  # the kernel may read its rows as float4
        w1f = w1f.clone()
    bvec = prep(b1.float() + lodf * w1[base + 2 * npe].float())
    wpe0 = prep(w1[base:base + npe])
    wpe1 = prep(w1[base + npe:base + 2 * npe])
    w2f, b2f, w3f, b3f = prep(w2), prep(b2), prep(w3), prep(b3)
    p_c, c1_c, tgt_c = prep(p_plane), prep(c1_plane), prep(tgt)
    org = origins.to(device=device, dtype=torch.int32).contiguous()
    s0, s1, pixel_base = (0, 0, 0) if nbits is None else (
        int(v) for v in torch.as_tensor(seed).tolist()[:3])

    rows0, cols0, rows1, cols1 = _window_extents(n, f)
    tiles = -(-npix // 128)
    body = kernel_body("train_ff", hidden, cd is not None)
    nblk_mlp = body_blocks(body, tiles, device)
    nblk_eps = min(tiles, 264) if nbits is not None else 0
    part_len = 4 + 4 * hidden + hidden * hidden
    empty = lambda *s: torch.empty(s, dtype=f32, device=device)  # noqa: E731
    out = empty(npix, 3)
    dz1 = empty(npix, hidden)
    part_mlp = empty(nblk_mlp, part_len)
    win_p = empty(crops, rows0, cols0, hidden)
    win_c1 = empty(crops, rows1, cols1, hidden)
    corners = empty(crops, rows1, cols1, 4, hidden)  # C1 cell corners
    sums = empty(2, crops, n, hidden)
    pe_grads = empty(2 * npe + 1, hidden)
    part_eps = empty(max(nblk_eps, 1), nfeat, hidden)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.nic_train_fused_ff(
            p_c.data_ptr(), c1_c.data_ptr(), w1f.data_ptr(), bvec.data_ptr(),
            wpe0.data_ptr(), wpe1.data_ptr(), w2f.data_ptr(), b2f.data_ptr(),
            w3f.data_ptr(), b3f.data_ptr(), tgt_c.data_ptr(), org.data_ptr(),
            out.data_ptr(), dz1.data_ptr(), part_mlp.data_ptr(),
            win_p.data_ptr(), win_c1.data_ptr(), corners.data_ptr(),
            sums.data_ptr(),
            pe_grads.data_ptr(), part_eps.data_ptr(),
            crops, n, f, p_c.shape[0], p_c.shape[1], c1_c.shape[0],
            c1_c.shape[1], hidden, npe, nfeat, _pad8(nfeat),
            int(cd is not None), GELU_IDS[gelu], int(body.endswith("_mma")),
            0 if nbits is None else int(nbits), s0, s1, pixel_base,
            nblk_mlp, nblk_eps, stream)
    if rc != 0:
        raise RuntimeError("train_fused_ff kernel launch failed: "
                           + lib.nic_cuda_error_string(rc).decode())
    fused_train_ff_kernel.launches += 1

    # fixed-order sums of the per-block partials (the JAX package's
    # _extract_ff), then the per-crop windows into full-grid planes
    part = part_mlp.sum(dim=0)
    o = 4 + 3 * hidden
    loss, db3 = part[0], part[1:4]
    dw3 = part[4:o].reshape(hidden, 3)
    db2 = part[o:o + hidden]
    dw2 = part[o + hidden:].reshape(hidden, hidden)
    dpe0, dpe1, db1 = pe_grads[:npe], pe_grads[npe:2 * npe], pe_grads[2 * npe]
    dw1e = part_eps.sum(dim=0) if nbits is not None else None
    pacc, c1acc = _accumulate_node_planes(win_p, win_c1, origins, f=f,
                                          g0_nodes=g0_nodes,
                                          g1_nodes=g1_nodes)
    return (loss, out, dw2, db2, dw3, db3, dpe0, dpe1, db1, pacc, c1acc,
            dw1e)


fused_train_ff_kernel.launches = 0


# ---- the backward tail and the autograd function -----------------------

def _unfold_ff(pacc, c1acc, g0, g1, w1, db1, dpe0, dpe1, *, lodf: float,
               grids: bool = True):
    """Contract the accumulated node planes with W1 for (dG0, dG1) and with
    the grid values for dW1's grid rows; PE rows from the kernel, the LOD
    row is lod·db1. ``grids=False`` skips dG0/dG1 (frozen grids)."""
    f32 = torch.float32
    ch = g0.shape[0]
    hidden = w1.shape[1]
    g0r, g0c = g0.shape[1], g0.shape[2]
    g1r, g1c = g1.shape[1], g1.shape[2]
    dg0 = dg1 = None
    if grids:
        dg0, dg1 = _unfold_node_grads(pacc, c1acc, w1, g0_nodes=(g0r, g0c),
                                      g1_nodes=(g1r, g1c), channels=ch)
    g0p = torch.nn.functional.pad(g0.detach().to(f32), (0, 2, 0, 2))
    g1p = torch.nn.functional.pad(g1.detach().to(f32), (0, 2, 0, 2))
    pflat = pacc.reshape(-1, hidden)
    rows = [g0p[:, a:a + g0r + 1, b:b + g0c + 1].reshape(ch, -1) @ pflat
            for a, b in _CORNERS]
    rows.append(g1p[:, :g1r + 2, :g1c + 2].reshape(ch, -1)
                @ c1acc.reshape(-1, hidden))
    rows += [dpe0, dpe1, lodf * db1[None, :]]
    return dg0, dg1, torch.cat(rows, dim=0)


class _FusedTrainFF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g0, g1, w1, b1, w2, b2, w3, b3, tgt, origins, seed,
                n, f, npe, lodf, cd, gelu, nbits):
        p_plane, c1_plane = fold_planes(g0, g1, w1, cd)
        (loss, out, dw2, db2, dw3, db3, dpe0, dpe1, db1, pacc, c1acc,
         dw1e) = fused_train_ff_kernel(
            p_plane, c1_plane, w1, b1, w2, b2, w3, b3, tgt, origins, seed,
            n=n, f=f, npe=npe, lodf=lodf, cd=cd, gelu=gelu, nbits=nbits)
        ctx.save_for_backward(g0, g1, w1, pacc, c1acc, dpe0, dpe1, db1, dw2,
                              db2, dw3, db3,
                              *(() if dw1e is None else (dw1e,)))
        ctx.lodf = lodf
        ctx.mark_non_differentiable(out)
        return loss, out

    @staticmethod
    def backward(ctx, g_loss, _g_out):
        (g0, g1, w1, pacc, c1acc, dpe0, dpe1, db1, dw2, db2, dw3, db3,
         *dw1e) = ctx.saved_tensors
        grids = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        dg0, dg1, dw1 = _unfold_ff(pacc, c1acc, g0, g1, w1, db1, dpe0, dpe1,
                                   lodf=ctx.lodf, grids=grids)
        if dw1e:
            dw1 = dw1 + dw1e[0]
        scale = lambda t: None if t is None else t * g_loss  # noqa: E731
        return (scale(dg0), scale(dg1), scale(dw1), scale(db1), scale(dw2),
                scale(db2), scale(dw3), scale(db3)) + (None,) * 10


def fused_train_ff(g0, g1, mlp, tgt, origins, seed, n: int, f: int,
                   npe: int, lodf: float, matmul_dtype=None,
                   gelu: str = "erf", noise_bits: int | None = None):
    """(loss, out) of the flagship objective with the feature build fused
    into the kernel; gradients reach ``g0``/``g1`` (the active, possibly
    node-noised grids, [C, s+1, s+1]) and every MLP parameter through the
    hand-built backward. ``origins`` [crops, 2] int crop origins; ``seed``
    [4] int32 (s0, s1, pixel base, 0), read when ``noise_bits`` is set.
    ``matmul_dtype``: None (fp32 dots) or torch.bfloat16 (bf16 dot
    inputs, fp32 sums). Triangular PE only; the caller checks
    :func:`ff_geometry`."""
    return _FusedTrainFF.apply(
        g0, g1, mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"], mlp["w3"],
        mlp["b3"], tgt, origins, seed, n, f, npe, lodf, matmul_dtype, gelu,
        noise_bits)
