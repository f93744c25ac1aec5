"""The per-pixel bodies of the train kernels: which one runs, and the
shapes the tensor-core bodies mask.

The body table (``nic_torch/kernels/_widths.py`` ``kernel_body``) is pure
Python: for every train family (K11 ``train_ff``; K12 ``train_ff3``; K6,
K7 and K9 ``train_mlp``), every hidden width 1..128 its kernels take and
both dot types, bf16 dots at H ≤ 64 pick the bf16 tensor-core body
(``*_mma``); fp32 dots at H ≤ 64 pick K11's and K12's 3xTF32 tensor-core
bodies (``ff_pixel_tf32``, ``ff3_pixel_tf32``) and ``train_mlp``'s
CUDA-core body; at 64 < H ≤ 128 bf16 dots pick
``train_mlp``'s wide tensor-core body (``mlp_pixel_mma_wide``) and K12's
CUDA-core body; past 128 ``train_mlp`` runs ``mlp_pixel_mma_wide`` for
bf16 dots up to its widest (256) and ``mlp_pixel_wide`` for fp32 dots
and past that, up to its widest width; every body the table names is a
``__global__`` kernel of the family's ``.cu`` sources, built for the
blocks per SM that the wrappers launch, and the id ``train_fused.py``
(``train_fused_ff.py``, ``train_fused_ff3.py``) passes for it is the
entry point's enum value; the 3xTF32 bodies' fixed shared memory is the
sum of their layout and, with W1 at the flagship's F, fits one block an
SM and not two. The decode body table
(``decode_body``, by plane mode) likewise: K1/K5 (``decode_v2``) run
``decode_v2_mma`` at every width from 17 to the widest in every plane
mode and their CUDA-core body at H ≤ 16; K3 and K4 their tensor-core
bodies (``decode_v1_mma``, ``mlp_tail_mma``) from 17 to 128; K2
``decode_z1mm_mma`` up to 128; K2, K3 and K4 their wide body past 128. Every body's launcher, train or decode, notes its launch in
the launch log.

The tensor-core bodies take a warp's 16 pixels at a time and zero the
rows past N, and pad k to a multiple of 16. So K7, K9 and K12 are held to
JAX at an N that leaves a warp's 16 rows partly empty (12 and 24 pixels)
and F = 25: the JAX kernels in Pallas interpret mode (``_impl_ng``,
``_impl_ng3``, ``_impl_ff3``), the port's autograd functions and plain
versions on the CPU, on the same numpy-seeded inputs. Tolerances as in
test_torch_train_fused.py: fp32 dots loss rel 1e-6 (1e-5 for K12, as in
test_torch_train_fused_ff3.py), out 1e-5 abs, grads rel 1e-5 (1e-4);
bf16 dot inputs loss rel 1e-4, out 1e-3 abs, grads rel 1e-2 (the two
packages sum in different orders, and a last-bit difference can flip a
bf16 rounding).
"""

import importlib
import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch_threads  # noqa: F401  (one torch thread: tests/torch_threads.py)
from jax.experimental.pallas import tpu as pltpu

from nic.kernels import train_fused as jtf
from nic.kernels import train_fused_ff3 as jff3
from nic_torch.grids.sample import decoder_input
from nic_torch.kernels import _widths
from nic_torch.kernels import train_fused as ttf
from nic_torch.kernels import train_fused_ff as tff
from nic_torch.kernels import train_fused_ff3 as tff3

CSRC = Path(ttf.__file__).resolve().parent / "csrc"
# the sources that define each family's bodies
SOURCES = {"train_ff": ("train_fused_ff.cu",),
           "train_ff3": ("train_fused_ff3.cu",),
           "train_mlp": ("train_fused.cu", "train_fused_mma.cu",
                         "train_fused_mma_wide.cu", "train_fused_wide.cu"),
           "decode_v2": ("decode_fused_v2.cu",),
           "decode_z1mm": ("decode_z1mm.cu",),
           "decode_v1": ("decode_fused.cu",),
           "decode_v3": ("decode_fused_v3.cu",)}
# K3's and K4's bodies: (H <= 16, 17..128, past 128)
TENSOR_CORE_DECODES = {
    "decode_v1": ("decode_fused_v1_kernel", "decode_v1_mma",
                  "decode_v1_wide"),
    "decode_v3": ("mlp_tail_kernel", "mlp_tail_mma", "mlp_tail_wide")}
# the families whose fp32 dots run a 3xTF32 tensor-core body at H = 64
TF32_FAMILIES = ("train_ff", "train_ff3")
MODES = {"fp32-erf": (None, "erf"), "bf16-poly": ("bf16", "poly")}
TOL = {None: dict(loss=1e-6, out=1e-5, grad=1e-5),
       "bf16": dict(loss=1e-4, out=1e-3, grad=1e-2)}
TOL_FF3 = {None: dict(loss=1e-5, out=1e-5, grad=1e-4), "bf16": TOL["bf16"]}
NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")
SEED = np.array([12345, -987654321, 0, 0], np.int32)
C, PE, H = 2, 2, 16


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "fp32"])
@pytest.mark.parametrize("family", sorted(_widths.KERNEL_BODIES))
def test_body_table_picks_tensor_cores_for_bf16_by_width(family, bf16):
    """bf16 dots run a tensor-core body at H ≤ 64 (``*_mma``) and, for
    ``train_mlp``, from 65 up to WIDEST_MMA (``mlp_pixel_mma_wide``); fp32
    dots run K11's and K12's 3xTF32 tensor-core body at H ≤ 64
    (``*_tf32``); train_mlp's fp32 dots, K12's dots past 64 and
    train_mlp's bf16 dots past WIDEST_MMA a CUDA-core body,
    ``mlp_pixel_wide`` past the built widths."""
    top = max(_widths.KERNEL_WIDTHS[family])
    mma_top = _widths.WIDEST_MMA.get(family, 64)
    for hidden in range(1, top + 1):
        body = _widths.kernel_body(family, hidden, bf16)
        assert body in _widths.KERNEL_BODIES[family].values()
        assert body.endswith("_mma") == (bf16 and hidden <= 64), \
            (family, hidden, bf16, body)
        assert body.endswith("_tf32") == (
            not bf16 and hidden <= 64 and family in TF32_FAMILIES), \
            (family, hidden, bf16, body)
        assert (body == "mlp_pixel_mma_wide") == (
            bf16 and 64 < hidden <= mma_top), (family, hidden, bf16, body)
    # past the built widths: the wide tensor-core body for bf16 dots up to
    # its widest, the CUDA-core wide body past it and for fp32 dots, up to
    # the widest, then refused
    widest = _widths.WIDEST.get(family, top)
    edge = [mma_top, mma_top + 1] if family in _widths.WIDEST_MMA else []
    for hidden in list(range(top + 1, widest + 1, 61)) + edge:
        want = ("mlp_pixel_mma_wide" if bf16 and hidden <= mma_top
                else "mlp_pixel_wide")
        assert _widths.kernel_body(family, hidden, bf16) == want, hidden
    with pytest.raises(ValueError):
        _widths.kernel_body(family, widest + 1, bf16)


def test_wide_tensor_core_body_fits_to_its_widest():
    """WIDEST_MMA is the last multiple of 64 whose tile fits in the 227 KB
    of shared memory: wide_mma_smem of csrc/train_fused_mma_wide.cu (z1 and
    z2 fp32, h1b and dz2b bf16 [64][H + 8], two [64][72] bf16 weight tiles,
    5H + 4 + 14·64 floats) at it and 64 past it."""
    def smem(h):
        return 64 * (h + 8) * 12 + 2 * 64 * 72 * 2 + 4 * (5 * h + 4 + 14 * 64)

    cap = 232448
    top = _widths.WIDEST_MMA["train_mlp"]
    assert smem(top) <= cap < smem(top + 64)
    text = (CSRC / "train_fused_mma_wide.cu").read_text()
    assert "2 * sizeof(float) + 2 * sizeof(__nv_bfloat16)" in text
    assert "14 * WR" in text and "constexpr int WR = 64;" in text


# the 3xTF32 bodies' fixed shared memory (bytes) and its pieces: W2 and
# W2^T as hi/lo B tiles [64][36] float4, h1 and dz2 [128][72] fp32, the
# warps' sums [8][260], W3 [64][3], b2, (K11: bvec,) b3 [4] and (K11) the
# PE tables [2][8][64]; then W1 as hi/lo B tiles [64][pad16(F) / 2 + 4]
# float4 where it fits
TF32_SMEM = {
    "train_ff": ("train_fused_ff.cu", "kTf32FixedSmem", 73,
                 2 * 64 * 36 * 16 + 2 * 128 * 72 * 4 + 8 * 260 * 4
                 + 4 * (3 * 64 + 64 + 64 + 4 + 2 * 8 * 64)),
    "train_ff3": ("train_fused_ff3.cu", "kTf32Fixed3Smem", 127,
                  2 * 64 * 36 * 16 + 2 * 128 * 72 * 4 + 8 * 260 * 4
                  + 4 * (3 * 64 + 64 + 4))}


@pytest.mark.parametrize("family", sorted(TF32_SMEM))
def test_tf32_body_fits_one_block_an_sm(family):
    """The source's fixed shared memory of the 3xTF32 body is its layout's
    sum, 16-byte aligned for the W1 tiles after it; with W1 staged at the
    flagship's F it fits the 227 KB a block may hold but two blocks do not
    fit an SM, as BODY_BLOCKS_PER_SM (1) says."""
    src, name, nfeat, fixed = TF32_SMEM[family]
    text = (CSRC / src).read_text()
    assert int(re.search(rf"{name} = (\d+);", text)[1]) == fixed
    assert fixed % 16 == 0
    total = fixed + 64 * (-(-nfeat // 16) * 16 // 2 + 4) * 16
    assert total <= 232448 < 2 * total
    body = _widths.KERNEL_BODIES[family][(64, False)]
    assert _widths.BODY_BLOCKS_PER_SM[body] == 1


def test_train_body_ids_match_the_sources_enum():
    """The id ``train_fused.py`` passes for each train_mlp body is the
    enum value train_fused.cu's dispatch takes for it."""
    text = (CSRC / "train_fused.cu").read_text()
    enum = dict(re.findall(r"(k\w+) = (\d+)",
                           re.search(r"enum Body \{([^}]*)\}", text)[1]))
    names = {"mlp_pixel": "kMlpPixel", "mlp_pixel_mma": "kMlpPixelMma",
             "mlp_pixel_wide": "kMlpPixelWide",
             "mlp_pixel_mma_wide": "kMlpPixelMmaWide"}
    assert set(ttf.BODY_IDS) == set(_widths.KERNEL_BODIES["train_mlp"]
                                    .values()) == set(names)
    for body, i in ttf.BODY_IDS.items():
        assert int(enum[names[body]]) == i, (body, enum)


@pytest.mark.parametrize("family", TF32_FAMILIES)
def test_kernel3_body_ids_match_the_sources_enum(family):
    """The id ``train_fused_ff.py`` (K11) and ``train_fused_ff3.py`` (K12)
    pass for each body of their table is the entry point's enum value:
    kMma for ``*_mma``, kTf32 for ``*_tf32``, kCudaCore for K12's
    ``ff3_pixel``."""
    module = {"train_ff": tff, "train_ff3": tff3}[family]
    assert set(module.BODY_IDS) == set(_widths.KERNEL_BODIES[family]
                                       .values())
    text = (CSRC / SOURCES[family][0]).read_text()
    enum = dict(re.findall(r"(k\w+) = (\d+)",
                           re.search(r"enum Body \{([^}]*)\}", text)[1]))
    for body, i in module.BODY_IDS.items():
        name = ("kMma" if body.endswith("_mma") else
                "kTf32" if body.endswith("_tf32") else "kCudaCore")
        assert int(enum[name]) == i, (family, body, enum)


@pytest.mark.parametrize("mode", _widths.PLANE_MODES)
@pytest.mark.parametrize("family", sorted(_widths.DECODE_BODIES))
def test_decode_body_table(family, mode):
    """K1/K5 on decode_v2_mma at every width from 17 to the widest in
    every plane mode, on their CUDA-core body at H <= 16; K3 and K4 on
    their tensor-core bodies (decode_v1_mma, mlp_tail_mma) from 17 to
    128, their CUDA-core bodies at H <= 16 and their wide bodies past 128
    up to the widest; K2 on decode_z1mm_mma at every width up to 128
    (narrower ones zero-padded to 64) in its three plane modes and its
    wide body past it; a plane mode the family does not take is
    refused."""
    table = _widths.DECODE_BODIES[family]
    modes = {m for _, m in table}
    if mode not in modes:
        with pytest.raises(ValueError):
            _widths.decode_body(family, 64, mode)
        return
    widest = _widths.WIDEST[family]
    for hidden in list(range(1, 321)) + [widest]:
        body = _widths.decode_body(family, hidden, mode)
        if family == "decode_v2":
            assert body == ("decode_fused_v2_kernel" if hidden <= 16
                            else "decode_v2_mma"), (hidden, body)
        elif family in TENSOR_CORE_DECODES:
            core, mma, wide = TENSOR_CORE_DECODES[family]
            assert body == (core if hidden <= 16 else mma if hidden <= 128
                            else wide), (hidden, body)
        else:  # K2: its tensor-core body up to 128, the wide one past it
            assert body == ("decode_z1mm_mma" if hidden <= 128
                            else "decode_z1mm_wide"), (hidden, body)
    with pytest.raises(ValueError, match=str(widest)):
        _widths.decode_body(family, widest + 1, mode)


@pytest.mark.parametrize("family", sorted(_widths.KERNEL_BODIES))
def test_bodies_are_the_sources_kernels(family):
    """Each body is a __global__ kernel of the family's sources, with
    __launch_bounds__(threads, the table's blocks per SM)."""
    text = "".join((CSRC / src).read_text() for src in SOURCES[family])
    bounds = {name: int(blocks) for blocks, name in re.findall(
        r"__global__ void __launch_bounds__\(\w+, (\d)\)\s*\n(\w+)\(",
        text)}
    for body in set(_widths.KERNEL_BODIES[family].values()):
        assert body in bounds, (family, body, sorted(bounds))
        assert bounds[body] == _widths.BODY_BLOCKS_PER_SM[body]


@pytest.mark.parametrize("family", sorted(_widths.DECODE_BODIES))
def test_decode_bodies_are_the_sources_kernels(family):
    """Each decode body is a __global__ kernel of the family's source,
    with its __launch_bounds__."""
    text = "".join((CSRC / src).read_text() for src in SOURCES[family])
    kernels = set(re.findall(
        r"__global__ void __launch_bounds__\([^)]*\)\s*\n(\w+)\(", text))
    for body in set(_widths.DECODE_BODIES[family].values()):
        assert body in kernels, (family, body, sorted(kernels))


# each decode wrapper's body ids (its module and table) and the entry
# point's enum Body in the family's source
BODY_IDS = {"decode_v2": ("decode_fused_v2", "_BODY_IDS"),
            "decode_z1mm": ("decode_fused_v2", "_Z1MM_BODY_IDS"),
            "decode_v1": ("decode_fused", "_BODY_IDS"),
            "decode_v3": ("decode_fused_v3", "_BODY_IDS")}


@pytest.mark.parametrize("family", sorted(_widths.DECODE_BODIES))
def test_decode_body_ids_match_the_sources_enum(family):
    """The id a wrapper passes for each body of ``decode_body``'s table is
    the entry point's enum value for that body: kMma for ``*_mma``,
    kWide for ``*_wide``, kCudaCore for the CUDA-core body; the entry
    point refuses any other pairing of body and width."""
    module, table = BODY_IDS[family]
    ids = getattr(importlib.import_module(f"nic_torch.kernels.{module}"),
                  table)
    assert set(ids) == set(_widths.DECODE_BODIES[family].values())
    text = (CSRC / SOURCES[family][0]).read_text()
    enum = dict(re.findall(r"(k\w+) = (\d+)",
                           re.search(r"enum Body \{([^}]*)\}", text)[1]))
    for body, i in ids.items():
        name = ("kMma" if body.endswith("_mma") else
                "kWide" if body.endswith("_wide") else "kCudaCore")
        assert int(enum[name]) == i, (family, body, enum)


@pytest.mark.parametrize("family", sorted(_widths.KERNEL_BODIES)
                         + sorted(_widths.DECODE_BODIES))
def test_every_body_launch_is_logged(family):
    """Each body's launcher notes the kernel it launched in the launch log
    (csrc/body_log.cu) once the launch succeeded, so a check on the card
    reads which body ran: `auto kern = <body>...;`, then `kern<<<...>>>`,
    then nic_note_body(kern) behind a cudaSuccess test, before the next
    launch."""
    text = "".join((CSRC / src).read_text() for src in SOURCES[family])
    bodies = {**_widths.KERNEL_BODIES, **_widths.DECODE_BODIES}[family]
    for body in set(bodies.values()):
        sites = re.findall(rf"auto kern = {body}<[^;]*;(.*?)(?=auto kern =|\Z)",
                           text, re.S)
        assert sites, (family, body)
        for site in sites:
            launch = site.index("kern<<<")
            note = site.index(
                "== cudaSuccess) nic_note_body(reinterpret_cast<const void*>"
                "(kern));")
            assert launch < site.index("cudaGetLastError()") < note, body
    assert "cudaFuncGetName" in (CSRC / "body_log.cu").read_text()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _mlp(rng, feat, hidden=H):
    dims = (feat, hidden, hidden, 3)
    mlp = {}
    for i in range(3):
        b = 1.0 / np.sqrt(dims[i])
        mlp[f"w{i + 1}"] = rng.uniform(-b, b, dims[i:i + 2]).astype(np.float32)
        mlp[f"b{i + 1}"] = rng.uniform(-b, b, dims[i + 1]).astype(np.float32)
    return mlp


def _setup(seed, nd, n, data, crops, c=C, pe=PE):
    """numpy grids (2D or 3D) at f = 1, MLP, origins, targets and the
    port's gather x of crops of n^nd pixels."""
    rng = np.random.default_rng(seed)
    g0 = rng.uniform(-0.4, 0.5, (c,) + (data + 1,) * nd).astype(np.float32)
    g1 = rng.uniform(-0.4, 0.5, (c,) + (data // 2 + 1,) * nd).astype(
        np.float32)
    feat = (5 if nd == 2 else 9) * c + nd * pe + 1
    mlp = _mlp(rng, feat)
    origins = rng.integers(0, data - n + 1, (crops, nd)).astype(np.int32)
    tgt = rng.uniform(0, 1, (crops * n**nd, 3)).astype(np.float32)
    x = decoder_input((torch.tensor(g0), torch.tensor(g1)), 0,
                      torch.tensor(origins), 1.0, n, pe_channels=pe,
                      mip_level=0, ndim=nd).reshape(crops * n**nd, -1)
    return g0, g1, mlp, origins, tgt, x.numpy()


def _check_ng(nd, mode, seed, n, data, crops, rowsb):
    """K7 (nd 2) or K9 (nd 3) at N = crops n^nd: the port's autograd
    function and plain node planes against JAX's raw kernel outputs
    through JAX's unfold and accumulation."""
    cd, gelu = MODES[mode]
    tol = TOL[cd]
    g0, g1, mlp, origins, tgt, x = _setup(seed, nd, n, data, crops)
    assert x.shape[0] % 16 and x.shape[1] % 16   # a warp partly empty
    jm = {k: jnp.asarray(v) for k, v in mlp.items()}
    jorg = jnp.asarray(origins)
    jd = jnp.bfloat16 if cd else None
    if nd == 2:
        kw = dict(crops=crops, ncols=n, rowsb=rowsb, f=1)
        j_loss, j_out, j_gm, dp, dc1 = jtf._impl_ng(
            jnp.asarray(x), jnp.asarray(tgt), jorg, *(jm[k] for k in NAMES),
            matmul_dtype=jd, gelu=gelu, interpret=True, **kw)
        j_dg0, j_dg1 = jtf._unfold_node_grads(
            dp, dc1, jorg, jm["w1"], g0_nodes=g0.shape[1:],
            g1_nodes=g1.shape[1:], channels=C, **kw)
        planes = jtf._accumulate_node_planes(
            dp, dc1, jorg, g0_nodes=g0.shape[1], g1_nodes=g1.shape[1],
            hidden=H, **kw)
    else:
        kw = dict(crops=crops, n=n, rowsb=rowsb, f=1)
        with pltpu.force_tpu_interpret_mode():
            j_loss, j_out, j_gm, dp, dc1 = jtf._impl_ng3(
                jnp.asarray(x), jnp.asarray(tgt), jorg,
                *(jm[k] for k in NAMES), sparse_g0=False, matmul_dtype=jd,
                gelu=gelu, interpret=True, **kw)
        j_dg0, j_dg1 = jtf._unfold_node_grads_3d(
            dp, dc1, jorg, jm["w1"], sparse_g0=False, g0_nodes=g0.shape[1],
            g1_nodes=g1.shape[1], channels=C, **kw)
        planes = jtf._accumulate_node_volumes(
            dp, dc1, jorg, g0_nodes=g0.shape[1], g1_nodes=g1.shape[1],
            hidden=H, **kw)

    tcd = torch.bfloat16 if cd else None
    tg0 = torch.tensor(g0, requires_grad=True)
    tg1 = torch.tensor(g1, requires_grad=True)
    tm = {k: torch.tensor(v, requires_grad=True) for k, v in mlp.items()}
    args = (tg0, tg1, tm, torch.tensor(x), torch.tensor(tgt),
            torch.tensor(origins), n, 1)
    loss, out = (ttf.fused_mlp_loss_ng(*args, tcd, gelu) if nd == 2 else
                 ttf.fused_mlp_loss_ng3(*args, False, tcd, gelu))
    loss.backward()
    assert abs(float(loss.detach()) - float(j_loss)) / float(j_loss) \
        < tol["loss"]
    assert float(np.abs(out.numpy() - np.asarray(j_out)).max()) < tol["out"]
    assert _rel(tg0.grad, j_dg0) < tol["grad"]
    assert _rel(tg1.grad, j_dg1) < tol["grad"]
    for k in NAMES:
        assert _rel(tm[k].grad, j_gm[k]) < tol["grad"], (k, mode)
    res = ttf.fused_mlp_loss_ng_plain(
        torch.tensor(x), torch.tensor(tgt), torch.tensor(origins),
        *(torch.tensor(mlp[k]) for k in NAMES), n=n, f=1,
        g0_nodes=g0.shape[1], g1_nodes=g1.shape[1], cd=tcd, gelu=gelu)
    for mine, want in zip(res[8:], planes):
        assert mine.shape == want.shape
        assert _rel(mine, np.asarray(want)) < tol["grad"]


@pytest.mark.parametrize("mode", list(MODES))
def test_k7_partial_warp_matches_jax(mode):
    """K7 at 3 crops of 2² (N = 12: one warp, 4 rows empty), F = 25."""
    _check_ng(2, mode, seed=71, n=2, data=16, crops=3, rowsb=2)


@pytest.mark.parametrize("mode", list(MODES))
def test_k9_partial_warp_matches_jax(mode):
    """K9 at 3 crops of 2³ (N = 24: the second warp half empty), F = 25."""
    _check_ng(3, mode, seed=91, n=2, data=8, crops=3, rowsb=2)


@pytest.mark.parametrize("mode", list(MODES))
def test_k12_partial_warp_matches_jax(mode):
    """K12 at 3 crops of 2³ (N = 24), f = 1, F = 25, with feature noise
    in bf16: the port's autograd function against JAX's kernel through its
    unfold, and the plain node volumes against JAX's accumulation."""
    cd, gelu = MODES[mode]
    nbits = 8 if cd else None
    tol = TOL_FF3[cd]
    n, crops, rowsb, f = 2, 3, 2, 1
    g0, g1, mlp, origins, tgt, _ = _setup(121, 3, n, 16, crops)
    jm = {k: jnp.asarray(v) for k, v in mlp.items()}
    jorg = jnp.asarray(origins)
    kw = dict(crops=crops, n=n, rowsb=rowsb, f=f)
    with pltpu.force_tpu_interpret_mode():
        (j_loss, j_out, dw2, db2, dw3, db3, dpe0, dpe1, dpe2, db1, dp, dc1,
         dw1e) = jff3._impl_ff3(
            jnp.asarray(g0), jnp.asarray(g1), *(jm[k] for k in NAMES),
            jnp.asarray(tgt), jorg, jnp.asarray(SEED[:3]), npe=PE, lodf=1.0,
            sparse_g0=False, use_tri_pe=True,
            matmul_dtype=jnp.bfloat16 if cd else None, gelu=gelu,
            interpret=True, nbits=nbits, **kw)
    dg0, dg1, dw1 = jff3._unfold_ff3(
        dp, dc1, jorg, jnp.asarray(g0), jnp.asarray(g1), jm["w1"], db1, dpe0,
        dpe1, dpe2, npe=PE, lodf=1.0, sparse_g0=False, channels=C, **kw)
    if dw1e is not None:
        dw1 = dw1 + dw1e
    vols = jtf._accumulate_node_volumes(
        dp, dc1, jorg, g0_nodes=g0.shape[1], g1_nodes=g1.shape[1], hidden=H,
        **kw)
    want = {"g0": dg0, "g1": dg1, "w1": dw1, "b1": db1, "w2": dw2,
            "b2": db2, "w3": dw3, "b3": db3}

    tcd = torch.bfloat16 if cd else None
    tg0 = torch.tensor(g0, requires_grad=True)
    tg1 = torch.tensor(g1, requires_grad=True)
    tm = {k: torch.tensor(v, requires_grad=True) for k, v in mlp.items()}
    loss, out = tff3.fused_train_ff3(
        tg0, tg1, tm, torch.tensor(tgt), torch.tensor(origins),
        torch.tensor(SEED), n, f, PE, 1.0, False, True, tcd, gelu, nbits)
    loss.backward()
    assert abs(float(loss.detach()) - float(j_loss)) / float(j_loss) \
        < tol["loss"]
    assert float(np.abs(out.numpy() - np.asarray(j_out)).max()) < tol["out"]
    got = {"g0": tg0.grad, "g1": tg1.grad,
           **{k: v.grad for k, v in tm.items()}}
    for k, w in want.items():
        assert _rel(got[k].numpy(), np.asarray(w)) < tol["grad"], (k, mode)
    folded = tff3.fold_volumes(torch.tensor(g0), torch.tensor(g1),
                               torch.tensor(mlp["w1"]), False, tcd)
    res = tff3.fused_train_ff3_plain(
        *folded, *(torch.tensor(mlp[k]) for k in NAMES), torch.tensor(tgt),
        torch.tensor(origins), torch.tensor(SEED), n=n, f=f, npe=PE,
        lodf=1.0, sparse_g0=False, use_tri_pe=True, cd=tcd, gelu=gelu,
        nbits=nbits)
    for mine, w in zip(res[10:12], vols):
        assert mine.shape == np.asarray(w).shape
        assert _rel(mine.numpy(), np.asarray(w)) < tol["grad"]
