#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``nic_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. a CUDA device is present; print ``nvidia-smi`` name and power limit;
2. build every CUDA kernel from ``nic_torch/kernels/csrc`` (the decode
   kernels K1 and K5 (the 3D decode, K1's body with a frame axis), the
   kernel3 train steps K11 (2D) and K12 (3D), and the dx (K6) and
   node-gradient (K7, kernel2; K9 in 3D) train kernels; one nvcc per
   source, all started together) for sm_90a, and print the build time
   and the registers and spills of the tensor-core bodies (``ptxas -v``:
   the train bodies, K1/K5's ``decode_v2_mma`` and K2's
   ``decode_z1mm_mma`` by plane mode, K3's ``decode_v1_mma`` by grid
   dtype and K4's ``mlp_tail_mma`` by accumulator and dot dtype), and
   those of K11's back half (``ff_epsgrad``, ``node_windows``,
   ``node_corners``);
3. each kernel against its plain PyTorch version on the card, on the
   committed trained artifact's column-stage outputs at mips 0-2, for every
   plane mode x GELU; the launch log must name only ``decode_v2_mma``
   (the tensor-core body K1 runs at H = 64 in every plane mode);
4. serve: the decoder-only CLI (``nic_torch.cli.decode.run``) decodes the
   committed artifact at mips 0-9 and is held to the JAX fold's decode
   stored beside it (u8 within 2 LSB, mip-0 PSNR within 0.05 dB); the
   kernel's launch counter must rise by exactly 3 (mips 0, 1, 2 take the
   kernel, thumbnails 3-9 the folded path); then the reduced-precision modes
   at mip 0 against their accuracy envelopes;
5. scale: a flagship-width 2048^2 artifact (C=12, H=64, FP_BITS 8, random
   weights from a seeded torch.Generator) saved and reloaded through the
   artifact format, decoded at mip 0 through the CLI, and the kernel timed
   against its plain version with CUDA events;
6. K11 against its plain version on the card at the flagship shape class
   (C=12, H=64, PE 6, 8 crops of 256², f=4) and at f=2 (128² crops) and
   f=1 (64² crops), random pyramid and MLP from a seeded torch.Generator,
   in fp32·erf and bf16·poly (the tensor-core kernel), each with QAT
   noise off and on: loss, ``out``, every MLP and PE grad and both
   accumulated node planes, two runs bit-identical; K11's back half
   alone (``eps_grad``: ff_epsgrad, eps^T dz1; ``node_windows``: the node
   windows) against its plain versions on each cell's dz1 and on seeded
   dz1 at every crop phase mod 2f, crops·n² not a multiple of 128, F = 73
   and 137 (past the pass of 80) and pixel base 0 and not, max|Δ|/max|plain|
   within EPS_GRAD_TOL and WINDOWS_TOL, two runs bit-identical; then
   kernel vs plain timed at the flagship shape (bf16·poly noise on, the
   path's mode, and fp32·erf), with the device time of the per-pixel
   body, K11's device ms by part (A the body, B the windows, C
   ``ff_rowcol`` + ``ff_pe``, D ``ff_epsgrad``), and the back half alone
   beside its plain versions and, for eps^T dz1, ``torch.matmul`` on a
   materialised eps. In phases 6-8, 16-18 and 26 the second of the two runs of each
   cell is profiled, and the per-pixel body that ran must be the one
   ``nic_torch/kernels/_widths.py`` ``kernel_body`` names: the
   tensor-core body (``ff_pixel_mma``, ``mlp_pixel_mma``,
   ``ff3_pixel_mma``) for bf16 dots at H = 64, the CUDA-core one
   (``ff_pixel``, ``mlp_pixel``, ``ff3_pixel``) for fp32 dots and H = 128;
7. K7 against its plain version on the card at 8 crops of 256² (f=4),
   128² (f=2), 64² (f=1) and 16² (f=1), on the sinusoidal-PE gather of a
   random flagship-width pyramid and MLP, in fp32·erf and bf16·poly: loss,
   ``out``, every MLP grad, and dG0/dG1 after the unfold; two runs must
   be bit-identical; ``node_windows`` alone on each cell's dz1 as in
   phase 6; kernel vs plain timed at 8×256²;
8. K6 likewise at 8×32² (LOD 3), 8×4² (LOD 6), 8×2² (LOD 7) and 8×1²
   (LODs 8, 9; these two fill part of one 128-pixel tile) and 8×256² (the
   TRAIN_FORWARD=kernel shape), with dx among the compared outputs;
9. train: the training CLI (``nic_torch.cli.image_compression.run``) at
   the flagship configuration for 200 epochs (the overrides that made the
   committed fixture). The gate log must name kernel3 in both phases, K11
   must launch exactly 200 times, every loss be finite and the last 20
   lower than the first 20 on average, mip-0 PSNR within 1.0 dB of the
   fixture's JAX run; then the decode CLI decodes the artifact at mips
   0-9 with exactly 3 K1 launches;
10. path A, mip-mode training (TF_NO_MIP=0), 200 epochs: the gate log
    names kernel3 at LODs 0, 1, 2, 4 and kernel at the others it meets;
    K11 and K6 launch as often as the replayed LOD sequence visits those
    LODs (189 and 11 at SEED=0); the decode CLI decodes mips 0-9 with a
    K1 launch for each mip the kernel covers; mip-0 PSNR within 1.0 dB
    of a TRAIN_FORWARD=gather run of the same configuration; then
    TRAIN_FORWARD=kernel2 and kernel against gather from one seed
    (TRAIN_GELU=erf, the GELU gather runs): the same draws, so the
    losses must agree at step 1 to rel 1e-5 and over steps 1-10 to rtol
    2e-3 (the JAX suite's kernel tracking tolerance);
11. path B, sinusoidal-PE training (TF_USE_TRI_PE=0), 200 epochs: kernel2
    in both phases, K7 on every step, mip-0 PSNR and bpp beside a gather
    run's; then kernel2 against gather, as in phase 10;
12. train-step time (CUDA events, median over steps 50-199) for
    kernel3, kernel2 (path B), kernel (TRAIN_FORWARD=kernel) and gather
    (plain autograd), all at LOD 0, with the device operations per step
    counted by ``torch.profiler`` over 5 steps.

The 3D path (methods 3 and 4, the misty 64³ protocol: C=12, H=64, PE 6,
8 crops of 32³):

13. K5 against its plain version on random m3 and m4 mip-mode pyramids
    at 64³, mips 0, 1, 2 and 4, in fp32·exact, bf16·exact, bf16·poly and
    i16·tanherf;
14. the decode CLI on the committed 3D fixture at mips 0-6 against the
    JAX fold (fp32·exact within 2 u8 LSB at every mip, mip-0 PSNR within
    0.05 dB, K5 launched for mips 0, 1, 2, the ``--out`` AVI read back),
    then bf16 (≤ 8 LSB) and i16·tanherf (≤ 6 LSB) at mip 0;
15. a random-weight 256³ m3 artifact decoded through the CLI at mip 0 and
    held to the plain fold; K5 against its plain version timed, and the
    whole decode against ``fast_decode`` (GVox/s, peak memory);
16. K12 against its plain version at 8 crops of 32³ (f=4), 16³ (f=2),
    8³ (f=1) and 8³ at f=4 (slab blocks smaller than a cell in JAX), m3
    with triangular and m4 with sinusoidal PE, noise off and on,
    fp32·erf and bf16·poly (K11's tolerances, two runs bit-identical);
    ``eps_grad`` alone at K12's widths and feature passes (H = 64 in
    passes of 128, H = 128 in passes of 64) as in phase 6;
17. K9 likewise on the 3D gather, with dG0/dG1 after the unfold;
18. K6 at the 3D width F = 127 at 8×4³, 8×2³ and 8×1³ (partial tiles);
19. four 200-epoch 3D CLI runs: m3 flag-free (200 K12 launches, mip-0
    PSNR within 1.0 dB of the fixture's JAX run), m4 flag-free (200 K12),
    m3 mip mode (K12 and K6 as the replayed LOD sequence, K5 at mips 0,
    1, 2, 4) and m3 TRAIN_FORWARD=kernel2 (200 K9), the last three within
    1.0 dB of a gather run; then kernel3 (node noise) and kernel2 (shared
    feature noise) tracking gather from one seed over 10 steps;
20. the 3D LOD-0 step time for kernel3, kernel2, kernel and gather, as
    in phase 12.

The alternate 2D decodes and the XLA alternates (phase 12 also times the
``TRAIN_FORWARD=folded`` step):

21. K3, the v1 decode (``nic_torch.kernels.decode_fused``): the committed
    artifact at mips 0-9 (exactly 10 launches, the launch log naming only
    ``decode_v1_mma``, the tensor-core body ``_widths.decode_body`` names
    at H = 64), against its plain version (the gather decode with the
    kernel's GELU) in fp32 and bf16 and held to the JAX fold (fp32 within
    2 u8 LSB at every mip and 0.05 dB at mip 0, bf16 within 8 LSB); a
    random sinusoidal-PE flagship-width model at mips 0-2; 2048² in fp32
    and bf16 against its plain version, timed, the body by the launch log
    and the profiler;
22. K4, the v3 MLP tail (``nic_torch.kernels.decode_fused_v3``): against
    its plain version on the 2048² random model's first-layer accumulator
    in all four accumulator × dot dtypes (fp32 and bf16 each), timed,
    each call's body (``mlp_tail_mma``) by the launch log and the
    profiler; the v3 decode against ``fast_decode`` on the artifact at
    mips 0-9 (exactly 10 launches, the launch log naming only
    ``mlp_tail_mma``); the whole v3 decode and K1's at 2048², timed with
    their peak memory;
23. K2, the z1-matmul decode (its tensor-core body ``decode_z1mm_mma``
    at H = 64): against its plain version and K1 on the artifact at mips
    0-2 and at 2048², in fp32·exact, bf16·poly and surgical·exact, and
    against its plain version at three contract corners outside JAX's
    gate (R = 8 with f = f1 = 2; R = 32 with f = 4, f1 = 8; R = 512 with
    f = 1, f1 = 512, where bf16 planes split A in two products);
    ``z1_matmul="auto"`` serving mips 0-9 must launch K2 exactly 3 times
    (mips 0-2) and K1 never, within 2 u8 LSB of the JAX fold, and K1
    under int16 planes; the launch log of the serve, of the corners and
    of each 2048² cell, and the profiler of the serve and of each 2048²
    cell, must name only ``decode_z1mm_mma``; K2 timed beside K1;
24. the decode CLI's ``--backend xla`` (the gather decode) at mips 0-9,
    held to the JAX fold as in phase 4;
25. a 200-epoch CLI run with TRAIN_FORWARD=folded, DECODE_BACKEND=xla and
    DIV_SIZE=6 in mip mode (TF_NO_MIP=0, so mips 0-2 decode as 64, 16 and
    4 tiles): no train kernel launches, the gate log names folded at every
    LOD and the tiled gather decode, mip-0 PSNR within 1.0 dB of the
    fixture's JAX run; then folded against gather from one seed (fp32
    dots), as in phase 10, and the mip-0 decode of such a trainer timed
    tiled and whole for the xla and fast backends.

Every hidden and feature width the gates admit (``nic_torch/kernels/
_widths.py``: narrower widths zero-padded to an instantiated one):

26. kernel vs plain (K11's tolerances, two runs bit-identical; the decode
    tolerances): ``node_windows`` alone at H = 192 and 256 (as in phase
    6); K11 at H = 16 and 32 in four modes; K7 and K6 at H = 16,
    128, 192 and 256 (at 128 x in feature chunks, W1 from device memory;
    past 128 ``mlp_pixel_wide``); K12 m3 at PE 8 (F = 133) and F = 205
    (C = 20), and at H = 128 with F = 133, in four modes; K9 at F = 133
    and 205 and at H = 192 and 256; K6 at F = 413 (the tensor-core body's
    two feature chunks), 200 rows; K1, K2, K3, K4 on random 512² models
    and K5 on a 64³ m3 mip-mode model at H = 16, 32, 128, 192 and 256 in
    their plane modes, the 192/256 cells' bodies (``decode_v2_mma`` and
    the wide tails), K1's and K5's at 16 (their CUDA-core body) and K2's,
    K3's and K4's at every width (``decode_z1mm_mma``, ``decode_v1_mma``
    and ``mlp_tail_mma`` from 16 or 32 to 128) by the launch log and the
    profiler; every counter must
    rise; the padding's cost timed (K11 at 8×256² and K1 at 2048² beside
    H = 64), and K1, K3 and K4 at H = 16 on their CUDA-core bodies beside
    the same model padded to 64 onto their tensor-core bodies;
27. the training CLI for 50 epochs at HIDDEN_LAYER_CHANNELS=16 and 32
    under TRAIN_FORWARD=auto: kernel3 in both phases and every step, then
    the decode CLI at mips 0-9; then at HIDDEN_LAYER_CHANNELS=256, where
    kernel3's gate refuses: K7 at every step (exactly 50 launches), the
    decode CLI at mips 0-9 through K1 (exactly 3 launches), every mip
    within 1.0 dB of a TRAIN_FORWARD=gather run of the same
    configuration, and the per-LOD engine log printed; then a 20-epoch
    flagship run with PROFILE_DIR (two chunks of INTERVAL_PRINT=10): the
    trace of the second chunk must be written, named by the log, and
    hold K11's body ``ff_pixel_mma`` among its device kernels.

Rectangular images, the Kodak geometry (IMAGE_SIZE=512, IMAGE_SIZE_W=768,
``data/sancho_512.png`` resized; full width):

28. K11 and K7 against their plain versions on random 512×768 planes at
    8 crops of 256² with crops on the last row and the last column
    (phases 6 and 7's limits, fp32·erf and bf16·poly); the training CLI's
    flagship for 200 epochs (kernel3 in both phases, 200 K11 launches,
    mip-0 PSNR within 1.0 dB of a TRAIN_FORWARD=gather run), its artifact
    through the decode CLI at mips 0-9 (K1 at the mips its gate covers,
    u8 within 2 LSB of the fold ``fast_decode(n=(H, W))``, mip-0 PSNR
    within 0.05 dB of the fold's) and K2 (``z1_matmul=True`` against its
    plain version at mips 0-2 in three plane modes, ``"auto"`` serving
    mips 0-9 with 3 launches, K1 none); path A (TF_NO_MIP=0: K11 and K6 as
    the replayed LOD sequence) and path B (TF_USE_TRI_PE=0: K7 every
    step), 50 epochs each; the portrait 768×512, 50 kernel3 epochs and a
    mip-0 K1 decode against the fold; ``eval_rd --native-geometry`` over
    both orientations; the 512×768 mip-0 decode end to end and K1's
    wrapper (fp32·exact) and the kernel3 step timed.

The scale-hyperprior codec and entropy-coded grids (phase 2 also builds
``hs_bins.cu`` with the rest and ``nic_torch/native/rans.cpp`` with g++,
and prints which format-3 rANS decode path the host takes):

29. K13 (``nic_torch.kernels.hs_bins``, the hyper-synthesis and σ → bin in
    a fixed order of fp32 operations; register-tiled from shared memory
    that tensor copies fill, a thread 4 channels × 1 or 4 pixels) against
    its plain version on this machine's CPU, on seeded ẑ of a random n =
    96, m = 128 model at 8×12 (512×768), the edge tiles 1×1, 3×5 and 8×8
    (480² padded), B = 2 and 32×32 (2048²), of a random model at the
    model's default n = 128, m = 192, on seeded weights of odd widths (n =
    13, m = 20) and past n = 668 (n = 700: 8-column tiles), and on the
    trained model's ẑ of 512×768: every σ bit and every bin equal; the
    trainer at n = 96, m = 128, λ = 0.018, patch 256, batch 8 on
    ``data/*.png`` for 3000 steps (HP_TRAIN_STEPS, so the trained state
    does not move with the host's speed; the mean loss of the last 100
    steps below the first 100's); the codec on sancho
    512², mandrill 480² (padded) and sancho resized to 512×768: the card's
    decompress equal to ``evaluate`` bit for bit, the card's streams
    decoded on the CPU and the CPU's on the card to the same ŷ/ẑ and x̂
    within 1e-5, the coded symbols' bpp (the streams less their fixed
    framing) within 0.5% of the estimate and the real bpp at most that
    plus 457 B of framing, K13 once per compress and once per decompress,
    the bf16 synthesis leaving the streams unchanged; compress, decompress
    and the decode's stage split (rANS, glue, K13, synthesis) timed at
    512×768, and K13 at 512×768 and 2048² beside its bound, its plain
    version and the cuDNN composition it replaces (a reference, not the
    same bits); the flagship 200-epoch CLI run with
    ``ENTROPY_CODE_GRIDS=True``, its artifact through the decode CLI at
    mips 0-2 (3 K1 launches, the launch log naming only ``decode_v2_mma``)
    equal to the same codes saved fixed-length; then one training step on
    the card against the same step on the CPU: from the initial weights
    within the CPU tests' limits (loss rel 1e-5, each leaf's grad
    max|Δ|/max|g| 1e-4, params 1e-6), from the trained state the loss and
    params within them; from both, each device's gradients against the
    same step in float64 on the CPU (the card's worst leaf within 1e-4
    from the initial weights, HP_GRAD64_TOL, and from the trained state
    within 3 × the CPU's own fp32 worst leaf, HP_GRAD64_VS_CPU, and a
    control with TF32 convolutions on the card beyond each limit).

The conv-AE and per-pixel family (image_comp, pixel_comp,
pixel_pos_comp, movie_frame_comp, movie_2d_comp, movie_3d_comp,
movie_lavel_comp in both modes); no kernel of the port's: cuDNN's
convolutions and cuBLAS's products in fp32 with no TF32, deterministic:

30. serve: each committed fixture (``tests/fixtures/convae_*.npz``, made
    by ``scripts/make_torch_convae_fixture.py`` with JAX on a CPU:
    image_comp sancho 512² 4-bit, pixel_comp sancho 512² 8-bit H = 64,
    movie_3d_comp misty 64³ 8-bit) decodes its JAX latent with its JAX
    weights on the card and on the host CPU: fp32 max|Δ| ≤ 1e-5, u8 ≤ 1
    LSB, PSNR within 0.05 dB of the fixture's JAX run; one step of each
    trainer (ConvAE 2D 512², ConvAE 3D 64³, pixel without and with the
    PE at 512², movie-label on misty's 64 frames) in the noise and the
    quantize phase on the card against the same step on the CPU from the
    same state and draws (phase 29's limits; the encoder's quantize-phase
    grads zero), and two card runs from one seed giving the same 20
    losses; the CLIs on the card at full width: the fixture workloads at
    their fixture's flags and epochs within ``CONVAE_BAND_DB`` of the
    fixture's JAX PSNR, the others 200 epochs (a falling loss, the latent's
    shape, dtype and code range, the PNG or AVI read back); then CUDA-event
    times: each trainer's step, the conv-AE encode and decode at 512² and
    64³, the pixel decode at 512².

The mesh (``nic_torch.parallel``), two ranks spawned on the one card
over gloo (NCCL refuses two ranks on one device), against the same work
in this process on one rank:

31. (a) the flagship 512² at full width with TRAIN_FORWARD=kernel3, 8
    crops of 256² (4 a rank): 20 ``kernel3_sharded`` steps, K11 launched
    20 times on each rank and its launch log naming ``ff_pixel_mma``,
    losses against one rank's 20 steps from the same draws (step 1 rel
    1e-5, steps 1-20 rtol 2e-3), the params' digest equal on both ranks;
    (b) the same for the 3D m3 64³ ``kernel3_sharded`` (K12) and the
    path-B 512² ``kernel2_sharded`` (K7), 10 steps each; (c) the sharded
    K1 decode of the 2048² random model and of the 512² fixture at mips
    0-9, and K5 on the 64³ fixture at mips 0-6 and on the 256³ random
    model, each equal bit for bit to one rank's (the fixtures' one-rank
    decodes are held to the JAX fold in phases 4 and 14); (d) one step
    of the hyperprior (phase 29's width), conv-AE 2D 512² and 3D 64³ and
    movie-label trainers against one rank within phase 29's limits. It
    prints the per-rank step ms, the all-reduce ms and each part's wall
    time; two ranks share the card's SMs, so no number is a scaling one.

``--only a,b`` runs the build and the named phases (``PHASES``) and
prints no kernels or result line; the build is skipped when every named
phase is kernel-free (``NO_KERNEL_PHASES``); the driver's run takes no
arguments.

The last line of standard output is one JSON object
``{"ok": true, "device": {...}}``; the line before it the card's name and
power limit, and before that the ``{"kernels": [...]}`` record: for each
kernel its launches on its main path (K1 the serve phase, K11 the
flagship training run, K6 path A, K7 path B, K5 the 3D serve, K12 the m3
flag-free run, K9 the kernel2 run, K2, K3 and K4 their artifact serves of
phases 21-23, K13 the codec's card serves of phase 29), its time and its
plain version's at the path's shape and mode, and its bound, the larger of its
bytes (each input read once, each output written once) over 3.35 TB/s and
its dot operations (the JAX cost model's count) over the published peak
for their type (67 TFLOP/s fp32, 989 TFLOP/s bf16; H100 SXM, 700 W; K1,
K5, K2, K3 and K4 take their fp32 dots as three TF32 tensor-core
products, so theirs count at 495/3 TFLOP/s; K13 issues every fp32
multiply and add as its own instruction, by design (no FMA, for the
bits), so its count at 33.5, half the FMA peak). No single PyTorch call
computes any of these
fused functions (K13's cuDNN composition sums in another order and is
printed as a reference), so ``library_ms`` is null. K1, K5, K7, K11 and
K12 add ``launches_per_rank``: their launches on each rank of phase 31.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

ART = os.path.join(ROOT, "tests", "fixtures", "ntc_sancho512_fp8.npz")
REF = os.path.join(ROOT, "tests", "fixtures", "ntc_sancho512_fp8_ref.npz")
KERNEL_SOURCE = "nic_torch/kernels/csrc/decode_fused_v2.cu"
REPLACES = "nic/kernels/decode_fused_v2.py:369"
K11_SOURCE = "nic_torch/kernels/csrc/train_fused_ff.cu"
K11_REPLACES = "nic/kernels/train_fused_ff.py:568"
# K6, K7 and K9 are timed in bf16·poly, where their body is mlp_pixel_mma
K67_SOURCE = "nic_torch/kernels/csrc/train_fused_mma.cu"
K6_REPLACES = "nic/kernels/train_fused.py:230"
K7_REPLACES = "nic/kernels/train_fused.py:510"
K5_SOURCE = KERNEL_SOURCE
K5_REPLACES = "nic/kernels/decode_fused_3d.py:144"
K12_SOURCE = "nic_torch/kernels/csrc/train_fused_ff3.cu"
K12_REPLACES = "nic/kernels/train_fused_ff3.py:462"
K9_REPLACES = "nic/kernels/train_fused.py:1171"
ART3 = os.path.join(ROOT, "tests", "fixtures", "ntc_misty64_m3_fp8.npz")
REF3 = os.path.join(ROOT, "tests", "fixtures", "ntc_misty64_m3_fp8_ref.npz")
CLIP = os.path.join(ROOT, "data", "misty_64_64.avi")
K3_SOURCE = "nic_torch/kernels/csrc/decode_fused.cu"
K3_REPLACES = "nic/kernels/decode_fused.py:258"
K4_SOURCE = "nic_torch/kernels/csrc/decode_fused_v3.cu"
K4_REPLACES = "nic/kernels/decode_fused_v3.py:75"
K2_SOURCE = "nic_torch/kernels/csrc/decode_z1mm.cu"
K2_REPLACES = "nic/kernels/decode_fused_v2.py:191"
# published H100 SXM peaks at 700 W: memory bytes/s and dot FLOP/s by type
PEAK_BYTES = 3.35e12
# (tf32x3: fp32 dots as three TF32 tensor-core products each, 495 TFLOP/s
# of TF32 over the three, as decode_v2_mma, decode_z1mm_mma, decode_v1_mma
# and mlp_tail_mma run K1/K5's, K2's, K3's and K4's fp32 dots)
# fp32_nofma: a kernel that issues every multiply and add as its own
# instruction (no contraction, as K13 by design) reaches half the FMA peak
PEAK_FLOPS = {"fp32": 67e12, "fp32_nofma": 67e12 / 2, "bf16": 989e12,
              "tf32x3": 495e12 / 3}

# kernel vs plain tolerances on the [0, 1] output. fp32 planes and dots:
# only the summation order, FMA contraction and the libm of exp/tanh
# differ, so the JAX suite's 2e-5 holds. With bf16 dot inputs (bf16, i16,
# surgical), a last-bit fp32 difference in a GELU output can flip its bf16
# rounding (2^-9 relative), moving an output by up to |W|·|h|·2^-9: a few
# 1e-4 at H = 64; 2e-3 bounds that and is half an 8-bit step.
TOL = {"fp32": 2e-5, "bf16": 2e-3, "i16": 2e-3, "surgical": 2e-3}
# the u8 envelopes of the reduced modes against the JAX fold (ROADMAP.md)
ENVELOPE = {"bf16": ("exact", 8), "i16": ("tanherf", 3),
            "surgical": ("exact", 2)}
LSB_FP32, PSNR_DB = 2, 0.05  # main path: u8 LSB at every mip, mip-0 PSNR
# K11 vs plain, the JAX suite's tolerances for its fused train paths
# (tests/test_train_kernel.py): fp32 dots loss rel 1e-5, out 1e-5 abs,
# grads rel 1e-4; bf16 dot inputs loss rel 1e-4, out 1e-3 abs, grads rel
# 1e-2 (a last-bit difference can flip a bf16 rounding of a dot input)
K11_TOL = {"fp32": dict(loss=1e-5, out=1e-5, grad=1e-4),
           "bf16": dict(loss=1e-4, out=1e-3, grad=1e-2)}
K11_MODES = {"fp32·erf": ("fp32", "erf"), "bf16·poly": ("bf16", "poly")}
# training: the overrides of scripts/make_torch_port_fixture.py, whose JAX
# run the fixture's psnr[0] records; crop, noise and GELU streams differ
# by design, so the band is statistical
TRAIN_ARGS = ["NUM_EPOCHS=200", "SDC_GUARD_TRAIN=False"]
TRAIN_PSNR_DB = 1.0
PATH_A = TRAIN_ARGS + ["TF_NO_MIP=0"]        # mip-mode training
PATH_B = TRAIN_ARGS + ["TF_USE_TRI_PE=0"]    # sinusoidal-PE training
# the engine JAX's gates pick at each flagship LOD in mip mode (kernel3's
# gate refuses the step-2 LODs and LODs 6 and 8, kernel2's too)
KERNEL3_LODS = (0, 1, 2, 4)
# the 3D protocol (BASELINE.md §1.5): misty 64³, 8 crops of 32³; method 3
# unless a run says otherwise
MISTY = TRAIN_ARGS + ["IMAGE_PATH=data/misty_64_64.avi", "IMAGE_DIMENSION=3",
                      "COMPRESSION_METHOD=3", "IMAGE_SIZE=64",
                      "MAX_MIP_LEVEL=6", "CROP_MIP_LEVEL=5"]
# in 3D mip mode JAX's gates run kernel3 at LODs 0-2 and the dx kernel at
# 3-6 (the lattice gate, and at LOD 4 ff3_geometry)
KERNEL3_LODS_3D = (0, 1, 2)
# the 3D decode's envelopes at mip 0 against the JAX fold (BASELINE.md:94,
# :276-277); fp32·exact is held to LSB_FP32 at every mip
ENVELOPE_3D = {"bf16": ("exact", 8), "i16": ("tanherf", 6)}
# kernel2/kernel vs gather from one seed: the first step exactly (only the
# summation order differs), steps 1-10 at the JAX suite's rtol
TRACK_STEPS, TRACK_FIRST, TRACK_RTOL = 10, 1e-5, 2e-3
# the folded forward with the tiled gather decode: mip mode, so that
# 2^(9 − mip − 6) > 1 tiles mips 0-2
FOLDED = PATH_A + ["TRAIN_FORWARD=folded", "DECODE_BACKEND=xla",
                   "DIV_SIZE=6"]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-ups."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, flops: float, dtype: str) -> tuple:
    """(least ms, "bytes" | "operations") on the card at its published
    peaks."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def u8(x):
    import numpy as np

    return np.floor(np.clip(x, 0, 1) * 255.0 + 0.5).astype(np.int64)


# the tensor-core bodies whose registers and spills phase 2 reports
MMA_BODIES = ("ff_pixel_mma", "mlp_pixel_mma", "ff3_pixel_mma")
# K1/K5's tensor-core body, by (plane mode, H = 64 with h1 in registers or
# wider with h1 in slots); phase 2 reports its exact-erf and tanherf GELUs
DECODE_MMA = "decode_v2_mma"
# K2's tensor-core body, keyed like K1's (fp32, bf16 and surgical planes)
Z1MM_MMA = "decode_z1mm_mma"
PLANE_IDS = ("fp32", "bf16", "i16", "surgical")
# K3's and K4's tensor-core bodies, by (grid or accumulator dtype[, dot
# dtype], H = 64 with h1 in registers or 128 with h1 in slots)
V1_MMA, V3_MMA = "decode_v1_mma", "mlp_tail_mma"
_DTYPE_IDS = {"f": "fp32", "13__nv_bfloat16": "bf16"}


def ptxas_usage(log: str) -> dict:
    """{(body, gelu): (registers, spill stores, spill loads, stack bytes)}
    from the ``ptxas -v`` lines of an nvcc log, for the template kernels
    MMA_BODIES (their one template argument: the GELU, 0 erf, 1 poly),
    DECODE_MMA and Z1MM_MMA (keyed (body, (plane mode, gelu id, H = 64))),
    V1_MMA
    ((V1_MMA, (grid dtype, H = 64))) and V3_MMA ((V3_MMA, (accumulator
    dtype, dot dtype, H = 64)))."""
    import re

    out, cur, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            hit = [(b, int(g)) for b in MMA_BODIES for g in re.findall(
                rf"\d{b}ILi(\d)E", m.group(1))]
            hit += [(b, (PLANE_IDS[int(md)], int(g), one == "1"))
                    for b in (DECODE_MMA, Z1MM_MMA)
                    for md, g, one in re.findall(
                        rf"\d{b}ILi(\d)ELi(\d)ELb([01])E", m.group(1))]
            hit += [(V1_MMA, (_DTYPE_IDS[t], one == "1"))
                    for t, one in re.findall(
                        rf"\d{V1_MMA}I(f|13__nv_bfloat16)Lb([01])E",
                        m.group(1))]
            hit += [(V3_MMA, (_DTYPE_IDS[t], "bf16" if bf == "1" else "fp32",
                              one == "1"))
                    for t, bf, one in re.findall(
                        rf"\d{V3_MMA}I(f|13__nv_bfloat16)Lb([01])ELb([01])E",
                        m.group(1))]
            cur, props = (hit[0] if hit else None), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            props = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur and props:
            out[cur] = (int(m.group(1)), props[1], props[2], props[0])
            cur = None
    return out


def _rest_registers(log: str) -> dict:
    """{kernel<template args>: (registers, spill stores, spill loads)} of
    ff_epsgrad, node_windows and node_corners from the ``ptxas -v`` lines
    of an nvcc log."""
    import re

    out, cur, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d(ff_epsgrad|"
                      r"node_windows|node_corners)(\S*)'", line)
        if m:
            args = re.findall(r"L[ib](\d+)E", m.group(2))
            cur = m.group(1) + (f"<{','.join(args)}>" if args else "")
            spills = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)), *spills)
            cur = None
    return out


def phase_build() -> float:
    from nic_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    wall = time.perf_counter() - t0
    secs = _build.build_seconds if _build.build_seconds is not None else wall
    print(f"phase 2: kernels built in {secs:.1f} s "
          f"(nvcc, sm_90a; load {wall:.1f} s); per source: "
          + (", ".join(f"{name} {sec:.1f} s" for name, sec in
                       sorted(_build.source_seconds.items(),
                              key=lambda kv: -kv[1]))
             or "already built"), flush=True)
    from nic_torch import native

    t1 = time.perf_counter()
    native.load()
    print(f"phase 2: rANS coder (nic_torch/native/rans.cpp, g++) loaded in "
          f"{time.perf_counter() - t1:.1f} s; format-3 decode path: "
          f"{native.decode_path()}", flush=True)
    usage = ptxas_usage(_build.log_path().read_text())
    bodies = MMA_BODIES + (DECODE_MMA, Z1MM_MMA, V1_MMA, V3_MMA)
    if {b for b, _ in usage} != set(bodies):
        fail(f"ptxas reported {sorted(usage)}, not every one of {bodies} "
             f"(nvcc log {_build.log_path()})")
    rest = _rest_registers(_build.log_path().read_text())
    print("phase 2: the back half of K11 (ptxas -v; ff_epsgrad<H,bf16,pass>)"
          ": " + ", ".join(f"{k} {r} registers, {ss}/{sl} B spill "
                           "stores/loads"
                           for k, (r, ss, sl) in sorted(rest.items())),
          flush=True)
    train = {k: v for k, v in usage.items() if k[0] in MMA_BODIES}
    print("phase 2: tensor-core bodies (ptxas -v): " + "; ".join(
        f"{b}<{'poly' if g else 'erf'}> {r} registers, {ss} B spill stores, "
        f"{sl} B spill loads, {st} B stack"
        for (b, g), (r, ss, sl, st) in sorted(train.items())), flush=True)
    for body, past in ((DECODE_MMA, "wider"), (Z1MM_MMA, "H = 128")):
        dec = {k[1]: v for k, v in usage.items() if k[0] == body}
        print(f"phase 2: {body} (ptxas -v), by plane mode, GELU exact / "
              f"tanherf, H = 64 (h1 in registers) / {past} (slots): "
              + "; ".join(
                  f"{md}·{'exact' if g == 0 else 'tanherf'}·"
                  f"{'H64' if one else past.replace(' = ', '')} {r} "
                  f"registers, {ss}/{sl} B spill stores/loads, {st} B stack"
                  for (md, g, one), (r, ss, sl, st) in sorted(dec.items())
                  if g in (0, 5)), flush=True)
    for body in (V1_MMA, V3_MMA):
        print(f"phase 2: {body} (ptxas -v), by "
              + ("grid dtype" if body == V1_MMA
                 else "accumulator and dot dtype")
              + ", H = 64 (h1 in registers) / 128 (slots): " + "; ".join(
                  "·".join(key[:-1]) + f"·{'H64' if key[-1] else 'H128'} "
                  f"{r} registers, {ss}/{sl} B spill stores/loads, {st} B "
                  "stack" for (b, key), (r, ss, sl, st) in sorted(
                      usage.items()) if b == body), flush=True)
    return secs


def phase_parity(device) -> float:
    """Kernel vs plain on the fixture's column-stage outputs; returns the
    worst fp32·exact error."""
    import torch

    from nic_torch.grids.pyramid import pyramid_mip_levels
    from nic_torch.io.artifacts import load_compressed
    from nic_torch.kernels import decode_fused_v2 as k

    from nic_torch.kernels._build import body_launches, clear_body_launches

    mlp, fp, meta = load_compressed(ART, device=device)
    m2l = pyramid_mip_levels(512, fp[0].shape[1] - 1, True)
    worst = {m: 0.0 for m in TOL}
    main_err = 0.0
    clear_body_launches()
    with torch.inference_mode():
        for mip in (0, 1, 2):
            for mode, dtype in (("fp32", None), ("bf16", torch.bfloat16),
                                ("i16", "i16"), ("surgical", "surgical")):
                pc, c1v, pe_u, w2, b2, w3, b3, s, geom = k._prepare_2d(
                    fp, mlp, mip, image_size=512, mip_to_level=m2l,
                    pe_channels=6, use_tri_pe=True, dtype=dtype)
                for gelu in k.GELUS:
                    kw = dict(f=geom["f"], f1=geom["f1"], gelu=gelu)
                    got = k.decode_kernel_2d(pc, c1v, pe_u, w2, b2, w3, b3,
                                             s, **kw)
                    torch.cuda.synchronize(device)
                    want = k.decode_kernel_2d_plain(pc, c1v, pe_u, w2, b2,
                                                    w3, b3, s, **kw)
                    if (got.shape != want.shape
                            or not torch.isfinite(got).all()):
                        fail(f"kernel output at mip {mip} {mode} {gelu}: "
                             f"shape {tuple(got.shape)} or non-finite")
                    err = float((got - want).abs().max())
                    worst[mode] = max(worst[mode], err)
                    if mode == "fp32" and gelu == "exact":
                        main_err = max(main_err, err)
                    if err > TOL[mode]:
                        fail(f"kernel vs plain at mip {mip} {mode}·{gelu}: "
                             f"max|Δ| {err:.3e} > {TOL[mode]:.0e}")
    logged = body_launches()
    if _bodies_named(logged) != {"decode_v2_mma"}:
        fail(f"phase 3: the launch log names {sorted(_bodies_named(logged))}"
             " at H = 64, want decode_v2_mma in every plane mode")
    print("phase 3: kernel vs plain, mips 0-2 x 6 GELUs, worst max|Δ| per "
          "plane mode: " + ", ".join(f"{m} {e:.3e} (tol {TOL[m]:.0e})"
                                     for m, e in worst.items())
          + f"; body launches {sum(logged.values())}, all decode_v2_mma",
          flush=True)
    return main_err


def phase_serve(device) -> int:
    """The CLI on the fixture at mips 0-9; returns the kernel launches."""
    import numpy as np
    import torch

    from nic_torch.cli.decode import run
    from nic_torch.core.metrics import psnr
    from nic_torch.kernels.decode_fused_v2 import decode_kernel_2d

    ref = dict(np.load(REF))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        decode_kernel_2d.launches = 0
        recs = [run([ART, "--mip", str(mip), "--device", device]
                    + (["--out", os.path.join(tmp, "mip0.png")]
                       if mip == 0 else []))
                for mip in range(10)]
        launches = decode_kernel_2d.launches
        if not os.path.getsize(os.path.join(tmp, "mip0.png")):
            fail("the CLI wrote an empty PNG")
    lsb = []
    for mip, rec in enumerate(recs):
        want = ref[f"dec{mip}"].astype(np.int64)
        if rec.shape != want.shape or not np.isfinite(rec).all():
            fail(f"mip {mip}: shape {rec.shape} (want {want.shape}) or "
                 f"non-finite values")
        lsb.append(int(np.abs(u8(rec) - want).max()))
    p0 = float(psnr(torch.from_numpy(ref["orig0"]).double(),
                    torch.from_numpy(u8(recs[0])).double()))
    print(f"phase 4: fp32·exact u8 LSB vs the JAX fold, mips 0-9: {lsb}; "
          f"mip-0 PSNR {p0:.4f} dB (JAX fold {ref['psnr'][0]:.4f}); "
          f"kernel launches {launches}", flush=True)
    if max(lsb) > LSB_FP32:
        fail(f"u8 difference {max(lsb)} LSB > {LSB_FP32}")
    if abs(p0 - float(ref["psnr"][0])) > PSNR_DB:
        fail(f"mip-0 PSNR {p0:.4f} is not within {PSNR_DB} dB of "
             f"{float(ref['psnr'][0]):.4f}")
    if launches != 3:
        fail(f"the decode kernel launched {launches} times over mips 0-9; "
             f"expected 3 (mips 0, 1, 2)")
    for mode, (gelu, bar) in ENVELOPE.items():
        rec = run([ART, "--mip", "0", "--device", device, "--dtype", mode,
                   "--gelu", gelu])
        d = int(np.abs(u8(rec) - ref["dec0"].astype(np.int64)).max())
        print(f"phase 4: --dtype {mode} --gelu {gelu}: {d} LSB at mip 0 "
              f"(envelope {bar})", flush=True)
        if d > bar:
            fail(f"--dtype {mode} --gelu {gelu}: {d} LSB > {bar}")
    return launches


def _timings(fp, mlp, size, m2l, device, label) -> dict:
    """Kernel vs plain at mip 0 of a ``size``² model, per plane mode."""
    import torch

    from nic_torch.grids.fastdecode import fast_decode
    from nic_torch.kernels import decode_fused_v2 as k

    out = {}
    npix = size * size
    kw = dict(image_size=size, mip_to_level=m2l, pe_channels=6)
    with torch.inference_mode():
        for mode, dtype in (("fp32", None), ("bf16", torch.bfloat16),
                            ("i16", "i16"), ("surgical", "surgical")):
            pc, c1v, pe_u, w2, b2, w3, b3, s, geom = k._prepare_2d(
                fp, mlp, 0, use_tri_pe=True, dtype=dtype, **kw)
            args = (pc, c1v, pe_u, w2, b2, w3, b3, s)
            hidden = w2.shape[0]
            work = (nbytes(*args) + npix * 3 * 4,
                    2 * npix * (hidden * hidden + 3 * hidden))
            for gelu in (k.GELUS if mode == "fp32" else ("exact",)):
                g = dict(f=geom["f"], f1=geom["f1"], gelu=gelu)
                ms = cuda_ms(lambda: k.decode_kernel_2d(*args, **g))
                plain = cuda_ms(lambda: k.decode_kernel_2d_plain(*args, **g))
                out[(mode, gelu)] = (ms, plain, work)
                print(f"phase 5: {label} kernel {mode}·{gelu}: {ms:.4f} ms "
                      f"({npix / ms / 1e6:.3f} GPix/s) vs plain "
                      f"{plain:.4f} ms ({npix / plain / 1e6:.3f} GPix/s)",
                      flush=True)
        for name, fn in (
                ("decode_image_fused_v2 (column stage + kernel)",
                 lambda: k.decode_image_fused_v2(fp, mlp, 0, **kw)),
                ("fast_decode (plain fold)",
                 lambda: fast_decode(fp, mlp, 0, **kw))):
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            ms = cuda_ms(fn)
            peak = (torch.cuda.max_memory_allocated(device) - base) / 2**20
            out[name] = ms
            print(f"phase 5: {label} end to end, {name}: {ms:.4f} ms "
                  f"({npix / ms / 1e6:.3f} GPix/s), peak {peak:.0f} MiB "
                  f"above the model", flush=True)
    return out


def phase_scale(device, size: int = 2048) -> dict:
    import numpy as np
    import torch

    from nic_torch.cli.decode import run
    from nic_torch.grids.fastdecode import fast_decode
    from nic_torch.grids.pyramid import (create_pyramid, pyramid_mip_levels,
                                         pyramid_quantize_all)
    from nic_torch.io.artifacts import load_compressed, save_compressed
    from nic_torch.models.mlp import init_mlp

    base, bits = size // 4, 8
    gen = torch.Generator(device="cpu").manual_seed(size)
    fp, _ = create_pyramid(gen, base, 12, bits, device=device, no_mip=True)
    fp = pyramid_quantize_all(fp, bits)
    mlp = init_mlp(gen, 12 * 5 + 2 * 6 + 1, 64, 3, device=device)
    meta = {"save_name": f"chip_smoke_{size}", "config": {
        "image_size": size, "image_size_w": 0, "pe_channels": 6,
        "tf_use_tri_pe": True, "tf_no_mip": True, "compression_method": 1,
        "image_dimension": 2}}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, f"flagship_{size}.npz")
        save_compressed(path, mlp, fp, bits, meta)
        rec = run([path, "--mip", "0", "--device", device])
        mlp, fp, _ = load_compressed(path, device=device)
    m2l = pyramid_mip_levels(size, base, True)
    with torch.inference_mode():
        want = fast_decode(fp, mlp, 0, image_size=size, mip_to_level=m2l,
                           pe_channels=6).cpu().numpy()
    err = float(np.abs(rec - np.clip(want, 0, 1)).max())
    print(f"phase 5: {size}² CLI decode {rec.shape}, max|Δ| vs the plain fold "
          f"{err:.3e} (tol {TOL['fp32']:.0e})", flush=True)
    if rec.shape != (size, size, 3) or not np.isfinite(rec).all():
        fail(f"{size}² decode: shape {rec.shape} or non-finite values")
    if err > TOL["fp32"]:
        fail(f"{size}² decode differs from the plain fold by {err:.3e}")
    timings = _timings(fp, mlp, size, m2l, device, f"{size}²")
    mlp512, fp512, _ = load_compressed(ART, device=device)
    timings512 = _timings(fp512, mlp512, 512,
                          pyramid_mip_levels(512, 128, True), device, "512²")
    return {size: timings, 512: timings512}


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / (b.double().abs().max() + 1e-12))


def _compare(tag, names, got, want, tol) -> dict:
    """Per-output errors of a kernel against its plain version (out:
    max|Δ|; the rest: max|Δ|/max|want|), outputs the plain version leaves
    None skipped; fails past ``tol``."""
    import torch

    errs = {}
    for name, a, b in zip(names, got, want):
        if b is None:
            continue
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"{tag}: {name} shape {tuple(a.shape)} (want "
                 f"{tuple(b.shape)}) or non-finite values")
        errs[name] = (float((a - b).abs().max()) if name == "out"
                      else _rel(a, b))
    bad = [nm for nm, e in errs.items()
           if e > tol["loss" if nm == "loss" else
                      "out" if nm == "out" else "grad"]]
    if bad:
        fail(f"{tag}: " + ", ".join(f"{nm} {errs[nm]:.3e}" for nm in bad))
    return errs


def _traced(fn, reps: int = 1, cpu: bool = False):
    """torch.profiler over ``reps`` calls of ``fn`` after one warm-up call
    that the profiler runs but does not record (its schedule's warm-up
    step: the card's trace starts late otherwise, and a call's first
    kernels go missing) → (the profile, the last call's result)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            got = fn()
        torch.cuda.synchronize()
        prof.step()
    return prof, got


def device_ms(fn, reps: int = 20) -> tuple:
    """Device time per call of ``fn`` by torch.profiler over ``reps``
    calls, after a warm-up: (the sum over its CUDA kernels, {kernel name:
    ms per call})."""
    import torch

    prof, _ = _traced(fn, reps)
    per = {a.key: a.self_device_time_total / reps / 1e3
           for a in prof.key_averages()
           if a.device_type == torch.autograd.DeviceType.CUDA}
    return sum(per.values()), per


def _is_body(body: str, name: str) -> bool:
    """Is the kernel ``name`` (demangled or mangled) the template body
    ``body``? ``mlp_pixel`` is not ``mlp_pixel_mma``."""
    import re

    return re.search(rf"(?<![A-Za-z0-9_]){body}(?=[<(])|\d{body}I",
                     name) is not None


def _body_ms(per: dict, body: str) -> float:
    """The device ms per call of ``body`` in a :func:`device_ms` table."""
    return sum(t for name, t in per.items() if _is_body(body, name))


# per phase: the cells whose per-pixel body the profiler confirmed, by
# body; the cells whose traces named no body (tag, CUDA kernels in the
# last trace); and the bodies the phase's cells want. The launch log
# (``_build.body_launches``) checks every cell; the card's profiler now
# and then returns a trace that lacks the first kernels of its recorded
# window (all of a call of a few microseconds) or holds no kernel, so a
# trace records BODY_REPS calls, a cell is traced up to BODY_TRIES times,
# and a phase fails if a body it wants is confirmed by the profiler in
# none of its cells
BODY_CELLS: dict = {}
BODY_LOST: list = []
BODY_WANTED: set = set()
BODY_TRIES = 5
BODY_REPS = 3


def _bodies_named(names) -> set:
    """The per-pixel bodies of any family (train or decode) that the kernel
    ``names`` hold."""
    from nic_torch.kernels._widths import DECODE_BODIES, KERNEL_BODIES

    return {b for fam in (*KERNEL_BODIES.values(), *DECODE_BODIES.values())
            for b in fam.values() if any(_is_body(b, nm) for nm in names)}


def _want_body(family: str, hidden: int, cd: str) -> str:
    """The body ``nic_torch/kernels/_widths.py`` names: ``kernel_body`` for
    a train family (``cd`` "fp32" or "bf16"), ``decode_body`` for a decode
    family (``cd`` the plane mode)."""
    from nic_torch.kernels._widths import decode_body, kernel_body

    if family.startswith("decode"):
        return decode_body(family, hidden, cd)
    return kernel_body(family, hidden, cd == "bf16")


def _check_body(tag, fn, family: str, hidden: int, cd: str):
    """Calls of ``fn`` under torch.profiler (:func:`_traced`): of all the
    per-pixel bodies exactly the one ``_widths`` names for (family, hidden,
    cd) must run (:func:`_want_body`), by the names in the kernels' launch
    log and by those in the trace. Another body in either fails at once; a
    trace with no body is taken again, up to BODY_TRIES times, then the
    cell is counted as lost to the profiler (:func:`_body_summary`
    judges). Returns the last call's result."""
    import torch

    from nic_torch.kernels._build import body_launches, clear_body_launches

    want = _want_body(family, hidden, cd)
    BODY_WANTED.add(want)
    clear_body_launches()
    for _ in range(BODY_TRIES):
        prof, got = _traced(fn, BODY_REPS, cpu=True)
        names = [a.key for a in prof.key_averages()
                 if a.device_type == torch.autograd.DeviceType.CUDA]
        ran = _bodies_named(names)
        if ran:
            break
    logged = body_launches()
    if _bodies_named(logged) != {want}:
        fail(f"{tag}: the launch log names the bodies "
             f"{sorted(_bodies_named(logged))}, want {want} (log: "
             f"{ {nm[:60]: c for nm, c in logged.items()} })")
    if not ran:
        BODY_LOST.append((tag, len(names)))
    elif ran != {want}:
        fail(f"{tag}: the profiler saw the bodies {sorted(ran)} run, want "
             f"{want} (kernels: {sorted(nm[:60] for nm in names)})")
    else:
        BODY_CELLS[want] = BODY_CELLS.get(want, 0) + 1
    return got


def _device_line(phase: int, tag: str, fn, family: str, hidden: int,
                 cd: str) -> None:
    """Print the device time per call of ``fn`` (torch.profiler) and its
    per-pixel body's share."""
    body = _want_body(family, hidden, cd)
    total, per = device_ms(fn)
    print(f"phase {phase}: {tag}: device {total:.4f} ms per call, of it "
          f"{body} {_body_ms(per, body):.4f} ms", flush=True)


def _body_summary(phase: int) -> None:
    """Print and reset the bodies the profiler confirmed in a phase (the
    launch log has checked every cell); fail if a wanted body was confirmed
    by the profiler in no cell."""
    cells = sum(BODY_CELLS.values()) + len(BODY_LOST)
    print(f"phase {phase}: per-pixel bodies confirmed by the launch log in "
          f"all {cells} cells and by torch.profiler in "
          + ", ".join(f"{b} {c}" for b, c in sorted(BODY_CELLS.items()))
          + f"; {len(BODY_LOST)} of {cells} cells' traces held no body"
          + "".join(f"; {tag} ({n} kernels in the last trace)"
                    for tag, n in BODY_LOST), flush=True)
    unseen = BODY_WANTED - set(BODY_CELLS)
    if unseen:
        fail(f"phase {phase}: torch.profiler confirmed {sorted(unseen)} in "
             f"no cell ({len(BODY_LOST)} of {cells} cells' traces held no "
             "body)")
    BODY_CELLS.clear()
    BODY_LOST.clear()
    BODY_WANTED.clear()


def _run_twice(tag, fn, body):
    """``fn()`` twice on the card: the results must be bit-identical (every
    reduction runs in a fixed order). ``body`` (family, hidden, cd): the
    second call runs under :func:`_check_body`."""
    import torch

    got = fn()
    again = _check_body(tag, fn, *body)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)
               if a is not None):
        fail(f"{tag}: two runs differ (the reductions must be in a fixed "
             "order)")
    return got


def _k11_inputs(gen, device, n, f, crops=8, size=512, hidden=64):
    """Random flagship-width pyramid and MLP (torch.Generator; another
    hidden width if given), folded, with crops of n² on the LOD image of
    size·f/4."""
    import torch

    from nic_torch.grids.pyramid import create_pyramid
    from nic_torch.kernels.train_fused_ff import fold_planes
    from nic_torch.models.mlp import init_mlp

    fp, _ = create_pyramid(gen, size // 4, 12, 8, device=device, no_mip=True)
    mlp = init_mlp(gen, 12 * 5 + 2 * 6 + 1, hidden, 3, device=device)
    img = size * f // 4
    origins = torch.randint(0, img - n + 1, (crops, 2), generator=gen)
    tgt = torch.rand(crops * n * n, 3, generator=gen).to(device)
    words = torch.randint(-2**31, 2**31, (2,), generator=gen)
    seed = torch.cat([words, torch.zeros(2, dtype=torch.int64)]).to(
        torch.int32)
    planes = {cd: fold_planes(fp[0], fp[1], mlp["w1"],
                              None if cd == "fp32" else torch.bfloat16)
              for cd in ("fp32", "bf16")}
    weights = [mlp[k].detach() for k in ("w1", "b1", "w2", "b2", "w3", "b3")]
    return planes, weights, tgt, origins, seed


def _k11_call(inputs, n, f, cd, gelu, nbits) -> tuple:
    """(args, kwargs) of ``fused_train_ff_kernel`` on ``_k11_inputs``'s
    ``inputs`` in the mode (cd, gelu, nbits)."""
    import torch

    planes, weights, tgt, origins, seed = inputs
    return ((*planes[cd], *weights, tgt, origins, seed),
            dict(n=n, f=f, npe=6, lodf=0.0, gelu=gelu,
                 cd=None if cd == "fp32" else torch.bfloat16, nbits=nbits))


# the back half of K11 alone (phases 6, 7, 16, 26): ff_epsgrad (eps^T dz1,
# K11 and K12) and node_windows (K11 and K7) against their plain versions,
# max|Δ|/max|plain|: eps^T dz1 within the JAX suite's fp32 grad limit, the
# windows (fp32 sums of the same terms in another order) within 1e-5; two
# runs of each bit-identical
EPS_GRAD_TOL = 1e-4
WINDOWS_TOL = 1e-5
REST_WORDS = (12345, -987654321)  # the alone checks' noise stream words
# K11's kernels by part: A the per-pixel body, B the node windows, C the
# row/column sums and PE grads, D eps^T dz1
K11_PARTS = {"A": ("ff_pixel_mma", "ff_pixel"),
             "B": ("node_windows", "node_corners"),
             "C": ("ff_rowcol", "ff_pe"), "D": ("ff_epsgrad",)}


def _parts_ms(fn, parts: dict) -> dict:
    """{part: device ms per call of its kernels ``parts[part]``} of
    ``fn`` by :func:`device_ms`, whose trace is taken again, up to
    BODY_TRIES times, while it holds none of them (the card's profiler
    now and then returns a trace without the call's kernels)."""
    for _ in range(BODY_TRIES):
        per = device_ms(fn)[1]
        got = {p: sum(_body_ms(per, nm) for nm in names)
               for p, names in parts.items()}
        if any(got.values()):
            break
    return got


def _phase_origins(gen, crops, n, f, span):
    """Origins [crops, 2] of n² crops inside ``span`` pixels, at every
    phase mod 2f on both axes (crop i at phase i mod 2f in rows, the
    columns' phases shuffled)."""
    import torch

    f1 = 2 * f
    ph = torch.arange(crops) % f1
    cells = (span - n - f1) // f1 + 1
    rows = f1 * torch.randint(0, cells, (crops,), generator=gen) + ph
    cols = (f1 * torch.randint(0, cells, (crops,), generator=gen)
            + ph[torch.randperm(crops, generator=gen)])
    return torch.stack([rows, cols], dim=1)


def _seeded_dz1(seed, npix, hidden, device):
    """A dz1-sized [npix, hidden] fp32 tensor of N(0, 1e-12), seeded."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(npix, hidden, generator=gen, device=device) * 1e-6


def _twice(tag, fn) -> tuple:
    """``fn()`` twice on the card: the results must be bit-identical."""
    import torch

    got, again = fn(), fn()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{tag}: two runs differ (the sums must be in a fixed order)")
    return got


def _eps_kw(nfeat, base, bf16) -> dict:
    return dict(nfeat=nfeat, fslot=-(-nfeat // 8) * 8, s0=REST_WORDS[0],
                s1=REST_WORDS[1], nbits=8, pixel_base=base, bf16=bf16)


def _eps_grad_alone(tag, dz1, nfeat, base, bf16, feat_pass) -> float:
    """ff_epsgrad alone (``eps_grad``) against ``eps_grad_plain`` on
    ``dz1``: max|Δ|/max|plain|; fails past EPS_GRAD_TOL or if two runs
    differ."""
    from nic_torch.kernels import train_fused_ff as k

    kw = _eps_kw(nfeat, base, bf16)
    (got,) = _twice(tag, lambda: (k.eps_grad(dz1, feat_pass=feat_pass,
                                             **kw),))
    err = _rel(got, k.eps_grad_plain(dz1, **kw))
    if err > EPS_GRAD_TOL:
        fail(f"{tag}: ff_epsgrad vs plain max|Δ|/max|plain| {err:.3e} > "
             f"{EPS_GRAD_TOL:.0e}")
    return err


def _windows_alone(tag, dz1, origins, n, f) -> float:
    """node_windows alone against ``node_windows_plain`` on ``dz1``: the
    worst of the two windows' max|Δ|/max|plain|; fails past WINDOWS_TOL or
    if two runs differ."""
    from nic_torch.kernels import train_fused as t

    got = _twice(tag, lambda: t.node_windows(dz1, origins, n, f))
    want = t.node_windows_plain(dz1, origins, n, f)
    err = max(_rel(a, b) for a, b in zip(got, want))
    if err > WINDOWS_TOL:
        fail(f"{tag}: node_windows vs plain max|Δ|/max|plain| {err:.3e} > "
             f"{WINDOWS_TOL:.0e}")
    return err


def _rest_alone(phase, device, hidden, lattices, eps_cases) -> None:
    """ff_epsgrad and node_windows alone on seeded dz1 of 8 crops of n²
    per (n, f) of ``lattices``, origins at every phase mod 2f (the windows
    only where H is a multiple of 64); eps^T dz1 for each (F, feature pass)
    of ``eps_cases`` at pixel base 0 and 123457, in bf16 and fp32 dots."""
    import torch

    gen = torch.Generator().manual_seed(1000 * phase + hidden)
    worst_e = worst_w = 0.0
    cells = 0
    for n, f in lattices:
        dz1 = _seeded_dz1(cells + hidden, 8 * n * n, hidden, device)
        cell = f"H={hidden} 8×{n}² f={f}"
        origins = _phase_origins(gen, 8, n, f, 4 * n)
        worst_w = max(worst_w, _windows_alone(f"node_windows {cell}", dz1,
                                              origins, n, f))
        cells += 1
        for nfeat, feat_pass in eps_cases:
            for base in (0, 123457):
                for bf16 in (True, False):
                    worst_e = max(worst_e, _eps_grad_alone(
                        f"ff_epsgrad {cell} F={nfeat} base={base} "
                        f"{'bf16' if bf16 else 'fp32'}", dz1, nfeat, base,
                        bf16, feat_pass))
                    cells += 1
    print(f"phase {phase}: back half alone at H={hidden}, {cells} cells "
          f"(n, f) {list(lattices)}, every phase mod 2f, crops·n² not a "
          f"multiple of 128: node_windows worst max|Δ|/max|plain| "
          f"{worst_w:.2e} (tol {WINDOWS_TOL:.0e})"
          + (f", ff_epsgrad (F, pass) {list(eps_cases)} worst {worst_e:.2e}"
             f" (tol {EPS_GRAD_TOL:.0e})" if eps_cases else "")
          + "; reruns bit-identical", flush=True)


def _k11_rest_times(k, dz1, origins, n, f, nfeat, k11) -> dict:
    """At the flagship: K11's parts A-D by device ms (``k11``: the K11
    call), then ff_epsgrad and node_windows alone
    on the step's dz1: wrapper ms, device ms, plain ms, bound, and for
    eps^T dz1 the library's product (cuBLAS, bf16 in, fp32 sums) on a
    materialised eps. Returns {kernel: (device ms, wrapper ms, plain ms,
    library ms or None, (bytes, FLOPs))}."""
    import torch

    from nic_torch.kernels import train_fused as t

    npix, hid = dz1.shape
    rows0, cols0, rows1, cols1 = t._window_extents(n, f)
    windows = 4 * hid * origins.shape[0] * (rows0 * cols0 + rows1 * cols1)
    parts = _parts_ms(k11, K11_PARTS)
    print("phase 6: K11 8×256² bf16·poly noise=on device ms by part: "
          + ", ".join(f"{p} {'+'.join(K11_PARTS[p])} {ms:.4f}"
                      for p, ms in parts.items()), flush=True)
    kw = _eps_kw(nfeat, 0, True)
    eps = k.eps_uniform(torch.arange(npix, device=dz1.device)[:, None]
                        * kw["fslot"] + torch.arange(nfeat,
                                                     device=dz1.device),
                        kw["s0"], kw["s1"], kw["nbits"]).to(torch.bfloat16)
    dzb = dz1.to(torch.bfloat16)
    out = {}
    sms = torch.cuda.get_device_properties(dz1.device).multi_processor_count
    for name, fn, plain, lib, body, work, dt in (
            ("ff_epsgrad", lambda: k.eps_grad(dz1, **kw),
             lambda: k.eps_grad_plain(dz1, **kw),
             lambda: torch.matmul(eps.t(), dzb), ("ff_epsgrad",),
             (nbytes(dz1) + 4 * nfeat * hid, 2 * npix * nfeat * hid),
             "bf16"),
            ("node_windows", lambda: t.node_windows(dz1, origins, n, f),
             lambda: t.node_windows_plain(dz1, origins, n, f), None,
             ("node_windows", "node_corners"),
             (nbytes(dz1, origins) + windows, 4 * npix * hid), "fp32")):
        ms = cuda_ms(fn, reps=20)
        dev = _parts_ms(fn, {name: body})[name]
        pl = cuda_ms(plain, reps=5)
        lib_ms = cuda_ms(lib, reps=20) if lib else None
        b_ms, b_by = bound(*work, dt)
        out[name] = (dev, ms, pl, lib_ms, work)
        print(f"phase 6: {name} alone on the 8×256² step's dz1: device "
              f"{dev:.4f} ms ({'+'.join(body)}), wrapper {ms:.4f} ms, plain "
              f"{pl:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
              + (f", library torch.matmul(eps_bf16.t(), dz1_bf16) "
                 f"{lib_ms:.4f} ms" if lib else "")
              + (f"; {min(-(-npix // 128), 2 * sms)} blocks"
                 if name == "ff_epsgrad" else ""), flush=True)
    return out


def phase_k11(device) -> dict:
    """K11 vs plain at f = 4, 2, 1 in 4 modes, its back half alone (on
    each cell's dz1 and on seeded dz1 at every crop phase); timings at the
    flagship."""
    import torch

    from nic_torch.kernels import train_fused_ff as k

    names = ("loss", "out", "dw2", "db2", "dw3", "db3", "dpe0", "dpe1",
             "db1", "P_acc", "C1_acc", "dw1e")
    gen = torch.Generator(device="cpu").manual_seed(11)
    timings = {}
    out_err = 0.0
    rest_times = None
    with torch.no_grad():  # the plain version takes autograd inside
        for n, f in ((256, 4), (128, 2), (64, 1)):
            inputs = _k11_inputs(gen, device, n, f)
            _, weights, tgt, origins, _ = inputs
            for label, (cd, gelu) in K11_MODES.items():
                tol = K11_TOL[cd]
                for nbits in (None, 8):
                    args, kw = _k11_call(inputs, n, f, cd, gelu, nbits)
                    cell = f"f={f} {label} noise={'on' if nbits else 'off'}"
                    got = _run_twice(f"K11 {cell}", lambda: (
                        k.fused_train_ff_kernel(*args, **kw)),
                        ("train_ff", 64, cd))
                    *want, dz1 = k.fused_train_ff_plain(*args, **kw,
                                                        with_dz1=True)
                    errs = _compare(f"K11 vs plain {cell}", names, got, want,
                                    tol)
                    # the back half alone on this cell's dz1
                    rest = (_windows_alone(f"node_windows {cell}", dz1,
                                           origins, n, f),
                            _eps_grad_alone(
                                f"ff_epsgrad {cell}", dz1,
                                weights[0].shape[0], 0, cd == "bf16", 80)
                            if nbits else 0.0)
                    worst_grad = max(e for nm, e in errs.items()
                                     if nm not in ("loss", "out"))
                    print(f"phase 6: K11 vs plain {cell}: loss rel "
                          f"{errs['loss']:.2e}, out max|Δ| {errs['out']:.2e},"
                          f" worst grad/plane rel {worst_grad:.2e} "
                          f"(tol {tol['loss']:.0e}/{tol['out']:.0e}/"
                          f"{tol['grad']:.0e}); alone on its dz1: "
                          f"node_windows {rest[0]:.2e}"
                          + (f", ff_epsgrad {rest[1]:.2e}" if nbits else ""),
                          flush=True)
                    if n == 256 and cd == "bf16" and nbits:
                        out_err = errs["out"]
                    if n == 256 and ((cd, nbits) in (("bf16", 8),
                                                     ("fp32", None))):
                        ms = cuda_ms(lambda: k.fused_train_ff_kernel(*args,
                                                                     **kw))
                        plain = cuda_ms(lambda: k.fused_train_ff_plain(
                            *args, **kw))
                        # dots: z2, z3 and their backward (6·N·(H² + 3H)),
                        # with noise ε·W1 and εᵀ·dz1 (4·N·F·H)
                        npix, hid, feat = tgt.shape[0], 64, weights[0].shape[0]
                        flops = 6 * npix * (hid * hid + 3 * hid) + (
                            4 * npix * feat * hid if nbits else 0)
                        work = (nbytes(*args[:9], origins) + nbytes(*got),
                                flops)
                        timings[cell] = (ms, plain, work)
                        # the per-pixel kernel alone (ff_pixel or
                        # ff_pixel_mma): planes, weights, targets read;
                        # out, dz1 and the block partials written; z2, dh1,
                        # dW2 (6·N·H²), the 64 → 3 layer and its two
                        # products (18·N·H) and ε·W1 (2·N·F·H)
                        nblk = min(-(-npix // 128), 264)
                        px_bytes = (nbytes(*args[:9], origins)
                                    + 4 * npix * (3 + hid) + 4 * nblk
                                    * (4 + 4 * hid + hid * hid))
                        px_flops = 6 * npix * hid * hid + 18 * npix * hid \
                            + (2 * npix * feat * hid if nbits else 0)
                        px_ms, px_by = bound(px_bytes, px_flops, cd)
                        print(f"phase 6: K11 {cell} at 8×256²: kernel "
                              f"{ms:.4f} ms vs plain {plain:.4f} ms; bound "
                              f"{bound(*work, cd)[0]:.4f} ms; the per-pixel "
                              f"kernel alone {px_ms:.4f} ms ({px_by})",
                              flush=True)
                        _device_line(6, f"K11 {cell} at 8×256²", lambda: (
                            k.fused_train_ff_kernel(*args, **kw)),
                            "train_ff", 64, cd)
                        if nbits:
                            rest_times = _k11_rest_times(
                                k, dz1, origins, n, f, feat,
                                lambda: k.fused_train_ff_kernel(*args, **kw))
    _rest_alone(6, device, 64, ((255, 4), (127, 2), (63, 1)),
                ((73, 80), (137, 80)))
    _body_summary(6)
    return {"timings": timings, "out_err": out_err, "rest": rest_times}


def _csv_losses(root: str):
    import csv
    import glob

    (path,) = glob.glob(os.path.join(root, "log", "*_scalars.csv"))
    with open(path) as fh:
        rows = [r for r in csv.DictReader(fh)
                if r["tag"] == "Loss/train_epoch_label"]
    return [float(r["value"]) for r in sorted(rows,
                                              key=lambda r: int(r["step"]))]


def phase_train(device) -> int:
    """The training CLI at the flagship configuration; returns K11's
    launches in that run."""
    import numpy as np

    ref = dict(np.load(REF))
    run = _cli_train(TRAIN_ARGS)
    res, losses, launches = run["res"], run["losses"], run["launches"]
    print(f"phase 9: training CLI, 200 epochs in {run['wall']:.1f} s of wall "
          f"time; gates: {run['gates']}; launches {launches}; loss first "
          f"{losses[0]:.5f} last {losses[-1]:.5f}; mip-0 PSNR "
          f"{res['psnr'][0]:.4f} dB (fixture's JAX run "
          f"{float(ref['psnr'][0]):.4f}), bpp {res['bpp']:.4f}; decode CLI "
          f"mips 0-9 shapes {[r.shape[0] for r in run['recs']]}, K1 launches "
          f"{run['k1']}", flush=True)
    if run["engine"] != {(0, False): "kernel3", (0, True): "kernel3"}:
        fail(f"the gate log does not name kernel3 in both phases: "
             f"{run['gates']}")
    if launches != {"K11": 200, "K6": 0, "K7": 0, "K12": 0, "K9": 0}:
        fail(f"launches {launches} in 200 epochs; want K11 200")
    if len(losses) != 200 or not np.isfinite(losses).all():
        fail(f"{len(losses)} losses, finite: {np.isfinite(losses).all()}")
    if not np.mean(losses[-20:]) < np.mean(losses[:20]):
        fail("the loss did not fall: mean of the last 20 "
             f"{np.mean(losses[-20:]):.5f} vs first 20 "
             f"{np.mean(losses[:20]):.5f}")
    if abs(res["psnr"][0] - float(ref["psnr"][0])) > TRAIN_PSNR_DB:
        fail(f"mip-0 PSNR {res['psnr'][0]:.4f} dB is not within "
             f"{TRAIN_PSNR_DB} dB of {float(ref['psnr'][0]):.4f}")
    _check_decodes("flagship", run, no_mip=True)
    return launches["K11"]


NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


def _gather_inputs(gen, device, n, step, tri_pe, crops=8, size=512,
                   hidden=64):
    """Random flagship-width no-mip pyramid (G0 [12,129,129]) and MLP
    (torch.Generator; another hidden width if given), and the gather of
    crops of n² at ``step`` on G0: (fp, weights, x [crops·n², 73], tgt,
    origins)."""
    import torch

    from nic_torch.grids.pyramid import create_pyramid
    from nic_torch.grids.sample import decoder_input
    from nic_torch.models.mlp import init_mlp

    fp, _ = create_pyramid(gen, size // 4, 12, 8, device=device, no_mip=True)
    mlp = init_mlp(gen, 12 * 5 + 2 * 6 + 1, hidden, 3, device=device)
    img = int(round((size // 4) / step))   # pixels G0 spans at this step
    origins = torch.randint(0, img - n + 1, (crops, 2), generator=gen)
    x = decoder_input(fp, 0, origins.to(device), step, n, pe_channels=6,
                      mip_level=0, use_tri_pe=tri_pe).reshape(crops * n * n,
                                                              -1)
    tgt = torch.rand(crops * n * n, 3, generator=gen).to(device)
    weights = [mlp[k].detach() for k in NAMES]
    return fp, weights, x.contiguous(), tgt, origins


def _fused_work(x, tgt, weights, got, origins=None, with_dx=True) -> tuple:
    """(bytes, dot FLOPs) of one K6/K7 call: inputs read once, outputs
    written once; 6·N·(F·H + H·H + 3H), the JAX cost model, less the
    2·N·F·H of dx = dz1·W1ᵀ for K7 (``with_dx`` False), which forms none."""
    npix, feat = x.shape
    hid = weights[2].shape[0]
    return (nbytes(x, tgt, origins, *weights) + nbytes(*got),
            (6 if with_dx else 4) * npix * feat * hid
            + 6 * npix * (hid * hid + 3 * hid))


def phase_k7(device) -> dict:
    """K7 vs plain at 8 crops of 256², 128², 64², 16²; timings at 8×256²."""
    import torch

    from nic_torch.kernels import train_fused as k

    names = ("loss", "out", "dw1", "db1", "dw2", "db2", "dw3", "db3", "dG0",
             "dG1")
    gen = torch.Generator(device="cpu").manual_seed(7)
    timings = {}
    with torch.no_grad():  # the plain version takes autograd inside
        for n, f in ((256, 4), (128, 2), (64, 1), (16, 1)):
            fp, weights, x, tgt, origins = _gather_inputs(gen, device, n,
                                                          1.0 / f, False)
            geo = dict(g0_nodes=tuple(fp[0].shape[1:]),
                       g1_nodes=tuple(fp[1].shape[1:]))

            def unfolded(res):
                dg = k._unfold_node_grads(res[8], res[9], weights[0],
                                          channels=12, **geo)
                return tuple(res[:8]) + dg

            for label, (cd, gelu) in K11_MODES.items():
                kw = dict(n=n, f=f, gelu=gelu,
                          cd=None if cd == "fp32" else torch.bfloat16, **geo)
                args = (x, tgt, origins, *weights)
                cell = f"8×{n}² f={f} {label}"
                got = _run_twice(f"K7 {cell}", lambda: (
                    k.fused_mlp_loss_ng_kernel(*args, **kw)),
                    ("train_mlp", 64, cd))
                want = k.fused_mlp_loss_ng_plain(*args, **kw)
                tol = K11_TOL[cd]
                errs = _compare(f"K7 vs plain {cell}", names, unfolded(got),
                                unfolded(want), tol)
                # node_windows alone on the plain step's dz1
                dz1 = k._plain_step(x, tgt, weights, kw["cd"], gelu,
                                    with_dx=False)[2]
                werr = _windows_alone(f"node_windows K7 {cell}", dz1,
                                      origins, n, f)
                print(f"phase 7: K7 vs plain {cell}: loss rel "
                      f"{errs['loss']:.2e}, out max|Δ| {errs['out']:.2e}, "
                      f"MLP grads rel ≤ "
                      f"{max(errs[m] for m in names[2:8]):.2e}, dG0 "
                      f"{errs['dG0']:.2e}, dG1 {errs['dG1']:.2e} (tol "
                      f"{tol['loss']:.0e}/{tol['out']:.0e}/"
                      f"{tol['grad']:.0e}); node_windows alone on its dz1 "
                      f"{werr:.2e} (tol {WINDOWS_TOL:.0e})", flush=True)
                if n == 256:
                    ms = cuda_ms(lambda: k.fused_mlp_loss_ng_kernel(*args,
                                                                    **kw))
                    plain = cuda_ms(lambda: k.fused_mlp_loss_ng_plain(*args,
                                                                      **kw))
                    work = _fused_work(x, tgt, weights, got, origins,
                                       with_dx=False)
                    timings[label] = (ms, plain, work, errs["out"])
                    b_ms, b_by = bound(*work, cd)
                    print(f"phase 7: K7 {cell}: kernel {ms:.4f} ms vs plain "
                          f"{plain:.4f} ms; bound {b_ms:.4f} ms ({b_by})",
                          flush=True)
                    _device_line(7, f"K7 {cell}", lambda: (
                        k.fused_mlp_loss_ng_kernel(*args, **kw)),
                        "train_mlp", 64, cd)
                    win_ms = _parts_ms(lambda: k.node_windows(
                        dz1, origins, n, f), K11_PARTS)["B"]
                    print(f"phase 7: node_windows alone on the K7 {cell} "
                          f"dz1: device {win_ms:.4f} ms (node_windows+"
                          "node_corners)", flush=True)
    _body_summary(7)
    return timings


def phase_k6(device) -> dict:
    """K6 vs plain at 8 crops of 32² (LOD 3), 4² (LOD 6), 2² (LOD 7) and
    1² (LODs 8, 9), the last two partial 128-pixel tiles, and 256²;
    timings at 8×32² (path A's largest) and 8×256²."""
    import torch

    from nic_torch.kernels import train_fused as k

    names = ("loss", "out", "dx", "dw1", "db1", "dw2", "db2", "dw3", "db3")
    gen = torch.Generator(device="cpu").manual_seed(6)
    timings = {}
    with torch.no_grad():
        for n, step in ((32, 2.0), (4, 1.0), (2, 2.0), (1, 1.0),
                        (256, 0.25)):
            _, weights, x, tgt, origins = _gather_inputs(gen, device, n, step,
                                                         True)
            for label, (cd, gelu) in K11_MODES.items():
                kw = dict(gelu=gelu,
                          cd=None if cd == "fp32" else torch.bfloat16)
                cell = f"8×{n}² {label}"
                got = _run_twice(f"K6 {cell}", lambda: (
                    k.fused_mlp_loss_kernel(x, tgt, *weights, **kw)),
                    ("train_mlp", 64, cd))
                want = k.fused_mlp_loss_plain(x, tgt, *weights, **kw)
                tol = K11_TOL[cd]
                errs = _compare(f"K6 vs plain {cell}", names, got, want, tol)
                print(f"phase 8: K6 vs plain {cell}: loss rel "
                      f"{errs['loss']:.2e}, out max|Δ| {errs['out']:.2e}, "
                      f"dx rel {errs['dx']:.2e}, MLP grads rel ≤ "
                      f"{max(errs[m] for m in names[3:]):.2e}", flush=True)
                if n in (32, 256):
                    ms = cuda_ms(lambda: k.fused_mlp_loss_kernel(x, tgt,
                                                                 *weights,
                                                                 **kw))
                    plain = cuda_ms(lambda: k.fused_mlp_loss_plain(
                        x, tgt, *weights, **kw))
                    work = _fused_work(x, tgt, weights, got)
                    timings[(n, label)] = (ms, plain, work, errs["out"])
                    b_ms, b_by = bound(*work, cd)
                    print(f"phase 8: K6 {cell}: kernel {ms:.4f} ms vs plain "
                          f"{plain:.4f} ms; bound {b_ms:.4f} ms ({b_by})",
                          flush=True)
                    _device_line(8, f"K6 {cell}", lambda: (
                        k.fused_mlp_loss_kernel(x, tgt, *weights, **kw)),
                        "train_mlp", 64, cd)
    _body_summary(8)
    return timings


def _train_counters() -> dict:
    from nic_torch.kernels.train_fused import (fused_mlp_loss_kernel,
                                               fused_mlp_loss_ng3_kernel,
                                               fused_mlp_loss_ng_kernel)
    from nic_torch.kernels.train_fused_ff import fused_train_ff_kernel
    from nic_torch.kernels.train_fused_ff3 import fused_train_ff3_kernel

    return {"K11": fused_train_ff_kernel, "K6": fused_mlp_loss_kernel,
            "K7": fused_mlp_loss_ng_kernel, "K12": fused_train_ff3_kernel,
            "K9": fused_mlp_loss_ng3_kernel}


def _cli_train(args, decode: bool = True, mips=range(10), keep=None) -> dict:
    """The training CLI in a fresh output root, every train kernel's
    counter set to 0 just before it and read just after; then (``decode``)
    the decode CLI at ``mips`` with K1's and K5's counters likewise; then
    ``keep(run)``, whose result goes to ``run["kept"]``, while the run's
    files are still there."""
    import glob
    import re

    from nic_torch.cli import decode as dcli
    from nic_torch.cli import image_compression as tcli
    from nic_torch.kernels.decode_fused_3d import decode_kernel_3d
    from nic_torch.kernels.decode_fused_v2 import decode_kernel_2d

    counters = _train_counters()
    run = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        run["res"] = tcli.run(args + [f"OUTPUT_ROOT={tmp}"])
        run["wall"] = time.perf_counter() - t0
        run["launches"] = {k: c.launches for k, c in counters.items()}
        run["losses"] = _csv_losses(tmp)
        (printlog,) = glob.glob(os.path.join(tmp, "printlog", "*.txt"))
        with open(printlog) as fh:
            lines = [ln.strip() for ln in fh]
        run["gates"] = [ln for ln in lines if "train forward gate" in ln]
        run["decode_gates"] = [ln for ln in lines
                               if "decode backend gate" in ln]
        run["trace_lines"] = [ln for ln in lines
                              if "torch.profiler trace" in ln]
        run["engine"] = {}
        for ln in run["gates"]:
            m = re.search(r"lod=(\d+), frozen=(\w+)\): (\w+)", ln)
            run["engine"][(int(m[1]), m[2] == "True")] = m[3]
        if decode:
            decode_kernel_2d.launches = decode_kernel_3d.launches = 0
            run["recs"] = [dcli.run([run["res"]["artifact"], "--mip",
                                     str(mip)]) for mip in mips]
            run["k1"] = decode_kernel_2d.launches
            run["k5"] = decode_kernel_3d.launches
        if keep is not None:
            run["kept"] = keep(run)
    return run


def _check_decodes(tag, run, no_mip: bool) -> int:
    """Every mip decoded at its size; K1 launched once per mip it covers.
    Returns that count."""
    import numpy as np

    from nic_torch.grids.pyramid import pyramid_mip_levels
    from nic_torch.kernels.decode_fused_v2 import kernel_covers_2d

    m2l = pyramid_mip_levels(512, 128, no_mip)
    covered = sum(kernel_covers_2d(mip, 512, m2l, 64) for mip in range(10))
    for mip, rec in enumerate(run["recs"]):
        if rec.shape != (512 >> mip, 512 >> mip, 3) or \
                not np.isfinite(rec).all():
            fail(f"{tag}: decode at mip {mip}: shape {rec.shape} or "
                 "non-finite")
    if run["k1"] != covered:
        fail(f"{tag}: the decode CLI launched K1 {run['k1']} times over "
             f"mips 0-9; the kernel covers {covered}")
    return covered


def _lod_sequence(args) -> list:
    """The LODs a run of ``args`` draws, replayed from the trainer's
    stream (numpy default_rng(SEED + 1) and the uniform gate)."""
    import numpy as np

    from nic_torch.config import parse_overrides
    from nic_torch.train.ntc import UniformLodSchedule, sample_lod

    cfg = parse_overrides(args)
    rng = np.random.default_rng(cfg.seed + 1)
    gate = UniformLodSchedule(cfg.uniform_distribution_rate)
    return [sample_lod(rng, gate(), cfg.effective_max_mip_level)
            for _ in range(cfg.num_epochs)]


def _track(tag, args, forward) -> tuple:
    """``forward`` and gather from one seed (TRAIN_GELU=erf, the GELU the
    gather path runs) see the same LODs, origins and noise: their losses
    must agree at step 1 and track over TRACK_STEPS steps."""
    import numpy as np

    from nic_torch.cli.image_compression import load_asset
    from nic_torch.config import parse_overrides
    from nic_torch.train.ntc import NTCTrainer

    losses, engines = {}, {}
    for fwd in (forward, "gather"):
        cfg = parse_overrides(args + [f"TRAIN_FORWARD={fwd}",
                                      "TRAIN_GELU=erf"])
        tr = NTCTrainer(cfg, load_asset(cfg))
        losses[fwd] = np.asarray(tr.train_many(TRACK_STEPS)[0], np.float64)
        engines[fwd] = sorted({p.mode for p in tr._plans.values()})
    a, b = losses[forward], losses["gather"]
    first = abs(a[0] - b[0]) / abs(b[0])
    worst = float(np.max(np.abs(a - b) / np.abs(b)))
    print(f"{tag}: TRAIN_FORWARD={forward} (engines {engines[forward]}) vs "
          f"gather, {TRACK_STEPS} steps from one seed: step-1 loss rel "
          f"{first:.2e} (tol {TRACK_FIRST:.0e}), worst step rel {worst:.2e} "
          f"(rtol {TRACK_RTOL:.0e}); losses {a[0]:.6f} → {a[-1]:.6f}",
          flush=True)
    if not (first <= TRACK_FIRST and worst <= TRACK_RTOL):
        fail(f"{tag}: TRAIN_FORWARD={forward} does not track gather")
    return first, worst


def phase_path_a(device) -> int:
    """Mip-mode training; returns K6's launches in the auto run."""
    import numpy as np

    run = _cli_train(PATH_A)
    gather = _cli_train(PATH_A + ["TRAIN_FORWARD=gather"], decode=False)
    lods = _lod_sequence(PATH_A)
    want = {lod: "kernel3" if lod in KERNEL3_LODS else "kernel"
            for lod in set(lods)}
    want_k11 = sum(want[lod] == "kernel3" for lod in lods)
    want_k6 = len(lods) - want_k11
    got = run["launches"]
    drawn = {int(v): int(c) for v, c in zip(*np.unique(lods,
                                                      return_counts=True))}
    p0, g0 = run["res"]["psnr"][0], gather["res"]["psnr"][0]
    print(f"phase 10: path A (TF_NO_MIP=0), 200 epochs in {run['wall']:.1f} s"
          f" of wall time; LODs drawn {drawn}; "
          f"gates {sorted(run['engine'].items())}; launches {got} "
          f"(want K11 {want_k11}, K6 {want_k6}); loss {run['losses'][0]:.5f}"
          f" → {run['losses'][-1]:.5f}; mip-0 PSNR {p0:.4f} dB vs gather "
          f"{g0:.4f} dB ({gather['wall']:.1f} s); bpp {run['res']['bpp']:.4f}",
          flush=True)
    for (lod, _), engine in run["engine"].items():
        if engine != want[lod]:
            fail(f"path A: LOD {lod} ran {engine}, JAX runs {want[lod]}")
    if got != {"K11": want_k11, "K6": want_k6, "K7": 0, "K12": 0, "K9": 0}:
        fail(f"path A: launches {got}, want K11 {want_k11}, K6 {want_k6}")
    if len(run["losses"]) != 200 or not np.isfinite(run["losses"]).all():
        fail("path A: the losses are not 200 finite values")
    if abs(p0 - g0) > TRAIN_PSNR_DB:
        fail(f"path A: mip-0 PSNR {p0:.4f} dB is not within "
             f"{TRAIN_PSNR_DB} dB of the gather run's {g0:.4f}")
    covered = _check_decodes("path A", run, no_mip=False)
    print(f"phase 10: path A decode CLI mips 0-9: shapes "
          f"{[r.shape[0] for r in run['recs']]}, K1 launches {run['k1']} "
          f"(the mips it covers: {covered})", flush=True)
    for forward in ("kernel2", "kernel"):
        _track("phase 10: path A", PATH_A, forward)
    return got["K6"]


def phase_path_b(device) -> int:
    """Sinusoidal-PE training; returns K7's launches in the auto run."""
    import numpy as np

    run = _cli_train(PATH_B)
    gather = _cli_train(PATH_B + ["TRAIN_FORWARD=gather"], decode=False)
    got = run["launches"]
    r, g = run["res"], gather["res"]
    print(f"phase 11: path B (TF_USE_TRI_PE=0), 200 epochs in "
          f"{run['wall']:.1f} s of wall time (gather {gather['wall']:.1f} s);"
          f" gates {sorted(run['engine'].items())}; launches {got}; loss "
          f"{run['losses'][0]:.5f} → {run['losses'][-1]:.5f}; mip-0 PSNR "
          f"{r['psnr'][0]:.4f} dB, bpp {r['bpp']:.4f} (gather run: "
          f"{g['psnr'][0]:.4f} dB, bpp {g['bpp']:.4f})", flush=True)
    if run["engine"] != {(0, False): "kernel2", (0, True): "kernel2"}:
        fail(f"path B: gates {run['engine']}, want kernel2 in both phases")
    if got != {"K11": 0, "K6": 0, "K7": 200, "K12": 0, "K9": 0}:
        fail(f"path B: launches {got}, want K7 200")
    if len(run["losses"]) != 200 or not np.isfinite(run["losses"]).all():
        fail("path B: the losses are not 200 finite values")
    if abs(r["psnr"][0] - g["psnr"][0]) > TRAIN_PSNR_DB:
        fail(f"path B: mip-0 PSNR {r['psnr'][0]:.4f} dB is not within "
             f"{TRAIN_PSNR_DB} dB of the gather run's {g['psnr'][0]:.4f}")
    _check_decodes("path B", run, no_mip=True)
    _track("phase 11: path B", PATH_B, "kernel2")
    return got["K7"]


def step_timing(engine, args, device, label=None) -> tuple:
    """200 steps of a trainer of ``args`` with TRAIN_FORWARD=``engine`` →
    (median step ms by CUDA events over steps 50-199, a line with that,
    the host ms per step over the same steps and, by torch.profiler over
    steps 40-44, the device operations and device ms per step with the
    five largest kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nic_torch.cli.image_compression import load_asset
    from nic_torch.config import parse_overrides
    from nic_torch.train.ntc import NTCTrainer

    cfg = parse_overrides(args + [f"TRAIN_FORWARD={engine}"])
    tr = NTCTrainer(cfg, load_asset(cfg))
    events = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    for i in range(200):
        if i == 40:
            prof.start()
        if i == 50:
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tr.train_step()
        end.record()
        events.append((start, end))
        if i == 44:
            torch.cuda.synchronize(device)
            prof.stop()
    torch.cuda.synchronize(device)
    wall = (time.perf_counter() - t0) / 150 * 1e3
    if tr._forward_mode != engine:
        fail(f"TRAIN_FORWARD={engine} ran {tr._forward_mode}")
    ops = sum(e.device_type == torch.autograd.DeviceType.CUDA
              for e in prof.events()) / 5
    ms = statistics.median(s.elapsed_time(e) for s, e in events[50:])
    # device time per step: the sum, and the five largest kernels
    kernels = sorted(((a.self_device_time_total / 5e3, a.key)
                      for a in prof.key_averages()
                      if a.device_type == torch.autograd.DeviceType.CUDA),
                     reverse=True)
    busy = sum(t for t, _ in kernels)
    label = label or " ".join(args[len(TRAIN_ARGS):]) or "flagship"
    return ms, (
        f"train step {engine} ({label}): median {ms:.4f} ms by CUDA events "
        f"over steps 50-199 ({1e3 / ms:.1f} steps/s); host clock "
        f"{wall:.4f} ms/step ({1e3 / wall:.1f} steps/s); "
        + (f"{ops:.0f} device operations and {busy:.4f} ms of device time "
           f"per step (idle share {1 - busy / ms:.3f} of the median step); "
           "largest: " + "; ".join(f"{t:.4f} {k[:60]}"
                                   for t, k in kernels[:5])
           if ops else "device operations per step: not measured (the "
           "profiler saw no device activity)"))


def phase_step_time(device) -> dict:
    """Train-step times per engine at LOD 0 (:func:`step_timing`)."""
    out = {}
    for engine, args in (("kernel3", TRAIN_ARGS), ("kernel2", PATH_B),
                         ("kernel", TRAIN_ARGS), ("gather", TRAIN_ARGS),
                         ("folded", TRAIN_ARGS)):
        out[engine], line = step_timing(engine, args, device)
        print(f"phase 12: {line}", flush=True)
    return out


def phase_step_time3(device) -> dict:
    """3D (misty m3, 8 crops of 32³) train-step times per engine at LOD 0."""
    out = {}
    for engine in ("kernel3", "kernel2", "kernel", "gather"):
        out[engine], line = step_timing(engine, MISTY, device,
                                        label="3D m3 8×32³")
        print(f"phase 20: {line}", flush=True)
    return out


# ---- the 3D path (methods 3 and 4) ------------------------------------

def _pyramid3(gen, device, size, sparse, no_mip, c=12, pe=6, hidden=64):
    """Random 3D pyramid and MLP (torch.Generator), flagship width unless
    told (C=12, H=64, PE 6), G0 of size/4 cells per axis."""
    from nic_torch.grids.pyramid import create_pyramid, pyramid_quantize_all
    from nic_torch.models.mlp import init_mlp

    fp, _ = create_pyramid(gen, size // 4, c, 8, 3, device=device,
                           no_mip=no_mip)
    fp = pyramid_quantize_all(fp, 8)
    mlp = init_mlp(gen, c * ((4 if sparse else 8) + 1) + 3 * pe + 1, hidden,
                   3, device=device)
    return fp, mlp


def _k5_work(args, nvox) -> tuple:
    """(bytes, dot FLOPs) of one K5 call: the planes, the row-PE table and
    the weights read once, the RGB written once; 2·N·(H² + 3H)."""
    hidden = args[2].shape[1]
    return (nbytes(*args) + nvox * 3 * 4,
            2 * nvox * (hidden * hidden + 3 * hidden))


def phase_k5(device) -> float:
    """K5 vs plain on random m3 and m4 mip-mode pyramids at 64³, mips 0-2
    and 4, in fp32·exact, bf16·exact, bf16·poly and i16·tanherf; returns
    the worst fp32·exact error."""
    import torch

    from nic_torch.grids.pyramid import pyramid_mip_levels
    from nic_torch.kernels import decode_fused_3d as k

    gen = torch.Generator(device="cpu").manual_seed(5)
    m2l = pyramid_mip_levels(64, 16, False)
    modes = (("fp32", None, "exact"), ("bf16", torch.bfloat16, "exact"),
             ("bf16", torch.bfloat16, "poly"), ("i16", "i16", "tanherf"))
    worst = {}
    with torch.inference_mode():
        for method in (3, 4):
            sparse = method == 4
            fp, mlp = _pyramid3(gen, device, 64, sparse, no_mip=False)
            for mip in (0, 1, 2, 4):
                if not k.kernel_covers_3d(mip, 64, m2l, 64):
                    fail(f"K5 does not cover mip {mip} of a mip-mode 64³")
                for mode, dtype, gelu in modes:
                    pc, c1v, pe_u, w2, b2, w3, b3, sc, geom = k._prepare_3d(
                        fp, mlp, mip, image_size=64, mip_to_level=m2l,
                        pe_channels=6, use_tri_pe=not sparse,
                        sparse_g0=sparse, dtype=dtype)
                    kw = dict(f=geom["f"], f1=geom["f1"], gelu=gelu)
                    args = (pc, c1v, pe_u, w2, b2, w3, b3, sc)
                    got = k.decode_kernel_3d(*args, **kw)
                    want = k.decode_kernel_3d_plain(*args, **kw)
                    if got.shape != want.shape or \
                            not torch.isfinite(got).all():
                        fail(f"K5 m{method} mip {mip} {mode}·{gelu}: shape "
                             f"{tuple(got.shape)} or non-finite")
                    err = float((got - want).abs().max())
                    key = f"{mode}·{gelu}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    if err > TOL[mode]:
                        fail(f"K5 vs plain m{method} mip {mip} {key}: "
                             f"max|Δ| {err:.3e} > {TOL[mode]:.0e}")
    print("phase 13: K5 vs plain, m3 and m4 at 64³, mips 0, 1, 2, 4, worst "
          "max|Δ|: " + ", ".join(f"{m} {e:.3e} (tol "
                                  f"{TOL[m.split('·')[0]]:.0e})"
                                  for m, e in worst.items()), flush=True)
    return worst["fp32·exact"]


def _misty_orig():
    """The clip as the trainer scores it: [T, H, W, 3] of codes/256·255."""
    import numpy as np

    from nic_torch.data.assets import load_volume

    return load_volume(CLIP).astype(np.float64) / 256.0 * 255.0


def phase_serve3(device) -> int:
    """The decode CLI on the 3D fixture at mips 0-6 against the JAX fold;
    returns K5's launches."""
    import numpy as np
    import torch

    from nic_torch.cli.decode import run
    from nic_torch.core.metrics import psnr
    from nic_torch.data.assets import read_clip
    from nic_torch.kernels.decode_fused_3d import decode_kernel_3d

    ref = dict(np.load(REF3))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        out = os.path.join(tmp, "mip0.avi")
        decode_kernel_3d.launches = 0
        recs = [run([ART3, "--mip", str(mip), "--device", device]
                    + (["--out", out] if mip == 0 else []))
                for mip in range(7)]
        launches = decode_kernel_3d.launches
        clip = read_clip(out)
    lsb = []
    for mip, rec in enumerate(recs):
        want = ref[f"dec{mip}"].astype(np.int64)
        if rec.shape != want.shape or not np.isfinite(rec).all():
            fail(f"3D mip {mip}: shape {rec.shape} (want {want.shape}) or "
                 "non-finite values")
        lsb.append(int(np.abs(u8(rec) - want).max()))
    if not np.array_equal(clip, (recs[0] * 255 + 0.5).astype(np.uint8)):
        fail("the AVI the decode CLI wrote does not read back as the decode")
    p0 = float(psnr(torch.from_numpy(_misty_orig()),
                    torch.from_numpy(u8(recs[0])).double()))
    print(f"phase 14: 3D fixture, fp32·exact u8 LSB vs the JAX fold, mips "
          f"0-6: {lsb}; mip-0 PSNR {p0:.4f} dB (JAX fold "
          f"{ref['psnr'][0]:.4f}); K5 launches {launches}; the AVI reads "
          "back", flush=True)
    if max(lsb) > LSB_FP32:
        fail(f"3D: u8 difference {max(lsb)} LSB > {LSB_FP32}")
    if abs(p0 - float(ref["psnr"][0])) > PSNR_DB:
        fail(f"3D: mip-0 PSNR {p0:.4f} is not within {PSNR_DB} dB of "
             f"{float(ref['psnr'][0]):.4f}")
    if launches != 3:
        fail(f"K5 launched {launches} times over mips 0-6; expected 3 "
             "(mips 0, 1, 2)")
    for mode, (gelu, bar) in ENVELOPE_3D.items():
        rec = run([ART3, "--mip", "0", "--device", device, "--dtype", mode,
                   "--gelu", gelu])
        d = int(np.abs(u8(rec) - ref["dec0"].astype(np.int64)).max())
        print(f"phase 14: 3D --dtype {mode} --gelu {gelu}: {d} LSB at mip 0 "
              f"(envelope {bar})", flush=True)
        if d > bar:
            fail(f"3D --dtype {mode} --gelu {gelu}: {d} LSB > {bar}")
    return launches


def phase_scale3(device, size: int = 256) -> tuple:
    """A flagship-width size³ m3 artifact (random weights), decoded at mip
    0 through the CLI and held to the plain fold; then K5 vs plain and the
    end-to-end decode timed. Returns (kernel ms, plain ms, work)."""
    import numpy as np
    import torch

    from nic_torch.cli.decode import run
    from nic_torch.grids.fastdecode import fast_decode
    from nic_torch.grids.pyramid import pyramid_mip_levels
    from nic_torch.io.artifacts import load_compressed, save_compressed
    from nic_torch.kernels import decode_fused_3d as k

    gen = torch.Generator(device="cpu").manual_seed(size)
    fp, mlp = _pyramid3(gen, device, size, False, no_mip=True)
    meta = {"save_name": f"chip_smoke_{size}3", "config": {
        "image_size": size, "image_size_w": 0, "pe_channels": 6,
        "tf_use_tri_pe": True, "tf_no_mip": True, "compression_method": 3,
        "image_dimension": 3}}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, f"m3_{size}.npz")
        save_compressed(path, mlp, fp, 8, meta)
        rec = run([path, "--mip", "0", "--device", device])
        mlp, fp, _ = load_compressed(path, device=device)
    m2l = pyramid_mip_levels(size, size // 4, True)
    kw = dict(image_size=size, mip_to_level=m2l, pe_channels=6)
    nvox = size**3
    with torch.inference_mode():
        want = fast_decode(fp, mlp, 0, ndim=3, **kw).clamp(0, 1).cpu()
        err = float(np.abs(rec - want.numpy()).max())
        del want
        print(f"phase 15: {size}³ CLI decode {rec.shape}, max|Δ| vs the "
              f"plain fold {err:.3e} (tol {TOL['fp32']:.0e})", flush=True)
        if rec.shape != (size,) * 3 + (3,) or not np.isfinite(rec).all():
            fail(f"{size}³ decode: shape {rec.shape} or non-finite")
        if err > TOL["fp32"]:
            fail(f"{size}³ decode differs from the plain fold by {err:.3e}")
        pc, c1v, pe_u, w2, b2, w3, b3, sc, geom = k._prepare_3d(
            fp, mlp, 0, use_tri_pe=True, sparse_g0=False, dtype=None, **kw)
        args = (pc, c1v, pe_u, w2, b2, w3, b3, sc)
        g = dict(f=geom["f"], f1=geom["f1"], gelu="exact")
        ms = cuda_ms(lambda: k.decode_kernel_3d(*args, **g))
        plain = cuda_ms(lambda: k.decode_kernel_3d_plain(*args, **g),
                        warmup=1, reps=3)
        work = _k5_work(args, nvox)
        b_ms, b_by = bound(*work, "tf32x3")
        print(f"phase 15: {size}³ K5 fp32·exact: kernel {ms:.4f} ms "
              f"({nvox / ms / 1e6:.3f} GVox/s) vs plain {plain:.4f} ms; "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        del pc, c1v, args
        for name, fn in (
                ("decode_volume_fused (frame/column stage + K5)",
                 lambda: k.decode_volume_fused(fp, mlp, 0, **kw)),
                ("fast_decode (plain fold)",
                 lambda: fast_decode(fp, mlp, 0, ndim=3, **kw))):
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            t = cuda_ms(fn, warmup=1, reps=3)
            peak = (torch.cuda.max_memory_allocated(device) - base) / 2**20
            print(f"phase 15: {size}³ end to end, {name}: {t:.4f} ms "
                  f"({nvox / t / 1e6:.3f} GVox/s), peak {peak:.0f} MiB above "
                  "the model", flush=True)
    return ms, plain, work


def _inputs3(gen, device, n, f, sparse, crops=8, size=64, **width):
    """Random no-mip 3D pyramid (G0 [12, 17³] at flagship width, or
    ``width``'s c, pe, hidden) and MLP, crops of n³ inside what G0 covers at
    period f, targets and seed words."""
    import torch

    fp, mlp = _pyramid3(gen, device, size, sparse, no_mip=True, **width)
    cover = (size // 4) * f
    origins = torch.randint(0, cover - n + 1, (crops, 3), generator=gen)
    tgt = torch.rand(crops * n**3, 3, generator=gen).to(device)
    words = torch.randint(-2**31, 2**31, (2,), generator=gen)
    seed = torch.cat([words, torch.zeros(2, dtype=torch.int64)]).to(
        torch.int32)
    weights = [mlp[k].detach() for k in NAMES]
    return fp, weights, tgt, origins, seed


# the K12/K9 shapes: 8 crops of 32³ (f=4, LOD 0), 16³ (f=2, LOD 1), 8³ (f=1,
# LOD 2), and 8³ at f=4 (JAX's rowsb < f class: slab blocks straddle cells)
SHAPES3 = ((32, 4), (16, 2), (8, 1), (8, 4))


def phase_k12(device) -> dict:
    """K12 vs plain at SHAPES3, m3 (triangular PE) and m4 (sinusoidal PE),
    noise off and on, fp32·erf and bf16·poly; timings at 8×32³."""
    import torch

    from nic_torch.kernels import train_fused_ff as k_ff
    from nic_torch.kernels import train_fused_ff3 as k

    names = ("loss", "out", "dw2", "db2", "dw3", "db3", "dpe0", "dpe1",
             "dpe2", "db1", "P_acc", "C1_acc", "dw1e")
    gen = torch.Generator(device="cpu").manual_seed(12)
    timings, worst = {}, {}
    with torch.no_grad():
        for n, f in SHAPES3:
            for method in (3, 4):
                sparse = method == 4
                fp, weights, tgt, origins, seed = _inputs3(gen, device, n, f,
                                                           sparse)
                for label, (cd, gelu) in K11_MODES.items():
                    cdt = None if cd == "fp32" else torch.bfloat16
                    vols = k.fold_volumes(fp[0], fp[1], weights[0], sparse,
                                          cdt)
                    for nbits in (None, 8):
                        args = (*vols, *weights, tgt, origins, seed)
                        kw = dict(n=n, f=f, npe=6, lodf=0.0, sparse_g0=sparse,
                                  use_tri_pe=not sparse, cd=cdt, gelu=gelu,
                                  nbits=nbits)
                        cell = (f"8×{n}³ f={f} m{method} {label} noise="
                                f"{'on' if nbits else 'off'}")
                        got = _run_twice(f"K12 {cell}", lambda: (
                            k.fused_train_ff3_kernel(*args, **kw)),
                            ("train_ff3", 64, cd))
                        want = k.fused_train_ff3_plain(*args, **kw)
                        tol = K11_TOL[cd]
                        errs = _compare(f"K12 vs plain {cell}", names, got,
                                        want, tol)
                        for nm, e in errs.items():
                            key = (label, nm)
                            worst[key] = max(worst.get(key, 0.0), e)
                        if n == 32 and method == 3 and (
                                (cd, nbits) in (("bf16", 8), ("fp32", None))):
                            ms = cuda_ms(lambda: k.fused_train_ff3_kernel(
                                *args, **kw))
                            plain = cuda_ms(lambda: k.fused_train_ff3_plain(
                                *args, **kw))
                            npix, hid = tgt.shape[0], 64
                            feat = weights[0].shape[0]
                            flops = 6 * npix * (hid * hid + 3 * hid) + (
                                4 * npix * feat * hid if nbits else 0)
                            work = (nbytes(*args[:9], origins)
                                    + nbytes(*got), flops)
                            timings[cell] = (ms, plain, work, errs["out"])
                            b_ms, b_by = bound(*work, cd)
                            print(f"phase 16: K12 {cell}: kernel {ms:.4f} ms "
                                  f"vs plain {plain:.4f} ms; bound "
                                  f"{b_ms:.4f} ms ({b_by})", flush=True)
                            _device_line(16, f"K12 {cell}", lambda: (
                                k.fused_train_ff3_kernel(*args, **kw)),
                                "train_ff3", 64, cd)
    # ff_epsgrad alone at K12's widths and feature passes (H = 64 in
    # passes of 128, H = 128 in passes of 64) on seeded dz1 of 8×31³ voxels
    # (not a multiple of 128), F = 127 (m3's) and 205 (past both passes)
    werr = 0.0
    for hidden, feat_pass in ((64, 128), (128, 64)):
        dz1 = _seeded_dz1(hidden, 8 * 31**3, hidden, device)
        for nfeat in (127, 205):
            for base in (0, 123457):
                for bf16 in (True, False):
                    werr = max(werr, _eps_grad_alone(
                        f"ff_epsgrad K12 H={hidden} 8×31³ F={nfeat} "
                        f"base={base} {'bf16' if bf16 else 'fp32'}", dz1,
                        nfeat, base, bf16, feat_pass))
    dz1 = _seeded_dz1(12, 8 * 32**3, 64, device)
    eps_ms = _parts_ms(lambda: k_ff.eps_grad(
        dz1, feat_pass=128, **_eps_kw(127, 0, True)), K11_PARTS)["D"]
    print(f"phase 16: ff_epsgrad alone at K12's widths (H = 64 pass 128, H "
          f"= 128 pass 64; F = 127, 205; base 0, 123457; bf16, fp32): worst "
          f"max|Δ|/max|plain| {werr:.2e} (tol {EPS_GRAD_TOL:.0e}), reruns "
          f"bit-identical; device at 8×32³ H=64 F=127 bf16 "
          f"{eps_ms:.4f} ms", flush=True)
    for label in K11_MODES:
        tol = K11_TOL[K11_MODES[label][0]]
        errs = {nm: e for (lb, nm), e in worst.items() if lb == label}
        print(f"phase 16: K12 vs plain {label}, worst over {len(SHAPES3)} "
              f"shapes × m3/m4 × noise off/on: loss rel {errs['loss']:.2e}, "
              f"out max|Δ| {errs['out']:.2e}, worst grad/volume rel "
              f"{max(e for nm, e in errs.items() if nm not in ('loss', 'out')):.2e}"
              f" (tol {tol['loss']:.0e}/{tol['out']:.0e}/{tol['grad']:.0e});"
              " reruns bit-identical", flush=True)
    _body_summary(16)
    return timings


def _gather3(fp, origins, n, f, sparse, device, pe=6):
    from nic_torch.grids.sample import decoder_input

    x = decoder_input(fp, 0, origins, 1.0 / f, n, pe_channels=pe,
                      mip_level=0, ndim=3, use_tri_pe=not sparse,
                      sparse_g0=sparse)
    return x.reshape(origins.shape[0] * n**3, -1).contiguous()


def phase_k9(device) -> dict:
    """K9 vs plain at SHAPES3, m3 and m4, fp32·erf and bf16·poly, on the 3D
    gather: loss, out, every MLP grad, dG0/dG1 after the unfold; timings at
    8×32³."""
    import torch

    from nic_torch.kernels import train_fused as k

    names = ("loss", "out", "dw1", "db1", "dw2", "db2", "dw3", "db3", "dG0",
             "dG1")
    gen = torch.Generator(device="cpu").manual_seed(9)
    timings = {}
    with torch.no_grad():
        for n, f in SHAPES3:
            for method in (3, 4):
                sparse = method == 4
                corners = (k._CORNERS_3D_SPARSE if sparse
                           else k._CORNERS_3D_DENSE)
                fp, weights, tgt, origins, _ = _inputs3(gen, device, n, f,
                                                        sparse)
                x = _gather3(fp, origins, n, f, sparse, device)
                geo = dict(g0_nodes=tuple(fp[0].shape[1:]),
                           g1_nodes=tuple(fp[1].shape[1:]))

                def unfolded(res):
                    dg = k._unfold_node_grads(res[8], res[9], weights[0],
                                              channels=12, corners=corners,
                                              **geo)
                    return tuple(res[:8]) + dg

                for label, (cd, gelu) in K11_MODES.items():
                    kw = dict(n=n, f=f, gelu=gelu,
                              cd=None if cd == "fp32" else torch.bfloat16,
                              **geo)
                    args = (x, tgt, origins, *weights)
                    cell = f"8×{n}³ f={f} m{method} {label}"
                    got = _run_twice(f"K9 {cell}", lambda: (
                        k.fused_mlp_loss_ng3_kernel(*args, **kw)),
                        ("train_mlp", 64, cd))
                    want = k.fused_mlp_loss_ng_plain(*args, **kw)
                    tol = K11_TOL[cd]
                    errs = _compare(f"K9 vs plain {cell}", names,
                                    unfolded(got), unfolded(want), tol)
                    print(f"phase 17: K9 vs plain {cell}: loss rel "
                          f"{errs['loss']:.2e}, out max|Δ| {errs['out']:.2e},"
                          f" MLP grads rel ≤ "
                          f"{max(errs[m] for m in names[2:8]):.2e}, dG0 "
                          f"{errs['dG0']:.2e}, dG1 {errs['dG1']:.2e}",
                          flush=True)
                    if n == 32 and method == 3:
                        ms = cuda_ms(lambda: k.fused_mlp_loss_ng3_kernel(
                            *args, **kw))
                        plain = cuda_ms(lambda: k.fused_mlp_loss_ng_plain(
                            *args, **kw))
                        work = _fused_work(x, tgt, weights, got, origins,
                                           with_dx=False)
                        timings[label] = (ms, plain, work, errs["out"])
                        b_ms, b_by = bound(*work, cd)
                        print(f"phase 17: K9 {cell}: kernel {ms:.4f} ms vs "
                              f"plain {plain:.4f} ms; bound {b_ms:.4f} ms "
                              f"({b_by})", flush=True)
                        _device_line(17, f"K9 {cell}", lambda: (
                            k.fused_mlp_loss_ng3_kernel(*args, **kw)),
                            "train_mlp", 64, cd)
    _body_summary(17)
    return timings


def phase_k6_3d(device) -> dict:
    """K6 at the 3D F = 127 on the 3D gather of 8 crops of 4³, 2³ and 1³
    (N = 512, 64, 8: partial tiles), fp32·erf and bf16·poly; timings at
    8×4³ (3D mip mode's LOD 3)."""
    import torch

    from nic_torch.kernels import train_fused as k

    names = ("loss", "out", "dx", "dw1", "db1", "dw2", "db2", "dw3", "db3")
    gen = torch.Generator(device="cpu").manual_seed(61)
    timings = {}
    with torch.no_grad():
        for n in (4, 2, 1):
            fp, weights, tgt, origins, _ = _inputs3(gen, device, n, 1, False)
            x = _gather3(fp, origins, n, 1, False, device)
            if x.shape[1] != 127:
                fail(f"the 3D gather has {x.shape[1]} features, not 127")
            for label, (cd, gelu) in K11_MODES.items():
                kw = dict(gelu=gelu,
                          cd=None if cd == "fp32" else torch.bfloat16)
                cell = f"8×{n}³ F=127 {label}"
                got = _run_twice(f"K6 {cell}", lambda: (
                    k.fused_mlp_loss_kernel(x, tgt, *weights, **kw)),
                    ("train_mlp", 64, cd))
                want = k.fused_mlp_loss_plain(x, tgt, *weights, **kw)
                errs = _compare(f"K6 vs plain {cell}", names, got, want,
                                K11_TOL[cd])
                print(f"phase 18: K6 vs plain {cell}: loss rel "
                      f"{errs['loss']:.2e}, out max|Δ| {errs['out']:.2e}, dx "
                      f"rel {errs['dx']:.2e}, MLP grads rel ≤ "
                      f"{max(errs[m] for m in names[3:]):.2e}", flush=True)
                if n == 4:
                    ms = cuda_ms(lambda: k.fused_mlp_loss_kernel(
                        x, tgt, *weights, **kw))
                    plain = cuda_ms(lambda: k.fused_mlp_loss_plain(
                        x, tgt, *weights, **kw))
                    work = _fused_work(x, tgt, weights, got)
                    timings[label] = (ms, plain, work, errs["out"])
                    b_ms, b_by = bound(*work, cd)
                    print(f"phase 18: K6 {cell}: kernel {ms:.4f} ms vs plain "
                          f"{plain:.4f} ms; bound {b_ms:.4f} ms ({b_by})",
                          flush=True)
    _body_summary(18)
    return timings


def _check_decodes3(tag, run, no_mip: bool) -> int:
    """Every mip of the 64³ volume decoded at its size; K5 launched once
    per mip it covers. Returns that count."""
    import numpy as np

    from nic_torch.grids.pyramid import pyramid_mip_levels
    from nic_torch.kernels.decode_fused_3d import kernel_covers_3d

    m2l = pyramid_mip_levels(64, 16, no_mip)
    covered = sum(kernel_covers_3d(mip, 64, m2l, 64) for mip in range(7))
    for mip, rec in enumerate(run["recs"]):
        if rec.shape != (64 >> mip,) * 3 + (3,) or \
                not np.isfinite(rec).all():
            fail(f"{tag}: decode at mip {mip}: shape {rec.shape} or "
                 "non-finite")
    if run["k5"] != covered:
        fail(f"{tag}: the decode CLI launched K5 {run['k5']} times over "
             f"mips 0-6; the kernel covers {covered}")
    return covered


def _run3(tag, args, engine, kernel):
    """A 200-epoch 3D CLI run whose gates must name ``engine`` at LOD 0 in
    both phases and whose ``kernel`` launches on every step; checks the
    losses and the decodes."""
    import numpy as np

    run = _cli_train(args, mips=range(7))
    want = {k: 0 for k in run["launches"]}
    want[kernel] = 200
    if run["engine"] != {(0, False): engine, (0, True): engine}:
        fail(f"{tag}: gates {run['gates']}, want {engine} in both phases")
    if run["launches"] != want:
        fail(f"{tag}: launches {run['launches']}, want {kernel} 200")
    if len(run["losses"]) != 200 or not np.isfinite(run["losses"]).all():
        fail(f"{tag}: the losses are not 200 finite values")
    _check_decodes3(tag, run, no_mip=True)
    return run


def phase_train3(device) -> dict:
    """The 3D CLI runs: m3 and m4 flag-free (K12 on every step), m3 mip mode
    (K12 and K6 by LOD), m3 TRAIN_FORWARD=kernel2 (K9 on every step), the
    last three beside gather runs; then kernel3 and kernel2 tracking gather
    from one seed. Returns the launches of K12 (m3) and K9."""
    import numpy as np

    ref = dict(np.load(REF3))
    jax_psnr = float(ref["run_psnr"][0])
    out = {}
    m3 = _run3("phase 19: m3", MISTY, "kernel3", "K12")
    p3 = m3["res"]["psnr"][0]
    print(f"phase 19: 3D m3 flag-free, 200 epochs in {m3['wall']:.1f} s of "
          f"wall time; gates {sorted(m3['engine'].items())}; launches "
          f"{m3['launches']}; loss {m3['losses'][0]:.5f} → "
          f"{m3['losses'][-1]:.5f}; mip-0 PSNR {p3:.4f} dB (fixture's JAX "
          f"run {jax_psnr:.4f}), average PSNR {m3['res']['average_psnr']:.4f}"
          f", bpp {m3['res']['bpp']:.4f}; K5 launches {m3['k5']}",
          flush=True)
    if abs(p3 - jax_psnr) > TRAIN_PSNR_DB:
        fail(f"3D m3: mip-0 PSNR {p3:.4f} dB is not within {TRAIN_PSNR_DB} "
             f"dB of the JAX run's {jax_psnr:.4f}")
    out["K12"] = m3["launches"]["K12"]

    gather = {}
    for tag, args in (("m4", MISTY + ["COMPRESSION_METHOD=4"]),
                      ("m3 mip mode", MISTY + ["TF_NO_MIP=0"]),
                      ("m3", MISTY)):
        g = _cli_train(args + ["TRAIN_FORWARD=gather"], decode=False)
        gather[tag] = g["res"]["psnr"][0]
        print(f"phase 19: 3D {tag} TRAIN_FORWARD=gather, 200 epochs in "
              f"{g['wall']:.1f} s: mip-0 PSNR {gather[tag]:.4f} dB", flush=True)

    def beside(tag, run, ref_tag):
        p = run["res"]["psnr"][0]
        if abs(p - gather[ref_tag]) > TRAIN_PSNR_DB:
            fail(f"3D {tag}: mip-0 PSNR {p:.4f} dB is not within "
                 f"{TRAIN_PSNR_DB} dB of the gather run's "
                 f"{gather[ref_tag]:.4f}")

    m4 = _run3("phase 19: m4", MISTY + ["COMPRESSION_METHOD=4"], "kernel3",
               "K12")
    print(f"phase 19: 3D m4 flag-free, 200 epochs in {m4['wall']:.1f} s; "
          f"launches {m4['launches']}; mip-0 PSNR "
          f"{m4['res']['psnr'][0]:.4f} dB vs gather {gather['m4']:.4f}, bpp "
          f"{m4['res']['bpp']:.4f}; K5 launches {m4['k5']}", flush=True)
    beside("m4", m4, "m4")

    args = MISTY + ["TF_NO_MIP=0"]
    mm = _cli_train(args, mips=range(7))
    lods = _lod_sequence(args)
    want = {lod: "kernel3" if lod in KERNEL3_LODS_3D else "kernel"
            for lod in set(lods)}
    want_k12 = sum(want[lod] == "kernel3" for lod in lods)
    got = mm["launches"]
    drawn = {int(v): int(c) for v, c in zip(*np.unique(lods,
                                                      return_counts=True))}
    print(f"phase 19: 3D m3 mip mode (TF_NO_MIP=0), 200 epochs in "
          f"{mm['wall']:.1f} s; LODs drawn {drawn}; gates "
          f"{sorted(mm['engine'].items())}; launches {got} (want K12 "
          f"{want_k12}, K6 {200 - want_k12}); mip-0 PSNR "
          f"{mm['res']['psnr'][0]:.4f} dB vs gather "
          f"{gather['m3 mip mode']:.4f}; K5 launches {mm['k5']}", flush=True)
    for (lod, _), engine in mm["engine"].items():
        if engine != want[lod]:
            fail(f"3D mip mode: LOD {lod} ran {engine}, JAX runs {want[lod]}")
    if got != {**{k: 0 for k in got}, "K12": want_k12,
               "K6": 200 - want_k12}:
        fail(f"3D mip mode: launches {got}, want K12 {want_k12}, K6 "
             f"{200 - want_k12}")
    if not np.isfinite(mm["losses"]).all():
        fail("3D mip mode: non-finite losses")
    if _check_decodes3("3D mip mode", mm, no_mip=False) != 4:
        fail("3D mip mode: K5 should cover mips 0, 1, 2 and 4")
    beside("m3 mip mode", mm, "m3 mip mode")

    k2 = _run3("phase 19: kernel2", MISTY + ["TRAIN_FORWARD=kernel2"],
               "kernel2", "K9")
    print(f"phase 19: 3D m3 TRAIN_FORWARD=kernel2, 200 epochs in "
          f"{k2['wall']:.1f} s; launches {k2['launches']}; mip-0 PSNR "
          f"{k2['res']['psnr'][0]:.4f} dB vs gather {gather['m3']:.4f}",
          flush=True)
    beside("kernel2", k2, "m3")
    out["K9"] = k2["launches"]["K9"]

    _track("phase 19: 3D m3", MISTY + ["QAT_NOISE_WHERE=node"], "kernel3")
    _track("phase 19: 3D m3", MISTY, "kernel2")
    return out


# ---- the alternate 2D decodes (K3, K4, K2) and the XLA alternates ---------

def _random_flagship(device, size: int, hidden: int = 64):
    """phase 5's flagship-width random model at size² (C=12, H=64 unless
    told, PE 6, FP_BITS 8, no mip; seeded with ``size``): (fp, mlp,
    mip_to_level)."""
    import torch

    from nic_torch.grids.pyramid import (create_pyramid, pyramid_mip_levels,
                                         pyramid_quantize_all)
    from nic_torch.models.mlp import init_mlp

    gen = torch.Generator(device="cpu").manual_seed(size)
    fp, _ = create_pyramid(gen, size // 4, 12, 8, device=device, no_mip=True)
    mlp = init_mlp(gen, 12 * 5 + 2 * 6 + 1, hidden, 3, device=device)
    return (pyramid_quantize_all(fp, 8), {k: mlp[k].detach() for k in NAMES},
            pyramid_mip_levels(size, size // 4, True))


def _fixture(device):
    """The committed 512² artifact: (fp, mlp, mip_to_level, its JAX
    reference)."""
    import numpy as np

    from nic_torch.grids.pyramid import pyramid_mip_levels
    from nic_torch.io.artifacts import load_compressed

    mlp, fp, _ = load_compressed(ART, device=device)
    return (fp, {k: mlp[k].detach() for k in NAMES},
            pyramid_mip_levels(512, 128, True), dict(np.load(REF)))


def _fold_lsb(tag, recs, ref, bar, hold_psnr=True) -> list:
    """u8 LSB of each mip's decode against the JAX fold, and the mip-0
    PSNR; fails past ``bar`` or (``hold_psnr``) PSNR_DB from the fold's."""
    import numpy as np
    import torch

    from nic_torch.core.metrics import psnr

    lsb = []
    for mip, rec in enumerate(recs):
        rec = np.asarray(rec.cpu() if hasattr(rec, "cpu") else rec)
        want = ref[f"dec{mip}"].astype(np.int64)
        if rec.shape != want.shape or not np.isfinite(rec).all():
            fail(f"{tag}: mip {mip} shape {rec.shape} (want {want.shape}) or "
                 "non-finite values")
        lsb.append(int(np.abs(u8(rec) - want).max()))
        if mip == 0:
            p0 = float(psnr(torch.from_numpy(ref["orig0"]).double(),
                            torch.from_numpy(u8(rec)).double()))
    if max(lsb) > bar:
        fail(f"{tag}: {max(lsb)} u8 LSB from the JAX fold > {bar} ({lsb})")
    if hold_psnr and abs(p0 - float(ref["psnr"][0])) > PSNR_DB:
        fail(f"{tag}: mip-0 PSNR {p0:.4f} is not within {PSNR_DB} dB of the "
             f"JAX fold's {float(ref['psnr'][0]):.4f}")
    return lsb + [p0]


def _v1_args(fp, mlp, mip, m2l, size, dtype):
    """K3's operands for one mip and its geometry keywords."""
    from nic_torch.kernels import decode_fused as k

    fl = m2l[mip]
    e, n = mip - (fl + 1) * 2, size >> mip
    g0, g1 = fp[fl * 2], fp[fl * 2 + 1]
    if dtype is not None:
        g0, g1 = g0.to(dtype), g1.to(dtype)
    w = [mlp[name].to(g0.dtype).contiguous() for name in NAMES]
    return (g0.contiguous(), g1.contiguous(), *w), dict(
        e=e, n=n, pe_channels=6, mip_level=mip,
        rows=k.fused_rows_per_block(n, e, g0.shape[0]))


def phase_k3(device) -> dict:
    """K3 (the v1 decode): the fixture at mips 0-9 (the counted path),
    kernel vs plain in fp32 and bf16 and held to the JAX fold; a random
    sinusoidal-PE flagship-width model; 2048² in fp32 and bf16 timed. The
    launch log of the fixture's serve, and the launch log and the
    profiler of the 2048² calls, must name only the body ``decode_body``
    names (``decode_v1_mma`` at H = 64)."""
    import torch

    from nic_torch.kernels import decode_fused as k
    from nic_torch.kernels._build import body_launches, clear_body_launches

    fp, mlp, m2l, ref = _fixture(device)
    kw = dict(image_size=512, mip_to_level=m2l, pe_channels=6,
              use_tri_pe=True)
    worst = {"fp32": 0.0, "bf16": 0.0}

    def check(tag, got, want, mode):
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"K3 {tag}: shape {tuple(got.shape)} or non-finite")
        err = float((got - want).abs().max())
        worst[mode] = max(worst[mode], err)
        if err > TOL[mode]:
            fail(f"K3 vs plain, {tag}: max|Δ| {err:.3e} > {TOL[mode]:.0e}")

    with torch.inference_mode():
        k.decode_kernel_v1.launches = 0
        clear_body_launches()
        recs = [k.decode_image_fused(fp, mlp, mip, **kw) for mip in range(10)]
        launches = k.decode_kernel_v1.launches
        logged = body_launches()
        want_body = _want_body("decode_v1", 64, "fp32")
        if _bodies_named(logged) != {want_body}:
            fail(f"phase 21: the fixture's serve launched the bodies "
                 f"{sorted(_bodies_named(logged))}, want {want_body}")
        lsb = {}
        for mode, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
            got_all = []
            for mip in range(10):
                args, g = _v1_args(fp, mlp, mip, m2l, 512, dtype)
                got = (recs[mip] if dtype is None else
                       k.decode_kernel_v1(*args, use_tri_pe=True, **g))
                check(f"fixture mip {mip} {mode}", got,
                      k.decode_kernel_v1_plain(*args, use_tri_pe=True, **g),
                      mode)
                got_all.append(got)
            lsb[mode] = _fold_lsb(f"K3 {mode}", got_all, ref,
                                  LSB_FP32 if mode == "fp32"
                                  else ENVELOPE["bf16"][1],
                                  hold_psnr=mode == "fp32")
        fpr, mlpr, m2lr = _random_flagship(device, 512)
        for mode, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
            for mip in (0, 1, 2):
                args, g = _v1_args(fpr, mlpr, mip, m2lr, 512, dtype)
                check(f"random sinusoidal PE mip {mip} {mode}",
                      k.decode_kernel_v1(*args, use_tri_pe=False, **g),
                      k.decode_kernel_v1_plain(*args, use_tri_pe=False, **g),
                      mode)
        fp2, mlp2, m2l2 = _random_flagship(device, 2048)
        timed = {}
        for mode, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
            args, g = _v1_args(fp2, mlp2, 0, m2l2, 2048, dtype)

            def call():
                return k.decode_kernel_v1(*args, use_tri_pe=True, **g)

            check(f"2048² {mode}",
                  _check_body(f"phase 21: K3 2048² {mode}", call,
                              "decode_v1", 64, mode),
                  k.decode_kernel_v1_plain(*args, use_tri_pe=True, **g), mode)
            ms = cuda_ms(call)
            plain = cuda_ms(lambda: k.decode_kernel_v1_plain(
                *args, use_tri_pe=True, **g), warmup=1, reps=3)
            total, per = device_ms(call)
            npix = 2048 * 2048
            nfeat, hidden = args[2].shape
            work = (nbytes(*args) + npix * 3 * 4,
                    2 * npix * (nfeat * hidden + hidden * hidden
                                + 3 * hidden))
            b_ms, b_by = bound(*work, "tf32x3" if mode == "fp32" else "bf16")
            timed[mode] = (ms, plain, work)
            print(f"phase 21: K3 2048² {mode}: kernel {ms:.4f} ms "
                  f"({npix / ms / 1e6:.3f} GPix/s; device {total:.4f} ms, "
                  f"of it {want_body} {_body_ms(per, want_body):.4f}) vs "
                  f"plain {plain:.4f} ms; bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
    _body_summary(21)
    print(f"phase 21: K3 on the fixture, mips 0-9: {launches} launches, "
          f"body {want_body} by the launch log; u8 "
          f"LSB vs the JAX fold fp32 {lsb['fp32'][:10]} (mip-0 PSNR "
          f"{lsb['fp32'][10]:.4f} dB, JAX fold {float(ref['psnr'][0]):.4f}), "
          f"bf16 {lsb['bf16'][:10]}; kernel vs plain worst max|Δ| fp32 "
          f"{worst['fp32']:.3e}, bf16 {worst['bf16']:.3e}", flush=True)
    if launches != 10:
        fail(f"K3 launched {launches} times over the fixture's mips 0-9; "
             "want 10")
    ms, plain, work = timed["fp32"]
    return dict(launches=launches, err=worst["fp32"], ms=ms, plain=plain,
                work=work)


def phase_k4(device) -> dict:
    """K4 (the v3 MLP tail): vs plain on the 2048² random model's
    first-layer accumulator in all four accumulator × dot dtypes, timed,
    each call's body by the launch log and the profiler
    (``mlp_tail_mma`` at H = 64); the v3 decode held to fast_decode on the
    fixture at mips 0-9 (the counted path, its launch log naming only
    that body); the whole v3 decode at 2048² timed with its peak memory,
    beside K1's."""
    import torch

    from nic_torch.grids.fastdecode import fast_decode, first_layer_acc
    from nic_torch.kernels import decode_fused_v2 as k1
    from nic_torch.kernels import decode_fused_v3 as k
    from nic_torch.kernels._build import body_launches, clear_body_launches

    fp2, mlp2, m2l2 = _random_flagship(device, 2048)
    kw2 = dict(image_size=2048, mip_to_level=m2l2, pe_channels=6,
               use_tri_pe=True)
    npix = 2048 * 2048
    out = {}
    with torch.inference_mode():
        acc = first_layer_acc(fp2, mlp2, 0, **kw2).contiguous()
        for acc_mode, acc_dtype in (("fp32", torch.float32),
                                    ("bf16", torch.bfloat16)):
            for mode, dtype in (("fp32", torch.float32),
                                ("bf16", torch.bfloat16)):
                cell = f"{acc_mode} accumulator, {mode} dots"
                args = (acc.to(acc_dtype), mlp2["w2"].to(dtype), mlp2["b2"],
                        mlp2["w3"].to(dtype), mlp2["b3"])
                got = _check_body(f"phase 22: K4 2048² {cell}",
                                  lambda: k.mlp_tail(*args), "decode_v3", 64,
                                  mode)
                want = k.mlp_tail_plain(*args)
                if (got.shape != (2048, 2048, 3)
                        or not torch.isfinite(got).all()):
                    fail(f"K4 {cell}: shape {tuple(got.shape)} or "
                         "non-finite")
                err = float((got - want).abs().max())
                if err > TOL[mode]:
                    fail(f"K4 vs plain {cell}: max|Δ| {err:.3e} > "
                         f"{TOL[mode]:.0e}")
                del want
                ms = cuda_ms(lambda: k.mlp_tail(*args))
                plain = cuda_ms(lambda: k.mlp_tail_plain(*args), warmup=1,
                                reps=3)
                total, per = device_ms(lambda: k.mlp_tail(*args))
                body = _want_body("decode_v3", 64, mode)
                work = (nbytes(*args) + npix * 3 * 4,
                        2 * npix * (64 * 64 + 3 * 64))
                out[(acc_mode, mode)] = (ms, plain, work, err)
                b_ms, b_by = bound(*work,
                                   "tf32x3" if mode == "fp32" else "bf16")
                print(f"phase 22: K4 2048² {cell}: kernel {ms:.4f} ms "
                      f"(device {total:.4f} ms, of it {body} "
                      f"{_body_ms(per, body):.4f}) vs plain {plain:.4f} ms, "
                      f"max|Δ| {err:.3e} (tol {TOL[mode]:.0e}); bound "
                      f"{b_ms:.4f} ms ({b_by})", flush=True)
        del acc, args
        _body_summary(22)
        fp, mlp, m2l, _ = _fixture(device)
        kw = dict(image_size=512, mip_to_level=m2l, pe_channels=6,
                  use_tri_pe=True)
        k.mlp_tail.launches = 0
        clear_body_launches()
        recs = [k.decode_image_fused_v3(fp, mlp, mip, **kw)
                for mip in range(10)]
        launches = k.mlp_tail.launches
        logged = body_launches()
        want_body = _want_body("decode_v3", 64, "fp32")
        if _bodies_named(logged) != {want_body}:
            fail(f"phase 22: the v3 serve launched the bodies "
                 f"{sorted(_bodies_named(logged))}, want {want_body}")
        errs = [float((r - fast_decode(fp, mlp, mip, **kw)).abs().max())
                for mip, r in enumerate(recs)]
        if max(errs) > TOL["fp32"]:
            fail(f"the v3 decode differs from fast_decode: {errs}")
        for name, fn in (
                ("decode_image_fused_v3 (accumulator + K4)",
                 lambda: k.decode_image_fused_v3(fp2, mlp2, 0, **kw2)),
                ("decode_image_fused_v2 (column stage + K1)",
                 lambda: k1.decode_image_fused_v2(fp2, mlp2, 0, **kw2))):
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            t = cuda_ms(fn)
            peak = (torch.cuda.max_memory_allocated(device) - base) / 2**20
            print(f"phase 22: 2048² end to end, {name}: {t:.4f} ms "
                  f"({npix / t / 1e6:.3f} GPix/s), peak {peak:.0f} MiB above "
                  "the model", flush=True)
    print(f"phase 22: the v3 decode on the fixture, mips 0-9: {launches} K4 "
          f"launches, body {want_body} by the launch log; max|Δ| vs "
          f"fast_decode {max(errs):.3e}", flush=True)
    if launches != 10:
        fail(f"K4 launched {launches} times over the fixture's mips 0-9; "
             "want 10")
    return dict(launches=launches, fp32=out[("fp32", "fp32")])


# K2's contract corners outside JAX's gate, (R, f, f1, image rows): a
# window over two tiles with 18 band rows (and a last window half past the
# image), two windows a tile, and the one geometry whose A splits in bf16
K2_CORNERS = ((8, 2, 2, 72), (32, 4, 8, 96), (512, 1, 512, 512))


def _k2_corner(device, R, f, f1, nr, mode, mlp):
    """K2's operands at a corner: seeded planes and row PE of nr rows x 44
    columns (ragged against a block's 8), the tail of ``mlp``, in a plane
    mode's dtypes."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(R + f + f1)
    plane = torch.bfloat16 if mode == "bf16" else torch.float32
    dot = torch.float32 if mode == "fp32" else torch.bfloat16

    def draw(*shape, dt):
        return (torch.rand(shape, generator=gen) * 2 - 1).to(dt).to(device)

    hidden = mlp["w2"].shape[0]
    return (draw(nr // f, 44, hidden, dt=plane),
            draw(nr // f1 + 1, 44, hidden, dt=plane),
            draw(nr, hidden, dt=plane), mlp["w2"].to(dot), mlp["b2"],
            mlp["w3"].to(dot), mlp["b3"])


def phase_k2(device) -> dict:
    """K2 (the z1-matmul decode): vs its plain version and K1 on the
    fixture at mips 0-2 and at 2048² in fp32·exact, bf16·poly and
    surgical·exact, and vs its plain version at the contract corners
    K2_CORNERS; ``"auto"`` serving the fixture at mips 0-9 (the counted
    path: K2 at mips 0-2) held to the JAX fold, and K1 under int16 planes;
    K2 timed beside K1 at 2048². The launch log of the serve, the corners
    and each 2048² cell, and the profiler of the serve and each 2048²
    cell, must name only the body ``decode_body`` names
    (``decode_z1mm_mma`` at H = 64)."""
    import torch

    from nic_torch.kernels import decode_fused_v2 as k
    from nic_torch.kernels._build import body_launches, clear_body_launches

    fp, mlp, m2l, ref = _fixture(device)
    fp2, mlp2, m2l2 = _random_flagship(device, 2048)
    modes = (("fp32", None, "exact"), ("bf16", torch.bfloat16, "poly"),
             ("surgical", "surgical", "exact"))
    want_body = _want_body("decode_z1mm", 64, "fp32")
    worst, corners, timings = {}, {}, {}

    def hold_logged(tag):
        logged = body_launches()
        if _bodies_named(logged) != {want_body}:
            fail(f"phase 23: {tag} launched the bodies "
                 f"{sorted(_bodies_named(logged))}, want {want_body}")
        clear_body_launches()

    with torch.inference_mode():
        for label, (fpx, mlpx, m2lx, size, mips) in (
                ("fixture", (fp, mlp, m2l, 512, (0, 1, 2))),
                ("2048²", (fp2, mlp2, m2l2, 2048, (0,)))):
            for mip in mips:
                for mode, dtype, gelu in modes:
                    pc, c1v, pe_u, w2, b2, w3, b3, s, geom = k._prepare_2d(
                        fpx, mlpx, mip, image_size=size, mip_to_level=m2lx,
                        pe_channels=6, use_tri_pe=True, dtype=dtype)
                    if not geom["packed"]:
                        fail(f"K2 {label} mip {mip}: JAX's auto would not "
                             "take the z1-matmul kernel here")
                    args = (pc, c1v, pe_u, w2, b2, w3, b3)
                    g = dict(f=geom["f"], f1=geom["f1"], gelu=gelu)
                    key = f"{mode}·{gelu}"

                    def call():
                        return k.decode_kernel_z1mm(*args, R=geom["R"], **g)

                    got = (_check_body(f"phase 23: K2 2048² {key}", call,
                                       "decode_z1mm", 64, mode)
                           if size == 2048 else call())
                    want = k.decode_kernel_z1mm_plain(*args, R=geom["R"], **g)
                    k1 = k.decode_kernel_2d(*args, s, **g)
                    if got.shape != want.shape or \
                            not torch.isfinite(got).all():
                        fail(f"K2 {label} mip {mip} {mode}: shape or "
                             "non-finite")
                    errs = (float((got - want).abs().max()),
                            float((got - k1).abs().max()))
                    prev = worst.get(key, (0.0, 0.0))
                    worst[key] = (max(prev[0], errs[0]),
                                  max(prev[1], errs[1]))
                    if max(errs) > TOL[mode]:
                        fail(f"K2 {label} mip {mip} {key}: max|Δ| vs plain "
                             f"{errs[0]:.3e}, vs K1 {errs[1]:.3e} > "
                             f"{TOL[mode]:.0e}")
                    if size == 2048:
                        ms = cuda_ms(call)
                        k1_ms = cuda_ms(lambda: k.decode_kernel_2d(
                            *args, s, **g))
                        plain = cuda_ms(lambda: k.decode_kernel_z1mm_plain(
                            *args, R=geom["R"], **g), warmup=1, reps=3)
                        total, per = device_ms(call)
                        kk = geom["R"] // geom["f"] + geom["R"] // geom["f1"] + 1
                        npix = size * size
                        work = (nbytes(*args) + npix * 3 * 4,
                                2 * npix * (64 * 64 + 3 * 64 + kk * 64))
                        timings[key] = (ms, plain, work, k1_ms)
                        b_ms, b_by = bound(*work, "tf32x3" if mode == "fp32"
                                           else "bf16")
                        print(f"phase 23: 2048² {key}: K2 {ms:.4f} ms "
                              f"(device {total:.4f} ms, of it {want_body} "
                              f"{_body_ms(per, want_body):.4f}), K1 "
                              f"{k1_ms:.4f} ms (K2/K1 {ms / k1_ms:.3f}), plain "
                              f"{plain:.4f} ms; K2 bound {b_ms:.4f} ms "
                              f"({b_by}, K = {kk})", flush=True)
        clear_body_launches()
        for R, f, f1, nr in K2_CORNERS:
            for mode, _, gelu in modes:
                args = _k2_corner(device, R, f, f1, nr, mode, mlp2)
                g = dict(f=f, f1=f1, R=R, gelu=gelu)
                got = k.decode_kernel_z1mm(*args, **g)
                want = k.decode_kernel_z1mm_plain(*args, **g)
                if got.shape != want.shape or not torch.isfinite(got).all():
                    fail(f"K2 corner R={R} f={f} f1={f1} {mode}: shape or "
                         "non-finite")
                err = float((got - want).abs().max())
                corners[mode] = max(corners.get(mode, 0.0), err)
                if err > TOL[mode]:
                    fail(f"K2 corner R={R} f={f} f1={f1} {mode}·{gelu}: "
                         f"max|Δ| vs plain {err:.3e} > {TOL[mode]:.0e}")
        hold_logged("the corners")
        kw = dict(image_size=512, mip_to_level=m2l, pe_channels=6,
                  use_tri_pe=True)
        k.decode_kernel_z1mm.launches = k.decode_kernel_2d.launches = 0
        recs = [k.decode_image_fused_v2(fp, mlp, mip, z1_matmul="auto", **kw)
                for mip in range(10)]
        launches = k.decode_kernel_z1mm.launches
        k1_launches = k.decode_kernel_2d.launches
        hold_logged("the fixture's 'auto' serve")
        _check_body("phase 23: K2 'auto' serve of mips 0-2",
                    lambda: [k.decode_image_fused_v2(
                        fp, mlp, mip, z1_matmul="auto", **kw)
                        for mip in (0, 1, 2)], "decode_z1mm", 64, "fp32")
        k.decode_kernel_z1mm.launches = k.decode_kernel_2d.launches = 0
        k.decode_image_fused_v2(fp, mlp, 0, dtype="i16", z1_matmul="auto",
                                **kw)
        i16 = (k.decode_kernel_z1mm.launches, k.decode_kernel_2d.launches)
    _body_summary(23)
    lsb = _fold_lsb("K2 auto", recs, ref, LSB_FP32)
    print(f"phase 23: z1_matmul='auto' on the fixture, mips 0-9: K2 "
          f"{launches} launches, K1 {k1_launches}, body {want_body} by the "
          f"launch log; u8 LSB vs the JAX fold {lsb[:10]}, mip-0 PSNR "
          f"{lsb[10]:.4f} dB; under i16 planes K2 {i16[0]}, K1 {i16[1]}; K2 "
          "vs plain / vs K1 worst max|Δ|: "
          + ", ".join(f"{m} {a:.3e} / {b:.3e}" for m, (a, b) in worst.items())
          + "; at the corners "
          + ", ".join(f"(R, f, f1, rows) = {c}" for c in K2_CORNERS)
          + " vs plain worst max|Δ|: "
          + ", ".join(f"{m} {e:.3e}" for m, e in corners.items()),
          flush=True)
    if (launches, k1_launches) != (3, 0):
        fail(f"'auto' launched K2 {launches} and K1 {k1_launches} times over "
             "the fixture's mips 0-9; want K2 3 (mips 0-2), K1 0")
    if i16 != (0, 1):
        fail(f"'auto' under int16 planes launched K2 {i16[0]}, K1 {i16[1]}; "
             "want K1")
    return dict(launches=launches, err=worst["fp32·exact"][0],
                fp32=timings["fp32·exact"])


def phase_xla_cli(device) -> list:
    """The decode CLI's ``--backend xla`` (the gather decode) on the
    fixture at mips 0-9, held to the JAX fold."""
    from nic_torch.cli.decode import run

    _, _, _, ref = _fixture(device)
    recs = [run([ART, "--mip", str(mip), "--device", device, "--backend",
                 "xla"]) for mip in range(10)]
    lsb = _fold_lsb("--backend xla", recs, ref, LSB_FP32)
    print(f"phase 24: decode CLI --backend xla, mips 0-9: u8 LSB vs the JAX "
          f"fold {lsb[:10]}, mip-0 PSNR {lsb[10]:.4f} dB (JAX fold "
          f"{float(ref['psnr'][0]):.4f})", flush=True)
    return lsb


def phase_folded(device) -> dict:
    """TRAIN_FORWARD=folded with DECODE_BACKEND=xla and DIV_SIZE=6, in mip
    mode (the tiled decode needs a max mip above DIV_SIZE; no-mip runs have
    none), 200 epochs through the CLI: no train kernel launches, the gate
    log names folded at every LOD and the tiled gather decode, mip-0 PSNR
    within 1.0 dB of the fixture's JAX run; then folded against gather
    from one seed (fp32 dots, as the JAX suite pins them for this
    check); then the mip-0 decode, tiled and whole, timed per backend."""
    import numpy as np

    from nic_torch.cli.image_compression import load_asset
    from nic_torch.config import parse_overrides
    from nic_torch.train.ntc import NTCTrainer

    ref = dict(np.load(REF))
    run = _cli_train(FOLDED, decode=False)
    res, losses = run["res"], run["losses"]
    tiled = [ln for ln in run["decode_gates"] if "tiled (" in ln]
    print(f"phase 25: TRAIN_FORWARD=folded DECODE_BACKEND=xla DIV_SIZE=6 "
          f"(mip mode), 200 epochs in {run['wall']:.1f} s of wall time; "
          f"engines {sorted(set(run['engine'].values()))}; launches "
          f"{run['launches']}; decode gates {run['decode_gates'][:3]}; loss "
          f"{losses[0]:.5f} → {losses[-1]:.5f}; mip-0 PSNR "
          f"{res['psnr'][0]:.4f} dB (fixture's JAX run "
          f"{float(ref['psnr'][0]):.4f}), bpp {res['bpp']:.4f}", flush=True)
    if set(run["engine"].values()) != {"folded"}:
        fail(f"folded run: gates {run['gates']}")
    if any(run["launches"].values()):
        fail(f"folded run launched train kernels: {run['launches']}")
    if not tiled or "xla gather" not in tiled[0]:
        fail(f"folded run: no tiled gather decode in {run['decode_gates']}")
    if len(losses) != 200 or not np.isfinite(losses).all():
        fail("folded run: the losses are not 200 finite values")
    if abs(res["psnr"][0] - float(ref["psnr"][0])) > TRAIN_PSNR_DB:
        fail(f"folded run: mip-0 PSNR {res['psnr'][0]:.4f} dB is not within "
             f"{TRAIN_PSNR_DB} dB of {float(ref['psnr'][0]):.4f}")
    track = _track("phase 25", PATH_A + ["MLP_NUM_DTYPE=32"], "folded")
    times = {}
    for backend in ("xla", "fast"):
        cfg = parse_overrides(PATH_A + [f"DECODE_BACKEND={backend}"])
        tr = NTCTrainer(cfg, load_asset(cfg))
        for div in (6, 10):
            times[(backend, div)] = cuda_ms(
                lambda: tr.decode(0, div_size=div), warmup=1, reps=5)
    print("phase 25: mip-0 decode of a mip-mode 512² trainer, tiled "
          "(DIV_SIZE=6: 64 tiles of 64²) vs whole: " + "; ".join(
              f"{b} {'tiled' if d == 6 else 'whole'} {t:.4f} ms"
              for (b, d), t in times.items()), flush=True)
    return dict(psnr=res["psnr"][0], track=track, decode=times)


# ---- widths: every hidden and feature width the gates admit -----------

def _width_counters() -> dict:
    from nic_torch.kernels.decode_fused import decode_kernel_v1
    from nic_torch.kernels.decode_fused_3d import decode_kernel_3d
    from nic_torch.kernels.decode_fused_v2 import (decode_kernel_2d,
                                                   decode_kernel_z1mm)
    from nic_torch.kernels.decode_fused_v3 import mlp_tail

    return {**_train_counters(), "K1": decode_kernel_2d,
            "K2": decode_kernel_z1mm, "K3": decode_kernel_v1, "K4": mlp_tail,
            "K5": decode_kernel_3d}


def _widths_train(device) -> dict:
    """K11 at H = 16, 32; K6, K7 at H = 16, 128, 192 and 256 (the last two
    on mlp_pixel_wide); K12 at m3 PE 8 (F = 133) and F = 205 and at H =
    128; K9 at F = 133 and F = 205 (C = 20) and at H = 192 and 256:
    kernel vs plain (two runs bit-identical) at K11's tolerances. Returns
    K11's padding cost: {H: ms} at 8×256² bf16·poly with noise."""
    import torch

    from nic_torch.kernels import train_fused as k67
    from nic_torch.kernels import train_fused_ff as k11
    from nic_torch.kernels import train_fused_ff3 as k12
    from nic_torch.models.mlp import init_mlp

    gen = torch.Generator(device="cpu").manual_seed(26)
    modes = [(label, cd, gelu, nbits) for label, (cd, gelu) in
             K11_MODES.items() for nbits in (None, 8)]

    def check(tag, names, fn, plain, cd, family, hidden):
        got = _run_twice(tag, fn, (family, hidden, cd))
        errs = _compare(f"{tag} vs plain", names, got, plain(), K11_TOL[cd])
        print(f"phase 26: {tag} vs plain: loss rel {errs['loss']:.2e}, out "
              f"max|Δ| {errs['out']:.2e}, worst grad rel "
              f"{max(e for nm, e in errs.items() if nm not in ('loss', 'out')):.2e}",
              flush=True)
        return got

    pad_ms = {}
    names11 = ("loss", "out", "dw2", "db2", "dw3", "db3", "dpe0", "dpe1",
               "db1", "P_acc", "C1_acc", "dw1e")
    with torch.no_grad():
        for hidden in (16, 32):
            inputs = _k11_inputs(gen, device, 64, 1, hidden=hidden)
            for label, cd, gelu, nbits in modes:
                args, kw = _k11_call(inputs, 64, 1, cd, gelu, nbits)
                check(f"K11 H={hidden} 8×64² f=1 {label} noise="
                      f"{'on' if nbits else 'off'}", names11,
                      lambda: k11.fused_train_ff_kernel(*args, **kw),
                      lambda: k11.fused_train_ff_plain(*args, **kw), cd,
                      "train_ff", hidden)
        for hidden in (16, 32, 64):
            inputs = _k11_inputs(gen, device, 256, 4, hidden=hidden)
            args, kw = _k11_call(inputs, 256, 4, "bf16", "poly", 8)
            pad_ms[hidden] = cuda_ms(
                lambda: k11.fused_train_ff_kernel(*args, **kw))
        print("phase 26: K11 at 8×256² f=4 bf16·poly noise=on by hidden "
              "width (16 and 32 zero-padded to 64): " + ", ".join(
                  f"H={h} {ms:.4f} ms" for h, ms in pad_ms.items()),
              flush=True)

        names67 = ("loss", "out", "dw1", "db1", "dw2", "db2", "dw3", "db3",
                   "P_acc", "C1_acc")
        names6 = ("loss", "out", "dx", "dw1", "db1", "dw2", "db2", "dw3",
                  "db3")
        for hidden in (16, 128, 192, 256):
            fp, weights, x, tgt, origins = _gather_inputs(
                gen, device, 64, 1.0, True, hidden=hidden)
            geo = dict(g0_nodes=tuple(fp[0].shape[1:]),
                       g1_nodes=tuple(fp[1].shape[1:]))
            _, weights6, x6, tgt6, _ = _gather_inputs(gen, device, 32, 2.0,
                                                      True, hidden=hidden)
            for label, (cd, gelu) in K11_MODES.items():
                cdt = None if cd == "fp32" else torch.bfloat16
                kw = dict(n=64, f=1, gelu=gelu, cd=cdt, **geo)
                check(f"K7 H={hidden} 8×64² f=1 {label}", names67,
                      lambda: k67.fused_mlp_loss_ng_kernel(
                          x, tgt, origins, *weights, **kw),
                      lambda: k67.fused_mlp_loss_ng_plain(
                          x, tgt, origins, *weights, **kw), cd,
                      "train_mlp", hidden)
                check(f"K6 H={hidden} 8×32² {label}", names6,
                      lambda: k67.fused_mlp_loss_kernel(
                          x6, tgt6, *weights6, gelu=gelu, cd=cdt),
                      lambda: k67.fused_mlp_loss_plain(
                          x6, tgt6, *weights6, gelu=gelu, cd=cdt), cd,
                      "train_mlp", hidden)
        # F = 413 (C = 80): x and W1 past the 384 features the tensor-core
        # body stages at once, so it takes them in two chunks; 200 rows
        # leave the second tile's last warps partly empty
        x6 = torch.rand(200, 413, generator=gen).to(device) * 2.0 - 1.0
        tgt6 = torch.rand(200, 3, generator=gen).to(device)
        mlp6 = init_mlp(gen, 413, 64, 3, device=device)
        weights6 = [mlp6[k].detach() for k in NAMES]
        for label, (cd, gelu) in K11_MODES.items():
            cdt = None if cd == "fp32" else torch.bfloat16
            check(f"K6 F=413 N=200 {label}", names6,
                  lambda: k67.fused_mlp_loss_kernel(
                      x6, tgt6, *weights6, gelu=gelu, cd=cdt),
                  lambda: k67.fused_mlp_loss_plain(
                      x6, tgt6, *weights6, gelu=gelu, cd=cdt), cd,
                  "train_mlp", 64)

        names12 = ("loss", "out", "dw2", "db2", "dw3", "db3", "dpe0", "dpe1",
                   "dpe2", "db1", "P_acc", "C1_acc", "dw1e")
        n, f = 16, 2
        for c, pe, hidden in ((12, 8, 64), (20, 8, 64), (12, 8, 128)):
            fp, weights, tgt, origins, seed = _inputs3(
                gen, device, n, f, False, c=c, pe=pe, hidden=hidden)
            feat = weights[0].shape[0]
            x = _gather3(fp, origins, n, f, False, device, pe=pe)
            geo = dict(g0_nodes=tuple(fp[0].shape[1:]),
                       g1_nodes=tuple(fp[1].shape[1:]))
            for label, cd, gelu, nbits in modes:
                cdt = None if cd == "fp32" else torch.bfloat16
                vols = k12.fold_volumes(fp[0], fp[1], weights[0], False, cdt)
                args = (*vols, *weights, tgt, origins, seed)
                kw = dict(n=n, f=f, npe=pe, lodf=0.0, sparse_g0=False,
                          use_tri_pe=True, cd=cdt, gelu=gelu, nbits=nbits)
                check(f"K12 H={hidden} F={feat} 8×{n}³ f={f} m3 {label} "
                      f"noise={'on' if nbits else 'off'}", names12,
                      lambda: k12.fused_train_ff3_kernel(*args, **kw),
                      lambda: k12.fused_train_ff3_plain(*args, **kw), cd,
                      "train_ff3", hidden)
                if nbits is None and hidden == 64:
                    kw9 = dict(n=n, f=f, gelu=gelu, cd=cdt, **geo)
                    check(f"K9 F={feat} 8×{n}³ f={f} m3 {label}", names67,
                          lambda: k67.fused_mlp_loss_ng3_kernel(
                              x, tgt, origins, *weights, **kw9),
                          lambda: k67.fused_mlp_loss_ng_plain(
                              x, tgt, origins, *weights, **kw9), cd,
                          "train_mlp", hidden)
        # K9 past H = 128 (mlp_pixel_wide; K12's gate refuses these widths)
        for hidden in (192, 256):
            fp, weights, tgt, origins, _ = _inputs3(gen, device, n, f, False,
                                                    hidden=hidden)
            x = _gather3(fp, origins, n, f, False, device)
            geo = dict(g0_nodes=tuple(fp[0].shape[1:]),
                       g1_nodes=tuple(fp[1].shape[1:]))
            for label, (cd, gelu) in K11_MODES.items():
                cdt = None if cd == "fp32" else torch.bfloat16
                kw9 = dict(n=n, f=f, gelu=gelu, cd=cdt, **geo)
                check(f"K9 H={hidden} 8×{n}³ f={f} m3 {label}", names67,
                      lambda: k67.fused_mlp_loss_ng3_kernel(
                          x, tgt, origins, *weights, **kw9),
                      lambda: k67.fused_mlp_loss_ng_plain(
                          x, tgt, origins, *weights, **kw9), cd,
                      "train_mlp", hidden)
    _body_summary(26)
    return pad_ms


def _widths_decode(device) -> dict:
    """K1, K2, K3, K4 (2D, 512² random models) and K5 (a 64³ m3 mip-mode
    model) at H = 16, 32 (zero-padded to 64), 128, 192 and 256, against
    their plain versions at the decode tolerances; at 192 and 256 every
    cell's body by the launch log and the profiler (the wide bodies, and
    decode_v2_mma for K1/K5), at 16 K1's and K5's (their CUDA-core
    body), and K2's, K3's and K4's at every width (decode_z1mm_mma from
    16 and decode_v1_mma and mlp_tail_mma from 32 to 128). Returns K1's
    times at 2048²: fp32·exact
    by H (32 zero-padded to 64), and H = 16 on its CUDA-core body beside
    the same model zero-padded to 64 onto decode_v2_mma, in fp32·exact and
    bf16·poly; and K3's and K4's at H = 16 on their CUDA-core bodies
    beside padding to 64 onto their tensor-core bodies, in fp32 and
    bf16."""
    import torch

    from nic_torch.grids.fastdecode import first_layer_acc
    from nic_torch.grids.pyramid import pyramid_mip_levels
    from nic_torch.kernels import decode_fused as k3
    from nic_torch.kernels import decode_fused_3d as k5
    from nic_torch.kernels import decode_fused_v2 as k1
    from nic_torch.kernels import decode_fused_v3 as k4
    from nic_torch.kernels._widths import pad_hidden, pad_mlp

    modes = (("fp32", None, "exact"), ("bf16", torch.bfloat16, "poly"),
             ("i16", "i16", "tanherf"), ("surgical", "surgical", "exact"))
    worst = {}

    def hold(tag, mode, fn, want, body=None):
        """``fn()`` against ``want``; with ``body`` (family, hidden, mode)
        under :func:`_check_body`."""
        got = _check_body(tag, fn, *body) if body else fn()
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"{tag}: shape {tuple(got.shape)} or non-finite values")
        err = float((got - want).abs().max())
        worst[tag.split(" ")[0]] = max(worst.get(tag.split(" ")[0], 0.0), err)
        if err > TOL[mode]:
            fail(f"{tag} vs plain: max|Δ| {err:.3e} > {TOL[mode]:.0e}")

    gen3 = torch.Generator(device="cpu").manual_seed(27)
    m2l3 = pyramid_mip_levels(64, 16, False)
    with torch.inference_mode():
        for hidden in (16, 32, 128, 192, 256):
            wide = hidden > 128  # these cells' bodies are checked
            v2 = wide or hidden == 16  # and K1's and K5's at H = 16
            fp, mlp, m2l = _random_flagship(device, 512, hidden)
            for mip in (0, 1, 2):
                for mode, dtype, gelu in modes:
                    pc, c1v, pe_u, w2, b2, w3, b3, s, geom = k1._prepare_2d(
                        fp, mlp, mip, image_size=512, mip_to_level=m2l,
                        pe_channels=6, use_tri_pe=True, dtype=dtype)
                    g = dict(f=geom["f"], f1=geom["f1"], gelu=gelu)
                    args = (pc, c1v, pe_u, w2, b2, w3, b3)
                    tag = f"H={hidden} mip {mip} {mode}·{gelu}"
                    hold(f"K1 {tag}", mode,
                         lambda: k1.decode_kernel_2d(*args, s, **g),
                         k1.decode_kernel_2d_plain(*args, s, **g),
                         ("decode_v2", hidden, mode) if v2 else None)
                    if mode != "i16":
                        hold(f"K2 {tag}", mode,
                             lambda: k1.decode_kernel_z1mm(*args, R=geom["R"],
                                                           **g),
                             k1.decode_kernel_z1mm_plain(*args, R=geom["R"],
                                                         **g),
                             ("decode_z1mm", hidden, mode))
                for mode, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
                    vargs, vkw = _v1_args(fp, mlp, mip, m2l, 512, dtype)
                    hold(f"K3 H={hidden} mip {mip} {mode}", mode,
                         lambda: k3.decode_kernel_v1(*vargs, use_tri_pe=True,
                                                     **vkw),
                         k3.decode_kernel_v1_plain(*vargs, use_tri_pe=True,
                                                   **vkw),
                         ("decode_v1", hidden, mode))
            acc = first_layer_acc(fp, mlp, 0, image_size=512,
                                  mip_to_level=m2l, pe_channels=6,
                                  use_tri_pe=True).contiguous()
            for mode, dtype in (("fp32", torch.float32),
                                ("bf16", torch.bfloat16)):
                args = (acc.to(dtype), mlp["w2"].to(dtype), mlp["b2"],
                        mlp["w3"].to(dtype), mlp["b3"])
                hold(f"K4 H={hidden} {mode}", mode,
                     lambda: k4.mlp_tail(*args), k4.mlp_tail_plain(*args),
                     ("decode_v3", hidden, mode))
            fp3, mlp3 = _pyramid3(gen3, device, 64, False, no_mip=False,
                                  hidden=hidden)
            for mip in (0, 1):
                for mode, dtype, gelu in modes:
                    pc, c1v, pe_u, w2, b2, w3, b3, s, geom = k5._prepare_3d(
                        fp3, mlp3, mip, image_size=64, mip_to_level=m2l3,
                        pe_channels=6, use_tri_pe=True, sparse_g0=False,
                        dtype=dtype)
                    g = dict(f=geom["f"], f1=geom["f1"], gelu=gelu)
                    args = (pc, c1v, pe_u, w2, b2, w3, b3, s)
                    hold(f"K5 H={hidden} mip {mip} {mode}·{gelu}", mode,
                         lambda: k5.decode_kernel_3d(*args, **g),
                         k5.decode_kernel_3d_plain(*args, **g),
                         ("decode_v2", hidden, mode) if v2 else None)
        print("phase 26: decodes at H = 16, 32 (padded to 64), 128, 192 and "
              "256 vs plain, worst max|Δ| (fp32 and reduced modes together): "
              + ", ".join(f"{nm} {e:.3e}" for nm, e in sorted(worst.items())),
              flush=True)
        _body_summary(26)
        pad_ms = {}
        for hidden in (32, 64):
            fp, mlp, m2l = _random_flagship(device, 2048, hidden)
            pc, c1v, pe_u, w2, b2, w3, b3, s, geom = k1._prepare_2d(
                fp, mlp, 0, image_size=2048, mip_to_level=m2l, pe_channels=6,
                use_tri_pe=True, dtype=None)
            g = dict(f=geom["f"], f1=geom["f1"], gelu="exact")
            pad_ms[hidden] = cuda_ms(lambda: k1.decode_kernel_2d(
                pc, c1v, pe_u, w2, b2, w3, b3, s, **g))
        print("phase 26: K1 at 2048² fp32·exact by hidden width (32 "
              "zero-padded to 64, planes copied): " + ", ".join(
                  f"H={h} {ms:.4f} ms" for h, ms in pad_ms.items()),
              flush=True)
        # H = 16 on its CUDA-core body, and the same model through the
        # zero padding onto decode_v2_mma (the wrapper's path were 16 not
        # a built width): what the second body saves
        fp, mlp, m2l = _random_flagship(device, 2048, 16)
        for mode, dtype, gelu in (("fp32", None, "exact"),
                                  ("bf16", torch.bfloat16, "poly")):
            pc, c1v, pe_u, w2, b2, w3, b3, s, geom = k1._prepare_2d(
                fp, mlp, 0, image_size=2048, mip_to_level=m2l, pe_channels=6,
                use_tri_pe=True, dtype=dtype)
            args = (pc, c1v, pe_u, w2, b2, w3, b3, s)
            g = dict(f=geom["f"], f1=geom["f1"], gelu=gelu)
            own = cuda_ms(lambda: k1.decode_kernel_2d(*args, **g))
            padded = cuda_ms(lambda: k1._padded_planes(
                k1.decode_kernel_2d, 64, *args, **g))
            pad_ms[(16, mode)] = (own, padded)
            print(f"phase 26: K1 at 2048² H=16 {mode}·{gelu}: "
                  f"{_want_body('decode_v2', 16, mode)} {own:.4f} ms, "
                  f"zero-padded to 64 on {_want_body('decode_v2', 64, mode)} "
                  f"{padded:.4f} ms (planes copied)", flush=True)
        # K3 and K4 likewise: H = 16 on their CUDA-core bodies against the
        # same model's weights (and K4's accumulator) zero-padded to 64
        # ahead of the call, onto their tensor-core bodies
        acc = first_layer_acc(fp, mlp, 0, image_size=2048, mip_to_level=m2l,
                              pe_channels=6, use_tri_pe=True).contiguous()
        for mode, dtype in (("fp32", torch.float32),
                            ("bf16", torch.bfloat16)):
            vargs, vkw = _v1_args(fp, mlp, 0, m2l, 2048,
                                  None if mode == "fp32" else dtype)
            padv = (*vargs[:2], *pad_mlp(*vargs[2:], 64))
            k3_own = cuda_ms(lambda: k3.decode_kernel_v1(
                *vargs, use_tri_pe=True, **vkw))
            k3_pad = cuda_ms(lambda: k3.decode_kernel_v1(
                *padv, use_tri_pe=True, **vkw))
            targs = (acc.to(dtype), mlp["w2"].to(dtype), mlp["b2"],
                     mlp["w3"].to(dtype), mlp["b3"])
            padt = (pad_hidden(targs[0], 64),
                    *pad_mlp(None, None, *targs[1:], 64)[2:])
            k4_own = cuda_ms(lambda: k4.mlp_tail(*targs))
            k4_pad = cuda_ms(lambda: k4.mlp_tail(*padt))
            pad_ms[("K3", mode)] = (k3_own, k3_pad)
            pad_ms[("K4", mode)] = (k4_own, k4_pad)
            print(f"phase 26: at 2048² H=16 {mode}: K3 "
                  f"{_want_body('decode_v1', 16, mode)} {k3_own:.4f} ms, "
                  f"zero-padded to 64 on {_want_body('decode_v1', 64, mode)} "
                  f"{k3_pad:.4f} ms; K4 ({mode} accumulator and dots) "
                  f"{_want_body('decode_v3', 16, mode)} {k4_own:.4f} ms, "
                  f"zero-padded to 64 on {_want_body('decode_v3', 64, mode)} "
                  f"{k4_pad:.4f} ms", flush=True)
    return pad_ms


def phase_widths(device) -> dict:
    """Every kernel at the widths its gate admits beyond the flagship's:
    each must launch (counter > 0) and agree with its plain version."""
    counters = _width_counters()
    for c in counters.values():
        c.launches = 0
    pad = {"K11": _widths_train(device), "K1": _widths_decode(device)}
    # node_windows past the flagship's width (K7's wide bodies' dz1)
    for hidden in (192, 256):
        _rest_alone(26, device, hidden, ((127, 4), (63, 2), (31, 1)), ())
    launches = {k: c.launches for k, c in counters.items()}
    print(f"phase 26: launches {launches}", flush=True)
    if not all(launches.values()):
        fail(f"phase 26: a kernel never launched: {launches}")
    return pad


# HIDDEN_LAYER_CHANNELS=16 (the JAX suite's small model) trains on K11 at
# every step; H = 32 also decodes through K1 zero-padded to 64; at H = 256
# kernel3's gate refuses (2H > 128), so every step runs K7 on
# mlp_pixel_wide, and the decode runs decode_v2_mma's wide path
SMALL_EPOCHS = 50
WIDE_HIDDEN = 256


def _wide_cli(args) -> None:
    """The flagship CLI at H = WIDE_HIDDEN under TRAIN_FORWARD=auto: K7 on
    every step (kernel2 at every LOD), the decode CLI at mips 0-9 with 3 K1
    launches, each mip within TRAIN_PSNR_DB of a TRAIN_FORWARD=gather run
    of the same configuration (PSNR of the decode against the image's
    mip)."""
    import numpy as np

    from nic_torch.config import parse_overrides
    from nic_torch.data.assets import load_image_mips

    run = _cli_train(args)
    gather = _cli_train(args + ["TRAIN_FORWARD=gather"])
    cfg = parse_overrides(args)
    ref = load_image_mips(cfg.image_path, cfg.image_size, 9)

    def psnrs(recs):
        out = []
        for mip, rec in enumerate(recs):
            want = np.moveaxis(np.asarray(ref[mip], np.float64), 0, -1)
            mse = float(np.mean((np.asarray(rec, np.float64) - want) ** 2))
            out.append(10.0 * np.log10(1.0 / max(mse, 1e-12)))
        return out

    got, base = psnrs(run["recs"]), psnrs(gather["recs"])
    print(f"phase 27: training CLI at H={WIDE_HIDDEN}, {SMALL_EPOCHS} epochs "
          f"in {run['wall']:.1f} s (gather {gather['wall']:.1f} s); launches "
          f"{run['launches']}; loss {run['losses'][0]:.5f} → "
          f"{run['losses'][-1]:.5f}; decode CLI mips 0-9, K1 launches "
          f"{run['k1']}; PSNR by mip (dB) " + ", ".join(
              f"{m}: {a:.3f} vs gather {b:.3f}"
              for m, (a, b) in enumerate(zip(got, base))), flush=True)
    for line in run["gates"]:
        print(f"phase 27: H={WIDE_HIDDEN} {line}", flush=True)
    if set(run["engine"].values()) != {"kernel2"}:
        fail(f"H={WIDE_HIDDEN}: the gate log does not name kernel2 at every "
             f"LOD: {run['engine']}")
    if run["launches"] != {"K11": 0, "K6": 0, "K7": SMALL_EPOCHS, "K12": 0,
                           "K9": 0}:
        fail(f"H={WIDE_HIDDEN}: launches {run['launches']}, want K7 "
             f"{SMALL_EPOCHS}")
    if not np.isfinite(run["losses"]).all():
        fail(f"H={WIDE_HIDDEN}: non-finite losses")
    _check_decodes(f"H={WIDE_HIDDEN}", run, no_mip=True)
    if run["k1"] != 3:
        fail(f"H={WIDE_HIDDEN}: K1 launched {run['k1']} times, want 3")
    far = [m for m, (a, b) in enumerate(zip(got, base))
           if abs(a - b) > TRAIN_PSNR_DB]
    if far:
        fail(f"H={WIDE_HIDDEN}: mips {far} decode more than {TRAIN_PSNR_DB} "
             f"dB from the gather run's")


def phase_small_cli(device) -> None:
    """Short CLI runs at H = 16 and 32 under TRAIN_FORWARD=auto: kernel3 at
    every step, then the decode CLI at mips 0-9; then H = WIDE_HIDDEN
    (:func:`_wide_cli`)."""
    import numpy as np

    for hidden in (16, 32):
        run = _cli_train([f"NUM_EPOCHS={SMALL_EPOCHS}", "SDC_GUARD_TRAIN=False",
                          f"HIDDEN_LAYER_CHANNELS={hidden}"])
        got = run["launches"]
        print(f"phase 27: training CLI at H={hidden}, {SMALL_EPOCHS} epochs "
              f"in {run['wall']:.1f} s; gates {sorted(run['engine'].items())};"
              f" launches {got}; loss {run['losses'][0]:.5f} → "
              f"{run['losses'][-1]:.5f}; mip-0 PSNR "
              f"{run['res']['psnr'][0]:.4f} dB; decode CLI mips 0-9, K1 "
              f"launches {run['k1']}", flush=True)
        if run["engine"] != {(0, False): "kernel3", (0, True): "kernel3"}:
            fail(f"H={hidden}: the gate log does not name kernel3 in both "
                 f"phases: {run['gates']}")
        if got["K11"] != SMALL_EPOCHS:
            fail(f"H={hidden}: K11 launched {got['K11']} times in "
                 f"{SMALL_EPOCHS} epochs")
        if not np.isfinite(run["losses"]).all():
            fail(f"H={hidden}: non-finite losses")
        _check_decodes(f"H={hidden}", run, no_mip=True)
    _wide_cli([f"NUM_EPOCHS={SMALL_EPOCHS}", "SDC_GUARD_TRAIN=False",
               f"HIDDEN_LAYER_CHANNELS={WIDE_HIDDEN}"])
    _profile_dir_run()


def _profile_dir_run() -> None:
    """A 20-epoch flagship CLI run with PROFILE_DIR (two chunks of
    INTERVAL_PRINT=10): the trace of the second chunk must be written, its
    log line name the directory, and its device kernels name K11's body
    ``ff_pixel_mma``. A trace that holds no K11 body (the card's profiler
    now and then loses a window's kernels) is taken again, up to
    BODY_TRIES runs."""
    import glob

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for attempt in range(BODY_TRIES):
            prof = os.path.join(tmp, str(attempt))
            run = _cli_train(["NUM_EPOCHS=20", "SDC_GUARD_TRAIN=False",
                              "INTERVAL_PRINT=10", f"PROFILE_DIR={prof}"],
                             decode=False)
            files = glob.glob(os.path.join(prof, "*.pt.trace.json"))
            if len(files) != 1 or run["launches"]["K11"] != 20:
                fail(f"PROFILE_DIR: traces {files}, K11 launches "
                     f"{run['launches']['K11']} (want one trace, 20)")
            if not any(prof in ln for ln in run["trace_lines"]):
                fail(f"PROFILE_DIR: no log line names {prof}: "
                     f"{run['trace_lines']}")
            with open(files[0]) as fh:
                events = json.load(fh)["traceEvents"]
            kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
            mma = sum(_is_body("ff_pixel_mma", nm) for nm in kernels)
            print(f"phase 27: PROFILE_DIR run {attempt + 1}: "
                  f"{run['trace_lines'][0]}; {os.path.getsize(files[0])} "
                  f"bytes, {len(kernels)} device kernels, ff_pixel_mma "
                  f"{mma} times", flush=True)
            if mma:
                return
    fail(f"PROFILE_DIR: no trace of {BODY_TRIES} runs named ff_pixel_mma")


# the Kodak geometry: 512 rows × 768 columns (sancho resized), the
# flagship's widths; the portrait case 768 × 512; the rectangular paths'
# short runs
RECT_HW = (512, 768)
RECT = ["IMAGE_SIZE=512", "IMAGE_SIZE_W=768"]
RECT_EPOCHS = 50
RECT_SHORT = [f"NUM_EPOCHS={RECT_EPOCHS}", "SDC_GUARD_TRAIN=False"]
RECT_ARGS = TRAIN_ARGS + RECT


def _rect_inputs(gen, device, n, f, tri_pe, hw=RECT_HW, crops=8):
    """A random flagship-width no-mip pyramid on an (H, W) image (G0 [12,
    H/4 + 1, W/4 + 1]) and MLP, and crops of n² on the LOD image of
    (H·f/4, W·f/4): crop 0 at the last row and last column, crop 1 at the
    last row and column 0, crop 2 at row 0 and the last column, the rest
    random. → (fp, weights, planes by dot type (K11's folds), x (the
    gather, ``tri_pe``), tgt, origins, seed words)."""
    import torch

    from nic_torch.grids.pyramid import create_pyramid
    from nic_torch.grids.sample import decoder_input
    from nic_torch.kernels.train_fused_ff import fold_planes
    from nic_torch.models.mlp import init_mlp

    fp, _ = create_pyramid(gen, tuple(s // 4 for s in hw), 12, 8,
                           device=device, no_mip=True)
    mlp = init_mlp(gen, 12 * 5 + 2 * 6 + 1, 64, 3, device=device)
    img = [s * f // 4 for s in hw]
    origins = torch.stack([torch.randint(0, d - n + 1, (crops,),
                                         generator=gen) for d in img], 1)
    origins[:3] = torch.tensor([[img[0] - n, img[1] - n], [img[0] - n, 0],
                                [0, img[1] - n]])
    tgt = torch.rand(crops * n * n, 3, generator=gen).to(device)
    words = torch.randint(-2**31, 2**31, (2,), generator=gen)
    seed = torch.cat([words, torch.zeros(2, dtype=torch.int64)]).to(
        torch.int32)
    planes = {cd: fold_planes(fp[0], fp[1], mlp["w1"],
                              None if cd == "fp32" else torch.bfloat16)
              for cd in ("fp32", "bf16")}
    x = decoder_input(fp, 0, origins.to(device), 1.0 / f, n, pe_channels=6,
                      mip_level=0, use_tri_pe=tri_pe).reshape(crops * n * n,
                                                              -1)
    weights = [mlp[k].detach() for k in NAMES]
    return fp, weights, planes, x.contiguous(), tgt, origins, seed


def _rect_kernels(device) -> None:
    """(a) K11 and K7 on 512×768 planes at 8 crops of 256² (f = 4), crops
    on the last row and the last column, against their plain versions at
    phases 6 and 7's limits, fp32·erf and bf16·poly (K11 with QAT noise
    off and on)."""
    import torch

    from nic_torch.kernels import train_fused as k7
    from nic_torch.kernels import train_fused_ff as k11

    n, f = 256, 4
    gen = torch.Generator(device="cpu").manual_seed(28)
    k11_names = ("loss", "out", "dw2", "db2", "dw3", "db3", "dpe0", "dpe1",
                 "db1", "P_acc", "C1_acc", "dw1e")
    k7_names = ("loss", "out", "dw1", "db1", "dw2", "db2", "dw3", "db3",
                "dG0", "dG1")
    with torch.no_grad():
        _, weights, planes, _, tgt, origins, seed = _rect_inputs(
            gen, device, n, f, True)
        for label, (cd, gelu) in K11_MODES.items():
            for nbits in (None, 8):
                args = (*planes[cd], *weights, tgt, origins, seed)
                kw = dict(n=n, f=f, npe=6, lodf=0.0, gelu=gelu, nbits=nbits,
                          cd=None if cd == "fp32" else torch.bfloat16)
                cell = (f"K11 512×768 8×256² {label} noise="
                        f"{'on' if nbits else 'off'}")
                got = k11.fused_train_ff_kernel(*args, **kw)
                want = k11.fused_train_ff_plain(*args, **kw)
                errs = _compare(cell, k11_names, got, want, K11_TOL[cd])
                worst = max(e for m, e in errs.items()
                            if m not in ("loss", "out"))
                print(f"phase 28: {cell} vs plain: loss rel "
                      f"{errs['loss']:.2e}, out max|Δ| {errs['out']:.2e}, "
                      f"worst grad/plane rel {worst:.2e} (origins "
                      f"{origins[:3].tolist()} among 8)", flush=True)
        fp, weights, _, x, tgt, origins, _ = _rect_inputs(gen, device, n, f,
                                                          False)
        geo = dict(g0_nodes=tuple(fp[0].shape[1:]),
                   g1_nodes=tuple(fp[1].shape[1:]))

        def unfolded(res):
            dg = k7._unfold_node_grads(res[8], res[9], weights[0],
                                       channels=12, **geo)
            return tuple(res[:8]) + dg

        for label, (cd, gelu) in K11_MODES.items():
            kw = dict(n=n, f=f, gelu=gelu,
                      cd=None if cd == "fp32" else torch.bfloat16, **geo)
            args = (x, tgt, origins, *weights)
            cell = f"K7 512×768 8×256² {label}"
            got = k7.fused_mlp_loss_ng_kernel(*args, **kw)
            want = k7.fused_mlp_loss_ng_plain(*args, **kw)
            errs = _compare(cell, k7_names, unfolded(got), unfolded(want),
                            K11_TOL[cd])
            print(f"phase 28: {cell} vs plain: loss rel {errs['loss']:.2e}, "
                  f"out max|Δ| {errs['out']:.2e}, MLP grads rel ≤ "
                  f"{max(errs[m] for m in k7_names[2:8]):.2e}, dG0 "
                  f"{errs['dG0']:.2e}, dG1 {errs['dG1']:.2e} (nodes "
                  f"{geo['g0_nodes']}, {geo['g1_nodes']})", flush=True)


def _rect_fold(hw, with_k2: bool, device):
    """``keep`` for :func:`_cli_train`: the run's artifact decoded by the
    plain fold (``fast_decode(n=(H, W))``) at each mip the decode CLI
    decoded, held to those decodes (u8 LSB ≤ LSB_FP32; mip-0 PSNR against
    the mip-0 image within PSNR_DB of the fold's); then (``with_k2``) K2
    (``z1_matmul`` True) against its plain version at mips 0-2 in three
    plane modes, and ``"auto"`` serving mips 0-9 (K2 launches counted, K1
    none) against the fold. → (LSB per mip, PSNR, fold PSNR, K2 worst
    errors, K2 and K1 launches of the "auto" serve)."""
    import numpy as np
    import torch

    from nic_torch.core.metrics import psnr
    from nic_torch.data.assets import load_image_mips
    from nic_torch.grids.fastdecode import fast_decode
    from nic_torch.grids.pyramid import pyramid_mip_levels
    from nic_torch.io.artifacts import load_compressed
    from nic_torch.kernels import decode_fused_v2 as k

    def hold(run):
        mlp, fp, meta = load_compressed(run["res"]["artifact"],
                                        device=device)
        if meta["config"]["image_size_w"] != hw[1]:
            fail(f"{hw}: the artifact's image_size_w is "
                 f"{meta['config']['image_size_w']}")
        mlp = {name: mlp[name].detach() for name in NAMES}
        m2l = pyramid_mip_levels(hw[0], fp[0].shape[1] - 1,
                                 meta["config"]["tf_no_mip"])
        kw = dict(mip_to_level=m2l, pe_channels=6)
        with torch.inference_mode():
            folds = [fast_decode(fp, mlp, mip, image_size=hw[0],
                                 n=tuple(s >> mip for s in hw),
                                 **kw).cpu().numpy()
                     for mip in range(len(run["recs"]))]
        lsb = []
        for mip, (rec, fold) in enumerate(zip(run["recs"], folds)):
            if rec.shape != (hw[0] >> mip, hw[1] >> mip, 3) or \
                    not np.isfinite(rec).all():
                fail(f"{hw}: decode CLI mip {mip}: shape {rec.shape} or "
                     "non-finite")
            lsb.append(int(np.abs(u8(rec) - u8(fold)).max()))
        orig = torch.from_numpy(np.moveaxis(load_image_mips(
            os.path.join(ROOT, "data", "sancho_512.png"), hw[0], 0,
            image_size_w=hw[1])[0], 0, -1) * 255.0).double()
        p0, pf = (float(psnr(orig, torch.from_numpy(u8(r)).double()))
                  for r in (run["recs"][0], folds[0]))
        if max(lsb) > LSB_FP32 or abs(p0 - pf) > PSNR_DB:
            fail(f"{hw}: decode CLI vs the fold: u8 LSB {lsb} (bar "
                 f"{LSB_FP32}), mip-0 PSNR {p0:.4f} vs {pf:.4f} dB")
        if not with_k2:
            return lsb, p0, pf, None, None
        worst = {}
        with torch.inference_mode():
            for mip in (0, 1, 2):
                for mode, dtype, gelu in (
                        ("fp32", None, "exact"),
                        ("bf16", torch.bfloat16, "poly"),
                        ("surgical", "surgical", "exact")):
                    pc, c1v, pe_u, w2, b2, w3, b3, _, geom = k._prepare_2d(
                        fp, mlp, mip, image_size=hw, use_tri_pe=True,
                        dtype=dtype, **kw)
                    if not geom["packed"]:
                        fail(f"{hw} mip {mip}: JAX's auto would not take K2")
                    args = (pc, c1v, pe_u, w2, b2, w3, b3)
                    g = dict(f=geom["f"], f1=geom["f1"], R=geom["R"],
                             gelu=gelu)
                    got = k.decode_kernel_z1mm(*args, **g)
                    want = k.decode_kernel_z1mm_plain(*args, **g)
                    if got.shape != (hw[0] >> mip, hw[1] >> mip, 3) or \
                            not torch.isfinite(got).all():
                        fail(f"K2 {hw} mip {mip} {mode}: shape "
                             f"{tuple(got.shape)} or non-finite")
                    err = float((got - want).abs().max())
                    worst[mode] = max(worst.get(mode, 0.0), err)
                    if err > TOL[mode]:
                        fail(f"K2 {hw} mip {mip} {mode}·{gelu}: max|Δ| vs "
                             f"plain {err:.3e} > {TOL[mode]:.0e}")
            k.decode_kernel_z1mm.launches = k.decode_kernel_2d.launches = 0
            auto = [k.decode_image_fused_v2(
                fp, mlp, mip, image_size=hw, z1_matmul="auto",
                **kw).cpu().numpy() for mip in range(len(folds))]
            served = (k.decode_kernel_z1mm.launches,
                      k.decode_kernel_2d.launches)
        auto_lsb = [int(np.abs(u8(a) - u8(b)).max())
                    for a, b in zip(auto, folds)]
        if served != (3, 0) or max(auto_lsb) > LSB_FP32:
            fail(f"{hw} z1_matmul='auto' over mips 0-9: K2 {served[0]}, K1 "
                 f"{served[1]} launches (want 3, 0); u8 LSB vs the fold "
                 f"{auto_lsb}")
        return lsb, p0, pf, worst, served

    return hold


def _rect_covered(hw, no_mip: bool) -> int:
    """The mips 0-9 that K1's gate covers for an (H, W) artifact."""
    from nic_torch.grids.pyramid import pyramid_mip_levels
    from nic_torch.kernels.decode_fused_v2 import kernel_covers_2d

    # the decode CLI's map: its base is G0's axis 0, as in JAX's runtime
    m2l = pyramid_mip_levels(hw[0], hw[0] // 4, no_mip)
    return sum(kernel_covers_2d(mip, hw, m2l, 64) for mip in range(10))


def _rect_runs(device) -> dict:
    """(b)-(d): the training CLI at 512×768, flagship 200 epochs (K11 at
    every step, mip-0 PSNR within TRAIN_PSNR_DB of a gather run), its
    artifact through the decode CLI at mips 0-9 (K1 where covered, held to
    the fold) and K2; path A and path B, RECT_EPOCHS epochs each; the
    portrait 768×512, RECT_EPOCHS kernel3 epochs and a mip-0 K1 decode
    against the fold; then ``eval_rd --native-geometry``
    (:func:`_rect_eval_rd`)."""
    import numpy as np

    flag = _cli_train(RECT_ARGS, keep=_rect_fold(RECT_HW, True, device))
    gather = _cli_train(RECT_ARGS + ["TRAIN_FORWARD=gather"], decode=False)
    lsb, p0, pf, k2_worst, k2_served = flag["kept"]
    res = flag["res"]
    print(f"phase 28: 512×768 flagship, 200 epochs in {flag['wall']:.1f} s "
          f"(gather {gather['wall']:.1f} s); gates "
          f"{sorted(flag['engine'].items())}; launches {flag['launches']}; "
          f"loss {flag['losses'][0]:.5f} → {flag['losses'][-1]:.5f}; mip-0 "
          f"PSNR {res['psnr'][0]:.4f} dB vs gather "
          f"{gather['res']['psnr'][0]:.4f}; bpp {res['bpp']:.4f}; decode CLI "
          f"mips 0-9 shapes {[r.shape[:2] for r in flag['recs']]}, K1 "
          f"launches {flag['k1']}; u8 LSB vs the fold {lsb}, mip-0 PSNR "
          f"{p0:.4f} dB (fold {pf:.4f}); K2 vs plain at mips 0-2 worst "
          + ", ".join(f"{m} {e:.3e}" for m, e in k2_worst.items())
          + f"; 'auto' serve K2 {k2_served[0]}, K1 {k2_served[1]} launches",
          flush=True)
    if flag["engine"] != {(0, False): "kernel3", (0, True): "kernel3"}:
        fail(f"512×768 flagship: gates {flag['gates']}")
    if flag["launches"] != {"K11": 200, "K6": 0, "K7": 0, "K12": 0, "K9": 0}:
        fail(f"512×768 flagship: launches {flag['launches']}, want K11 200")
    if len(flag["losses"]) != 200 or not np.isfinite(flag["losses"]).all():
        fail("512×768 flagship: the losses are not 200 finite values")
    if abs(res["psnr"][0] - gather["res"]["psnr"][0]) > TRAIN_PSNR_DB:
        fail(f"512×768 flagship: mip-0 PSNR {res['psnr'][0]:.4f} dB is not "
             f"within {TRAIN_PSNR_DB} dB of the gather run's "
             f"{gather['res']['psnr'][0]:.4f}")
    if flag["k1"] != _rect_covered(RECT_HW, True):
        fail(f"512×768: the decode CLI launched K1 {flag['k1']} times; it "
             f"covers {_rect_covered(RECT_HW, True)} of mips 0-9")

    args_a = RECT_SHORT + RECT + ["TF_NO_MIP=0"]
    run_a = _cli_train(args_a, keep=_rect_fold(RECT_HW, False, device))
    lods = _lod_sequence(args_a)
    want = {lod: "kernel3" if lod in KERNEL3_LODS else "kernel"
            for lod in set(lods)}
    want_k11 = sum(want[lod] == "kernel3" for lod in lods)
    covered_a = _rect_covered(RECT_HW, False)
    print(f"phase 28: 512×768 path A (TF_NO_MIP=0), {RECT_EPOCHS} epochs in "
          f"{run_a['wall']:.1f} s; gates {sorted(run_a['engine'].items())}; "
          f"launches {run_a['launches']} (want K11 {want_k11}, K6 "
          f"{len(lods) - want_k11}); decode CLI mips 0-9, K1 launches "
          f"{run_a['k1']} (covers {covered_a}), u8 LSB vs the fold "
          f"{run_a['kept'][0]}; mip-0 PSNR {run_a['res']['psnr'][0]:.4f} dB",
          flush=True)
    for (lod, _), engine in run_a["engine"].items():
        if engine != want[lod]:
            fail(f"512×768 path A: LOD {lod} ran {engine}, JAX runs "
                 f"{want[lod]}")
    if run_a["launches"] != {"K11": want_k11, "K6": len(lods) - want_k11,
                             "K7": 0, "K12": 0, "K9": 0} or \
            not 0 < want_k11 < len(lods):
        fail(f"512×768 path A: launches {run_a['launches']}")
    if run_a["k1"] != covered_a or not np.isfinite(run_a["losses"]).all():
        fail(f"512×768 path A: K1 launches {run_a['k1']} (covers "
             f"{covered_a}) or non-finite losses")

    run_b = _cli_train(RECT_SHORT + RECT + ["TF_USE_TRI_PE=0"], mips=(0,))
    print(f"phase 28: 512×768 path B (TF_USE_TRI_PE=0), {RECT_EPOCHS} epochs "
          f"in {run_b['wall']:.1f} s; gates {sorted(run_b['engine'].items())}"
          f"; launches {run_b['launches']}; mip-0 PSNR "
          f"{run_b['res']['psnr'][0]:.4f} dB; K1 launches {run_b['k1']}",
          flush=True)
    if run_b["engine"] != {(0, False): "kernel2", (0, True): "kernel2"} or \
            run_b["launches"] != {"K11": 0, "K6": 0, "K7": RECT_EPOCHS,
                                  "K12": 0, "K9": 0} or \
            run_b["k1"] != 1 or not np.isfinite(run_b["losses"]).all():
        fail(f"512×768 path B: gates {run_b['engine']}, launches "
             f"{run_b['launches']}, K1 {run_b['k1']}")

    portrait = (RECT_HW[1], RECT_HW[0])
    run_p = _cli_train(RECT_SHORT + ["IMAGE_SIZE=768", "IMAGE_SIZE_W=512"],
                       mips=(0,), keep=_rect_fold(portrait, False, device))
    print(f"phase 28: 768×512 portrait, {RECT_EPOCHS} epochs in "
          f"{run_p['wall']:.1f} s; gates {sorted(run_p['engine'].items())}; "
          f"launches {run_p['launches']}; mip-0 PSNR "
          f"{run_p['res']['psnr'][0]:.4f} dB; decode CLI mip 0 "
          f"{run_p['recs'][0].shape}, K1 launches {run_p['k1']}, u8 LSB vs "
          f"the fold {run_p['kept'][0]}, PSNR {run_p['kept'][1]:.4f} dB "
          f"(fold {run_p['kept'][2]:.4f})", flush=True)
    if run_p["engine"] != {(0, False): "kernel3", (0, True): "kernel3"} or \
            run_p["launches"]["K11"] != RECT_EPOCHS or run_p["k1"] != 1:
        fail(f"768×512: gates {run_p['engine']}, launches "
             f"{run_p['launches']}, K1 {run_p['k1']}")
    _rect_eval_rd(device, res["bpp"])
    return dict(k11=flag["launches"]["K11"], k6=run_a["launches"]["K6"],
                k7=run_b["launches"]["K7"], k1=flag["k1"],
                k1_path_a=run_a["k1"])


def _rect_eval_rd(device, want_bpp: float) -> None:
    """``python -m nic_torch.cli.eval_rd --native-geometry`` on the card
    over the two Kodak orientations (sancho resized to 512×768 and
    768×512), RECT_EPOCHS epochs each: K11 at every step, the JAX
    harness's JSON keys, each image's bpp that of the flagship's artifact
    (the same grids and MLP, 8.3575 at FP_BITS 8), finite PSNR."""
    import math

    from PIL import Image

    from nic_torch.cli import eval_rd
    from nic_torch.kernels.train_fused_ff import fused_train_ff_kernel

    src = Image.open(os.path.join(ROOT, "data", "sancho_512.png")).convert(
        "RGB")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        images = os.path.join(tmp, "kodak")
        os.makedirs(images)
        for name, (h, w) in (("landscape.png", RECT_HW),
                             ("portrait.png", RECT_HW[::-1])):
            src.resize((w, h), Image.BILINEAR).save(os.path.join(images,
                                                                 name))
        out = os.path.join(tmp, "rd.json")
        fused_train_ff_kernel.launches = 0
        res = eval_rd.run(["--dir", images, "--native-geometry", "--out", out,
                           "--output_root", tmp, *RECT_SHORT])
        launches = fused_train_ff_kernel.launches
        with open(out) as fh:
            written = json.load(fh)
    rows = res["images"]
    print(f"phase 28: eval_rd --native-geometry on 512×768 and 768×512, "
          f"{RECT_EPOCHS} epochs each: K11 launches {launches}; "
          + "; ".join(f"{r['image']} PSNR {r['psnr']:.4f} dB, bpp "
                      f"{r['bpp']:.4f}" for r in rows)
          + f" (flagship artifact bpp {want_bpp:.4f})", flush=True)
    keys = {"codec", "protocol", "images", "mean_psnr", "mean_bpp", "dir"}
    if written != res or set(res) != keys or \
            res["protocol"]["geometry"] != "native (per-image rectangular)":
        fail(f"eval_rd: keys {sorted(res)}, protocol {res['protocol']}")
    if launches != 2 * RECT_EPOCHS or len(rows) != 2 or any(
            r["bpp"] != want_bpp or not math.isfinite(r["psnr"])
            for r in rows):
        fail(f"eval_rd: K11 launches {launches}, rows {rows}")


def _rect_times(device) -> dict:
    """(e) The 512×768 mip-0 decode end to end and K1's wrapper alone,
    fp32·exact (CUDA events), on a random flagship-width model; the
    LOD-0 kernel3 step (:func:`step_timing`)."""
    import torch

    from nic_torch.grids.pyramid import (create_pyramid, pyramid_mip_levels,
                                         pyramid_quantize_all)
    from nic_torch.kernels import decode_fused_v2 as k
    from nic_torch.models.mlp import init_mlp

    gen = torch.Generator(device="cpu").manual_seed(768)
    fp, _ = create_pyramid(gen, (128, 192), 12, 8, device=device,
                           no_mip=True)
    fp = pyramid_quantize_all(fp, 8)
    mlp = init_mlp(gen, 12 * 5 + 2 * 6 + 1, 64, 3, device=device)
    mlp = {name: mlp[name].detach() for name in NAMES}
    kw = dict(image_size=RECT_HW, mip_to_level=pyramid_mip_levels(
        512, 128, True), pe_channels=6, use_tri_pe=True)
    npix = RECT_HW[0] * RECT_HW[1]
    with torch.inference_mode():
        pc, c1v, pe_u, w2, b2, w3, b3, s, geom = k._prepare_2d(
            fp, mlp, 0, dtype=None, **kw)
        args = (pc, c1v, pe_u, w2, b2, w3, b3, s)
        g = dict(f=geom["f"], f1=geom["f1"], gelu="exact")
        end = cuda_ms(lambda: k.decode_image_fused_v2(fp, mlp, 0, **kw))
        k1 = cuda_ms(lambda: k.decode_kernel_2d(*args, **g))
        plain = cuda_ms(lambda: k.decode_kernel_2d_plain(*args, **g),
                        warmup=1, reps=3)
    work = (nbytes(*args) + npix * 3 * 4, 2 * npix * (64 * 64 + 3 * 64))
    b_ms, b_by = bound(*work, "tf32x3")
    step_ms, line = step_timing("kernel3", RECT_ARGS, device,
                                label="512×768 flagship")
    print(f"phase 28: 512×768 mip-0 decode fp32·exact: end to end "
          f"{end:.4f} ms ({npix / end / 1e6:.3f} GPix/s); K1 wrapper "
          f"{k1:.4f} ms vs plain {plain:.4f} ms; K1 bound {b_ms:.4f} ms "
          f"({b_by})", flush=True)
    print(f"phase 28: {line}", flush=True)
    return dict(decode=end, k1=k1, plain=plain, step=step_ms)


def phase_rect(device) -> dict:
    """The Kodak geometry end to end (:func:`_rect_kernels`,
    :func:`_rect_runs`, :func:`_rect_times`)."""
    _rect_kernels(device)
    out = _rect_runs(device)
    out.update(_rect_times(device))
    return out


# ---- phase 29: the scale-hyperprior codec and entropy-coded grids ---------

K13_SOURCE = "nic_torch/kernels/csrc/hs_bins.cu"
# no pallas_call: JAX computes σ → bin in XLA (``h_s_bins``)
K13_REPLACES = "nic/train/hyperprior.py:284"
# the JAX trainer's and CLI's defaults and the r5 checkpoint's config
HP_N, HP_M, HP_LAM, HP_PATCH, HP_BATCH = 96, 128, 0.018, 256, 8
# K13 against its plain version at n = HP_N, m = HP_M: (tag, B, ẑ rows,
# ẑ columns): 512×768, the edge tiles (a block's 16 columns wider than
# the image, ragged columns), 480² padded to 512², a batch, 2048²; and at
# the model's default widths (nic/models/hyperprior.py HyperSynthesis)
K13_SHAPES = (("seeded ẑ, random model, 8×12", 1, 8, 12),
              ("edge tile, 1×1", 1, 1, 1), ("edge tiles, 3×5", 1, 3, 5),
              ("8×8 (480² padded)", 1, 8, 8), ("B = 2, 8×12", 2, 8, 12),
              ("2048², 32×32", 1, 32, 32))
K13_MODEL_NM = (128, 192)
# and on seeded weights at widths that take the kernel's other paths:
# (tag, n, m, ẑ rows, ẑ columns): odd widths (4-byte copies: rows that a
# tensor copy's box cannot take) and n past 668 (8-column tiles)
K13_WIDTHS = (("odd widths n = 13, m = 20", 13, 20, 3, 5),
              ("n = 700, m = 24 (8-column tiles)", 700, 24, 2, 3))
HP_TRAIN_STEPS = 3000  # training steps (chunks of HP_CHUNK), whatever
HP_CHUNK = 100         # the host's speed, so the trained state is fixed
# the CPU tests' tolerances for one step: loss rel, grads max|Δ|/max|g|,
# params after clip + Adam; x̂ between devices; the coded symbols' bpp
# (the streams without their fixed framing, ``_framing_bytes``) against
# the model's estimate
HP_STEP_TOL = dict(loss=1e-5, grad=1e-4, param=1e-6)
# the card's fp32 gradients against float64 on the CPU, worst leaf's
# max|Δ|/max|g64|: from the initial weights within the CPU tests' grad
# limit; from the trained state within HP_GRAD64_VS_CPU times the CPU's own
# fp32 reading from the same state (how far fp32 lands from float64 there
# depends on the state: at 2900 steps the card read 2.03e-3 and the CPU
# 2.04e-3, after 45 s of training 6.2e-4 and 9.1e-5). A TF32 control must
# land beyond each limit
HP_GRAD64_TOL = {"initial weights": 1e-4}
HP_GRAD64_VS_CPU = 3.0
HP_XHAT_TOL = 1e-5
# the coded symbols' bpp (the streams less their fixed framing) against
# the estimate: 0.13-0.25% read on the H100 at 45 s of training
HP_CODED_REL = 0.005
# the framing of one format-3 y stream (magic, 64 lane states, 128 B load
# pad) and one 8-lane format-2 z stream (magic, lane count, lengths,
# final states), whatever the symbols: 388 + 69 B
HP_FRAMING_B = (4 + 64 * 4 + 128) + (5 + 8 * 4 + 8 * 4)


def _hp_images() -> dict:
    """The codec's images: sancho 512², mandrill 480² (padded to 512²) and
    sancho resized to 512×768 (Kodak's geometry)."""
    import numpy as np
    from PIL import Image

    from nic_torch.data.assets import load_rgb

    sancho = os.path.join(ROOT, "data", "sancho_512.png")
    wide = Image.open(sancho).convert("RGB").resize((768, 512),
                                                    Image.BILINEAR)
    return {"sancho 512²": load_rgb(sancho),
            "mandrill 480²": load_rgb(os.path.join(ROOT, "data",
                                                   "mandrill.png")),
            "sancho 512×768": np.asarray(wide, np.float32) / 255.0}


def _framing_bytes(stream: bytes) -> int:
    """A rANS stream's fixed framing, whatever its symbols: format 3 its
    magic, 64 lane states and 128-byte load pad (388 B); format 2 its
    magic, lane count, lane lengths and the lanes' final states."""
    if stream[:4] == b"NR3\x01":
        return 4 + 64 * 4 + 128
    lanes = stream[4]
    return 5 + 4 * lanes + 4 * lanes


def _hs_bits_equal(tag, z, hs_card, hs_cpu) -> dict:
    """K13 on the card against its plain version on this machine's CPU:
    every σ bit and every bin; returns the timings' inputs."""
    import torch

    from nic_torch.kernels.hs_bins import hs_bins_kernel, hs_bins_plain

    s_card, b_card = hs_bins_kernel(z.cuda(), hs_card)
    torch.cuda.synchronize()
    s_cpu, b_cpu = hs_bins_plain(z.cpu(), hs_cpu)
    s_card, b_card = s_card.cpu(), b_card.cpu()
    sigma_bits = int((s_card.view(torch.int32)
                      != s_cpu.view(torch.int32)).sum())
    bins = int((b_card != b_cpu).sum())
    err = float((s_card - s_cpu).abs().max())
    print(f"phase 29: K13 {tag}: z {tuple(z.shape)} → σ "
          f"{tuple(s_card.shape)}; card vs CPU plain: σ bits differing "
          f"{sigma_bits}, bins differing {bins} (bins used "
          f"{int(b_cpu.min())}..{int(b_cpu.max())})", flush=True)
    if sigma_bits or bins:
        fail(f"K13 {tag}: {sigma_bits} σ bits and {bins} bins differ from "
             "the plain version on the CPU")
    return err


def _hs_random_weights(n: int, m: int, gen):
    """Seeded K13 weights (rows layout) of widths n, m, lecun-scaled so σ
    spreads over the bins."""
    import torch

    from nic_torch.kernels.hs_bins import HsWeights

    def rand(*shape, fan_in):
        return torch.randn(*shape, generator=gen) / fan_in**0.5

    return HsWeights(rand(n, 16 * n, fan_in=4 * n), rand(n, fan_in=n),
                     rand(n, 16 * n, fan_in=4 * n), rand(n, fan_in=n),
                     rand(m, 9 * n, fan_in=9 * n), rand(m, fan_in=n))


def _hs_print(where: str, k13, plain, lib, work) -> None:
    b_ms, b_by = bound(*work, "fp32_nofma")
    print(f"phase 29: K13 at {where.format(HP_N, HP_M)}: {k13:.4f} ms "
          f"({k13 / b_ms:.2f}× its bound), plain {plain:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}, no-FMA fp32 rate; "
          f"{bound(*work, 'fp32')[0]:.4f} ms at the FMA peak); the cuDNN "
          f"composition it replaces (convT, convT, conv, exp, log; another "
          f"order, not the same bits; a reference) {lib:.4f} ms",
          flush=True)


def _hs_times(z, hs, model) -> tuple:
    """K13, its plain version on the card and the cuDNN composition it
    replaces (a reference: not the same bits), CUDA events; the work for
    the bound (2·multiply-adds of the three layers; bytes of ẑ, the
    weights, σ and the bins)."""
    import torch
    import torch.nn.functional as F

    from nic_torch.kernels.hs_bins import hs_bins_kernel, hs_bins_plain

    z = z.cuda()
    k13 = cuda_ms(lambda: hs_bins_kernel(z, hs))
    plain = cuda_ms(lambda: hs_bins_plain(z, hs), warmup=1, reps=3)
    c1, c2, c3 = model.h_s.convs

    def composition():
        s = F.gelu(F.conv_transpose2d(z, c1.weight, c1.bias, 2, 1),
                   approximate="tanh")
        s = F.gelu(F.conv_transpose2d(s, c2.weight, c2.bias, 2, 1),
                   approximate="tanh")
        s = torch.exp(F.conv2d(s, c3.weight, c3.bias, 1, 1))
        return torch.ceil((torch.log(s) + 2.207274913787842)
                          * 9.896079063415527).clamp(0, 63).int()

    from nic_torch.train.hyperprior import conv_flags

    with torch.no_grad(), conv_flags():
        lib = cuda_ms(composition)
    b, n, h4, w4 = z.shape
    m = hs.w3.shape[0]
    macs = b * n * n * (4 * h4 * w4 * 4 + 16 * h4 * w4 * 4) \
        + b * 16 * h4 * w4 * m * 9 * n
    out = b * m * 16 * h4 * w4
    work = (nbytes(z, *hs) + out * 8, 2 * macs)
    return k13, plain, lib, work


def _hp_train(device):
    """The full-width trainer on data/*.png for HP_TRAIN_STEPS steps; the
    loss must fall (last 100 steps against the first 100)."""
    import glob

    import numpy as np

    from nic_torch.data.assets import load_rgb
    from nic_torch.train.hyperprior import HyperpriorTrainer

    paths = sorted(glob.glob(os.path.join(ROOT, "data", "*.png")))
    trainer = HyperpriorTrainer(n=HP_N, m=HP_M, lam=HP_LAM, patch=HP_PATCH,
                                batch=HP_BATCH, seed=0, device=device)
    staged = trainer.stage_images([load_rgb(p) for p in paths])
    trainer.train_chunk(staged, 5)  # cuDNN plans and allocator warm-up
    losses = []
    t0 = time.perf_counter()
    for _ in range(HP_TRAIN_STEPS // HP_CHUNK):
        losses.extend(trainer.train_chunk(staged, HP_CHUNK)[0].tolist())
    wall = time.perf_counter() - t0
    first, last = np.mean(losses[:HP_CHUNK]), np.mean(losses[-HP_CHUNK:])
    print(f"phase 29: hyperprior trainer n={HP_N} m={HP_M} λ={HP_LAM} patch "
          f"{HP_PATCH} batch {HP_BATCH} on {len(paths)} images: "
          f"{len(losses)} steps in {wall:.1f} s ({len(losses) / wall:.2f} "
          f"steps/s); mean loss of the first 100 {first:.4f}, of the last "
          f"100 {last:.4f}", flush=True)
    if not np.isfinite(losses).all() or not last < first:
        fail(f"the hyperprior loss did not fall: {first:.4f} → {last:.4f}")
    return trainer, staged, len(losses) / wall


def _hp_grads(model, x, noise, tf32: bool = False) -> dict:
    """The RD loss's gradients at HP_LAM of one batch and noise on the
    model's device and dtype, under the JAX leaf names; ``tf32`` lets
    cuDNN's convolutions take TF32."""
    import torch

    from nic_torch.io.convert import hyperprior_leaves, hyperprior_to_jax
    from nic_torch.models.hyperprior import rd_loss

    p = next(model.parameters())
    x = x.to(p.device, p.dtype)
    noise = tuple(u.to(p.device, p.dtype) for u in noise)
    model.zero_grad(set_to_none=True)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=tf32):
        x_hat, y_bits, z_bits = model(x, noise)
        rd_loss(x_hat, x, y_bits, z_bits, HP_LAM)[0].backward()
    return hyperprior_to_jax(model, {
        k: q.grad for k, (q, _, _) in hyperprior_leaves(model).items()})


def _worst_leaf(grads: dict, ref: dict) -> tuple:
    """(max|Δ|/max|g_ref| of the worst leaf, its name)."""
    return max((float(abs(grads[k] - ref[k]).max())
                / max(float(abs(ref[k]).max()), 1e-30), k) for k in ref)


def _hp_step_card_vs_cpu(trainer, staged, tag) -> dict:
    """One step on the card against the same step on the CPU (fp32 convs,
    no TF32): the same params, Adam state, crops and noise → {loss, grad,
    param, card64, cpu64, tf32_64}: the loss's relative difference, the
    worst leaf's gradient max|Δ|/max|g| and the params' max|Δ| after
    clip + Adam; then the worst leaf's max|Δ|/max|g| of the card's, the
    CPU's and a TF32 control's gradients (TF32 convolutions on the card)
    against the same gradients in float64 on the CPU."""
    import copy

    import torch

    from nic_torch.io.convert import hyperprior_leaves, hyperprior_to_jax
    from nic_torch.train.hyperprior import HyperpriorTrainer

    cpu = HyperpriorTrainer(n=HP_N, m=HP_M, lam=HP_LAM, patch=HP_PATCH,
                            batch=HP_BATCH, device="cpu")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, "ckpt.npz")
        trainer.save_checkpoint(path)
        cpu.load_checkpoint(path)
    ref64 = copy.deepcopy(cpu.model).double()
    ctl = copy.deepcopy(trainer.model)
    x = trainer.sample_crops(staged)
    with torch.no_grad():
        y = trainer.model.analysis(x[:1])
        z = trainer.model.hyper_analysis(y)
    gen = torch.Generator().manual_seed(29)
    noise = tuple(torch.rand((HP_BATCH,) + tuple(t.shape[1:]),
                             generator=gen) - 0.5 for t in (y, z))
    got = {}
    for side, tr in (("card", trainer), ("cpu", cpu)):
        loss = tr.loss_and_grads(x.to(tr.device),
                                 tuple(u.to(tr.device) for u in noise))
        grads = hyperprior_to_jax(tr.model, {
            k: p.grad for k, (p, _, _) in
            hyperprior_leaves(tr.model).items()})
        tr.apply_grads()
        got[side] = (float(loss[0]), grads, hyperprior_to_jax(tr.model))
    (l_card, g_card, p_card), (l_cpu, g_cpu, p_cpu) = got["card"], got["cpu"]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    rels = sorted(((float(abs(g_card[k] - g_cpu[k]).max())
                    / max(float(abs(g_cpu[k]).max()), 1e-30), k)
                   for k in g_cpu), reverse=True)
    grad_rel = rels[0][0]
    param = max(float(abs(p_card[k] - p_cpu[k]).max()) for k in p_cpu)
    print(f"phase 29: one step ({tag}), card vs CPU (fp32 convs): loss "
          f"{l_card:.6f} vs {l_cpu:.6f} (rel {loss_rel:.2e}); worst grad "
          f"max|Δ|/max|g| {grad_rel:.2e} ("
          + "; ".join(f"{k} {r:.2e}, max|g| {float(abs(g_cpu[k]).max()):.3e}"
                      f" vs {float(abs(g_card[k]).max()):.3e}"
                      for r, k in rels[:3])
          + f"); params after clip + Adam max|Δ| {param:.2e}", flush=True)
    g64 = _hp_grads(ref64, x, noise)
    g_tf32 = _hp_grads(ctl, x, noise, tf32=True)
    worst = {side: _worst_leaf(g, g64) for side, g in
             (("card", g_card), ("cpu", g_cpu), ("tf32", g_tf32))}
    leaf = rels[0][1]
    print(f"phase 29: one step ({tag}), grads against float64 on the CPU, "
          f"worst leaf max|Δ|/max|g64|: card {worst['card'][0]:.2e} "
          f"({worst['card'][1]}), CPU {worst['cpu'][0]:.2e} "
          f"({worst['cpu'][1]}), TF32 control {worst['tf32'][0]:.2e} "
          f"({worst['tf32'][1]}); on {leaf}: card "
          f"{_worst_leaf({leaf: g_card[leaf]}, {leaf: g64[leaf]})[0]:.2e}, "
          f"CPU {_worst_leaf({leaf: g_cpu[leaf]}, {leaf: g64[leaf]})[0]:.2e}",
          flush=True)
    return dict(loss=loss_rel, grad=grad_rel, param=param,
                card64=worst["card"][0], cpu64=worst["cpu"][0],
                tf32_64=worst["tf32"][0])


def _hp_codec(trainer) -> dict:
    """Compress the three images on the card; decompress on the card
    (equal to ``evaluate`` bit for bit), the card's streams on the CPU and
    the CPU's on the card (identical ŷ/ẑ, x̂ within HP_XHAT_TOL); real bpp
    without the streams' framing within HP_CODED_REL of the estimate, with
    it at most HP_FRAMING_B more; K13 once per compress and once per
    decompress; times at 512×768."""
    import numpy as np
    import torch

    from nic_torch.kernels.hs_bins import hs_bins_kernel
    from nic_torch.train.hyperprior import (HyperpriorCodec,
                                            bench_decode_stages)

    card = HyperpriorCodec(trainer)
    cpu = HyperpriorCodec(trainer, device="cpu")
    out = {"launches": 0}
    for tag, img in _hp_images().items():
        psnr, est, x_eval = trainer.evaluate(img)
        hs_bins_kernel.launches = 0
        blob = card.compress(img)
        c_launch = hs_bins_kernel.launches
        hs_bins_kernel.launches = 0
        x_card = card.decompress(blob)
        d_launch = hs_bins_kernel.launches
        out["launches"] += c_launch + d_launch
        if c_launch != 1 or d_launch != 1:
            fail(f"{tag}: K13 launched {c_launch} times in compress and "
                 f"{d_launch} in decompress; want 1 and 1")
        y_card, z_card, _ = card.encode_latents(img)
        y_on_cpu, z_on_cpu = cpu.decode_latents(blob)
        x_on_cpu = cpu.decompress(blob)
        blob_cpu = cpu.compress(img)
        y_cpu, z_cpu, _ = cpu.encode_latents(img)
        y_back, z_back = card.decode_latents(blob_cpu)
        x_cpu_on_card = card.decompress(blob_cpu)
        x_cpu = cpu.decompress(blob_cpu)
        px = img.shape[0] * img.shape[1]
        real = card.num_bits(blob) / px
        framing = _framing_bytes(blob["y"]) + _framing_bytes(blob["z"])
        coded = real - framing * 8 / px
        rel = abs(coded - est) / est
        d_cross = float(np.abs(x_on_cpu - x_card).max())
        d_back = float(np.abs(x_cpu_on_card - x_cpu).max())
        moved = int((y_card != y_cpu).sum() + (z_card != z_cpu).sum())
        print(f"phase 29: codec {tag}: PSNR {psnr:.4f} dB; bpp estimated "
              f"{est:.4f}, real {real:.4f} (rel {(real - est) / est:.4f}; "
              f"without the streams' {framing} B of fixed framing "
              f"{coded:.4f}, rel {rel:.4f}; y "
              f"{len(blob['y'])} B format {blob['y'][:3].decode()}, z "
              f"{len(blob['z'])} B); card decompress vs evaluate max|Δ| "
              f"{float(np.abs(x_card - x_eval).max()):.3e}; card stream on "
              f"the CPU: ŷ/ẑ equal "
              f"{np.array_equal(y_on_cpu, y_card) and np.array_equal(z_on_cpu, z_card)}, "
              f"x̂ max|Δ| {d_cross:.3e}; CPU stream on the card: ŷ/ẑ equal "
              f"{np.array_equal(y_back, y_cpu) and np.array_equal(z_back, z_cpu)}, "
              f"x̂ max|Δ| {d_back:.3e}; latents the two devices' analyses "
              f"round differently: {moved}", flush=True)
        if not np.array_equal(x_card, x_eval):
            fail(f"{tag}: the card's decompress is not evaluate's x̂")
        if not (np.array_equal(y_on_cpu, y_card)
                and np.array_equal(z_on_cpu, z_card)
                and np.array_equal(y_back, y_cpu)
                and np.array_equal(z_back, z_cpu)):
            fail(f"{tag}: a stream decoded on the other device gave other "
                 "latents")
        if max(d_cross, d_back) > HP_XHAT_TOL:
            fail(f"{tag}: x̂ between devices {max(d_cross, d_back):.3e} > "
                 f"{HP_XHAT_TOL}")
        if rel > HP_CODED_REL:
            fail(f"{tag}: the coded symbols' bpp {coded:.4f} (real "
                 f"{real:.4f}) is not within {HP_CODED_REL:.1%} of the "
                 f"estimate {est:.4f}")
        if (framing > HP_FRAMING_B
                or real > est * (1 + HP_CODED_REL) + HP_FRAMING_B * 8 / px):
            fail(f"{tag}: real bpp {real:.4f} above the estimate {est:.4f} "
                 f"+ {HP_CODED_REL:.1%} + {HP_FRAMING_B} B of framing "
                 f"(this stream's framing {framing} B)")
        out[tag] = (blob, y_card, z_card)

    img = _hp_images()["sancho 512×768"]
    blob = out["sancho 512×768"][0]
    torch.cuda.synchronize()

    def host_ms(fn, reps=5):
        fn()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    out["compress_ms"] = host_ms(lambda: card.compress(img))
    out["decompress_ms"] = host_ms(lambda: card.decompress(blob))
    stages = bench_decode_stages(card, blob, img.shape[0] * img.shape[1])
    bf16 = HyperpriorCodec(trainer, synthesis_dtype=torch.bfloat16)
    x16 = bf16.decompress(blob)
    d16 = float(np.abs(x16 - card.decompress(blob)).max())
    same = bf16.compress(img)
    if same["y"] != blob["y"] or same["z"] != blob["z"]:
        fail("synthesis_dtype=bf16 changed the bitstream")
    from nic_torch import native

    print(f"phase 29: 512×768 compress {out['compress_ms']:.3f} ms, "
          f"decompress {out['decompress_ms']:.3f} ms (host clock, median "
          f"of 5); decode stages: rANS {stages['rans_ms']:.3f} ms "
          f"({native.decode_path()} format-3 decode), glue "
          f"{stages['host_glue_ms']:.3f} ms, K13 device "
          f"{stages['hs_bins_device_ms']:.4f} ms, synthesis device "
          f"{stages['synthesis_device_ms']:.3f} ms; bf16 synthesis: "
          f"streams unchanged, x̂ max|Δ| {d16:.3e}", flush=True)
    return out


def _hp_entropy_flagship(device) -> None:
    """The flagship 200-epoch run with ENTROPY_CODE_GRIDS=True; its
    rANS-coded artifact through the decode CLI at mips 0-2 (K1 3 launches,
    the launch log naming only ``decode_v2_mma``), equal to the decode of
    the same codes saved fixed-length."""
    import numpy as np

    from nic_torch.cli import decode as dcli
    from nic_torch.io.artifacts import (compressed_num_bits, load_compressed,
                                        save_compressed)
    from nic_torch.kernels import _build
    from nic_torch.kernels.decode_fused_v2 import decode_kernel_2d

    def keep(run):
        art = run["res"]["artifact"]
        mlp, fp, meta = load_compressed(art, device=device)
        fixed = os.path.join(os.path.dirname(art), "fixed.npz")
        save_compressed(fixed, mlp, fp, meta["fp_bits"],
                        {k: meta[k] for k in ("save_name", "config")})
        _build.clear_body_launches()
        decode_kernel_2d.launches = 0
        ent = [dcli.run([art, "--mip", str(m)]) for m in range(3)]
        log = _build.body_launches()
        k1 = decode_kernel_2d.launches
        fix = [dcli.run([fixed, "--mip", str(m)]) for m in range(3)]
        return (ent, fix, k1, log, meta.get("rans_format"),
                compressed_num_bits(art), compressed_num_bits(fixed))

    run = _cli_train(TRAIN_ARGS + ["ENTROPY_CODE_GRIDS=True"], decode=False,
                     keep=keep)
    ent, fix, k1, log, fmt, bits_e, bits_f = run["kept"]
    npix = ent[0].shape[0] * ent[0].shape[1]
    same = all(np.array_equal(a, b) for a, b in zip(ent, fix))
    print(f"phase 29: flagship ENTROPY_CODE_GRIDS=True, 200 epochs in "
          f"{run['wall']:.1f} s (K11 {run['launches']['K11']}); rANS format "
          f"{fmt}; bpp {bits_e / npix:.4f} entropy-coded vs "
          f"{bits_f / npix:.4f} fixed-length (CLI bpp "
          f"{run['res']['bpp']:.4f}); decode CLI mips 0-2: K1 {k1} launches, "
          f"launch log {_bodies_named(log)} {sum(log.values())} times; "
          f"equal to the fixed-length decode: {same}",
          flush=True)
    if (k1 != 3 or not all(_is_body(DECODE_MMA, name) for name in log)
            or sum(log.values()) != 3):
        fail(f"entropy-coded artifact: K1 {k1} launches, log {log}")
    if not same:
        fail("the entropy-coded artifact decodes differently from the "
             "fixed-length one")
    if abs(run["res"]["bpp"] - bits_e / npix) > 1e-9:
        fail("the CLI's bpp is not the entropy-coded artifact's")


def phase_hyperprior(device) -> dict:
    """The scale-hyperprior codec (K13, the trainer, the codec between the
    card and the CPU) and the entropy-coded flagship artifact."""
    import torch

    from nic_torch.kernels.hs_bins import hs_weights
    from nic_torch.models.hyperprior import HyperpriorModel

    gen = torch.Generator().manual_seed(13)
    rand = HyperpriorModel(HP_N, HP_M, generator=gen)
    hs_rand = (hs_weights(rand.to(device).h_s), hs_weights(rand.cpu().h_s))
    err, z2048 = 0.0, None
    for tag, b, h4, w4 in K13_SHAPES:
        z = torch.round(torch.randn(b, HP_N, h4, w4, generator=gen) * 3.0)
        err = max(err, _hs_bits_equal(tag, z, *hs_rand))
        z2048 = z if (h4, w4) == (32, 32) else z2048
    wide = HyperpriorModel(*K13_MODEL_NM, generator=gen)
    z = torch.round(torch.randn(1, K13_MODEL_NM[0], 8, 12, generator=gen)
                    * 3.0)
    err = max(err, _hs_bits_equal(
        "the model's default n = {}, m = {}, 8×12".format(*K13_MODEL_NM), z,
        hs_weights(wide.to(device).h_s), hs_weights(wide.cpu().h_s)))
    del wide
    for tag, n, m, h4, w4 in K13_WIDTHS:
        hs_cpu = _hs_random_weights(n, m, gen)
        z = torch.round(torch.randn(1, n, h4, w4, generator=gen) * 3.0)
        err = max(err, _hs_bits_equal(
            tag, z, type(hs_cpu)(*(t.to(device) for t in hs_cpu)), hs_cpu))
    trainer, staged, steps_s = _hp_train(device)
    codec = _hp_codec(trainer)
    z_tr = torch.from_numpy(codec["sancho 512×768"][2].transpose(
        0, 3, 1, 2).astype("float32"))
    hs_card = hs_weights(trainer.model.h_s)
    err = max(err, _hs_bits_equal("trained model, sancho 512×768 ẑ", z_tr,
                                  hs_card,
                                  hs_weights(trainer.model.cpu().h_s)))
    trainer.model.to(device)
    k13, plain, lib, work = _hs_times(z_tr, hs_card, trainer.model)
    _hs_print("512×768 (z 8×12×{} → σ 32×48×{}), trained model", k13,
              plain, lib, work)
    _hs_print("2048² (z 32×32×{} → σ 128×128×{}), random model",
              *_hs_times(z2048, hs_rand[0], rand.to(device)))
    print(f"phase 29: train {steps_s:.2f} steps/s", flush=True)
    _hp_entropy_flagship(device)
    from nic_torch.train.hyperprior import HyperpriorTrainer

    fresh = HyperpriorTrainer(n=HP_N, m=HP_M, lam=HP_LAM, patch=HP_PATCH,
                              batch=HP_BATCH, seed=1, device=device)
    # from the initial weights, as the CPU tests step against JAX, every
    # limit card vs CPU; from the trained state the loss and the updated
    # params card vs CPU, and from both the card's gradients against
    # float64 (trained: against the CPU's own fp32 distance), where a TF32
    # control must land beyond the limit
    bad = []
    for tag, tr, keys in (("initial weights", fresh, ("loss", "grad", "param")),
                          ("trained", trainer, ("loss", "param"))):
        got = _hp_step_card_vs_cpu(tr, staged, tag)
        bad += [f"{tag} {k}" for k in keys if got[k] > HP_STEP_TOL[k]]
        tol = HP_GRAD64_TOL.get(tag, HP_GRAD64_VS_CPU * got["cpu64"])
        print(f"phase 29: ({tag}) grads vs float64: CPU fp32 "
              f"{got['cpu64']:.2e}, card {got['card64']:.2e}, card/CPU "
              f"{got['card64'] / got['cpu64']:.2f}; limit {tol:.2e}"
              + ("" if tag in HP_GRAD64_TOL else
                 f" ({HP_GRAD64_VS_CPU:g} × the CPU's)")
              + f"; TF32 control {got['tf32_64']:.2e}", flush=True)
        if got["card64"] > tol:
            bad.append(f"{tag} card grads vs float64 {got['card64']:.2e} > "
                       f"{tol:.2e}")
        if not got["tf32_64"] > tol:
            bad.append(f"{tag}: the TF32 control {got['tf32_64']:.2e} "
                       f"passes {tol:.2e}, so the check sees nothing")
    if bad:
        fail(f"the card's step disagrees beyond {HP_STEP_TOL}, grads vs "
             f"float64 {HP_GRAD64_TOL} (initial) and {HP_GRAD64_VS_CPU:g} × "
             f"the CPU's (trained): {bad}")
    return dict(launches=codec["launches"], err=err, ms=k13, plain=plain,
                work=work)


# ---- phase 30: the conv-AE and per-pixel family (no kernel of its own) ----

CONVAE_FIXTURES = ("image_comp", "pixel_comp", "movie_3d_comp")
SANCHO = os.path.join(ROOT, "data", "sancho_512.png")
# the card's run of each fixture workload (its flags and epochs, the port's
# own initial weights, seed 0) against the fixture's JAX run, |ΔPSNR| in
# dB: |mean − JAX| + 3·std of the port's PSNR over seeds 0-4 on the CPU,
# rounded up to 0.05 dB (scripts/torch_convae_seed_band.py; PERF.md §2),
# set before any card run
CONVAE_BAND_DB = {"image_comp": 0.55, "pixel_comp": 0.35,
                  "movie_3d_comp": 3.95}
CONVAE_STEP_TOL = HP_STEP_TOL  # the CPU tests' limits, as phase 29's
CONVAE_SERVE_TOL = 1e-5  # fp32 max|Δ| card vs CPU; u8 ≤ 1 LSB
CONVAE_SHORT = 200  # epochs of the CLIs without a fixture
CONVAE_WARM = 10  # card steps before the card-vs-CPU step


def _convae_meta(workload: str):
    import numpy as np

    with np.load(os.path.join(ROOT, "tests", "fixtures",
                              f"convae_{workload}.npz")) as z:
        return (json.loads(bytes(z["__meta__"]).decode()),
                {k: z[k] for k in z.files if k != "__meta__"})


def _convae_assets() -> dict:
    """The family's host assets: sancho 512² [H, W, 3], misty [T, H, W, 3]
    in [0, 1], and misty's 512² frame sheet."""
    import numpy as np

    from nic_torch.data.assets import (flatten_3d_to_2d, load_image_mips,
                                       read_clip)

    clip = read_clip(CLIP)
    return {"sancho": load_image_mips(SANCHO, 512, 0)[0].transpose(1, 2, 0),
            "misty": clip.astype(np.float32) / 255.0,
            "sheet": flatten_3d_to_2d(clip, 512).astype(np.float32) / 255.0}


def _convae_trainers(assets, device, seed: int = 0) -> dict:
    """Each trainer at its CLI's full width: ConvAE 2D on sancho 512²
    (image_comp, 4-bit 8/16), ConvAE 3D on misty 64³ (movie_3d_comp,
    8-bit 16/32), the pixel trainer without and with the PE on sancho 512²
    (8-bit, H = 64, 256 pixels a step), the movie-label trainer on misty's
    64 frames (8-bit 8/16)."""
    from nic_torch.train.conv_ae import ConvAETrainer
    from nic_torch.train.movie_label import MovieLabelTrainer
    from nic_torch.train.pixel import PixelTrainer

    return {
        "ConvAE 2D 512²": lambda: ConvAETrainer(
            assets["sancho"], num_bits=4, num_epochs=1000, seed=seed,
            device=device),
        "ConvAE 3D 64³": lambda: ConvAETrainer(
            assets["misty"], num_bits=8, latent_channels=16,
            hidden_channels=32, num_epochs=1000, seed=seed, device=device),
        "Pixel 512²": lambda: PixelTrainer(
            assets["sancho"], num_bits=8, num_epochs=1000, seed=seed,
            device=device),
        "Pixel+PE 512²": lambda: PixelTrainer(
            assets["sancho"], num_bits=8, num_epochs=1000, use_pe=True,
            seed=seed, device=device),
        "MovieLabel 64×64²": lambda: MovieLabelTrainer(
            assets["misty"], num_bits=8, num_epochs=1000, seed=seed,
            device=device),
    }


def _convae_serve(assets) -> dict:
    """(a) Each fixture's JAX latent through its JAX weights on the card and
    on the host CPU: fp32 max|Δ| and u8 LSB card vs CPU, PSNR against the
    fixture's JAX PSNR; returns {workload: card decode ms (CUDA events)}."""
    import numpy as np

    from nic_torch.cli.common import report_image, report_video
    from nic_torch.train.conv_ae import ConvAETrainer
    from nic_torch.train.pixel import PixelTrainer

    ms = {}
    for w in CONVAE_FIXTURES:
        meta, arrays = _convae_meta(w)
        recs = {}
        for dev in ("cuda", "cpu"):
            if w == "image_comp":
                tr = ConvAETrainer(assets["sancho"], num_bits=4, device=dev)
            elif w == "pixel_comp":
                tr = PixelTrainer(assets["sancho"], num_bits=8, hidden=64,
                                  device=dev)
            else:
                tr = ConvAETrainer(assets["misty"], num_bits=8,
                                   latent_channels=16, hidden_channels=32,
                                   device=dev)
            tr.load_state_arrays(arrays)
            recs[dev] = tr.decode(arrays["latent"])
            if dev == "cuda":
                ms[w] = cuda_ms(lambda: tr.decode(arrays["latent"]))
        asset = assets["misty" if w == "movie_3d_comp" else "sancho"]
        report = report_video if w == "movie_3d_comp" else report_image
        err = float(np.abs(recs["cuda"] - recs["cpu"]).max())

        def q(x):
            return np.clip(x * 255.0, 0, 255).astype(np.int64)

        lsb = int(np.abs(q(recs["cuda"]) - q(recs["cpu"])).max())
        p_card = report(lambda *_: None, asset, recs["cuda"], None)
        p_cpu = report(lambda *_: None, asset, recs["cpu"], None)
        print(f"phase 30: serve {w} (latent {arrays['latent'].shape}): card "
              f"vs CPU max|Δ| {err:.2e}, {lsb} u8 LSB; PSNR card "
              f"{p_card:.4f}, CPU {p_cpu:.4f}, JAX {meta['psnr']:.4f} dB; "
              f"decode {ms[w]:.3f} ms (card, CUDA events)", flush=True)
        if (err > CONVAE_SERVE_TOL or lsb > 1
                or abs(p_card - meta["psnr"]) > 0.05):
            fail(f"phase 30 serve {w}: max|Δ| {err:.2e} (≤ "
                 f"{CONVAE_SERVE_TOL}), {lsb} LSB (≤ 1), PSNR {p_card:.4f} "
                 f"vs JAX {meta['psnr']:.4f} (≤ 0.05 dB)")
    return ms


def _convae_step(assets) -> None:
    """(b) One step on the card against the same step on the CPU, each
    trainer, each phase, from the same state (the card's after CONVAE_WARM
    steps, Adam's moments included) and draws; plus two card runs from one
    seed giving the same loss trace."""
    import numpy as np
    import torch

    bad = []
    cards = _convae_trainers(assets, "cuda")
    cpus = _convae_trainers(assets, "cpu")
    for name, make in cards.items():
        runs = [make().train_many(20) for _ in range(2)]
        if not np.array_equal(runs[0], runs[1]):
            bad.append(f"{name}: two runs from one seed differ "
                       f"({runs[0][-1]} vs {runs[1][-1]})")
        card = make()
        card.train_many(CONVAE_WARM)
        state = card.state_arrays()
        for phase in ("noise", "quantize"):
            draws = card._draws(phase)  # the card's, copied to the CPU
            got = {}
            for side, tr in (("card", card), ("cpu", cpus[name]())):
                tr.load_state_arrays(state)
                loss = tr.step_core(phase, *[
                    None if d is None else d.to(tr.device) for d in draws])
                got[side] = (float(loss), tr.grads_to_jax(),
                             tr.params_to_jax())
            (l1, g1, p1), (l0, g0, p0) = got["card"], got["cpu"]
            loss_rel = abs(l1 - l0) / abs(l0)
            grad, leaf = max(
                (float(np.abs(g1[k] - g0[k]).max())
                 / max(float(np.abs(g0[k]).max()), 1e-30), k) for k in g0)
            param = max(float(np.abs(p1[k] - p0[k]).max()) for k in p0)
            zero = phase == "quantize" and all(
                not np.any(g1[k]) for k in g1 if k.startswith("enc/"))
            print(f"phase 30: step {name} {phase}, card vs CPU: loss "
                  f"{l1:.6f} vs {l0:.6f} (rel {loss_rel:.2e}); worst grad "
                  f"max|Δ|/max|g| {grad:.2e} ({leaf}); params after Adam "
                  f"max|Δ| {param:.2e}"
                  + ("; encoder grads zero" if zero else ""), flush=True)
            for key, val in (("loss", loss_rel), ("grad", grad),
                             ("param", param)):
                if not val <= CONVAE_STEP_TOL[key]:
                    bad.append(f"{name} {phase} {key} {val:.2e}")
            if phase == "quantize" and not zero:
                bad.append(f"{name}: encoder grads not zero in the quantize "
                           "phase")
        card = None
        torch.cuda.empty_cache()
    if bad:
        fail(f"phase 30 steps (limits {CONVAE_STEP_TOL}): {bad}")


def _csv_loss_fell(root: str) -> tuple:
    """(mean loss of the first 20 epochs, of the last 20) in a CLI run's
    scalars CSV."""
    import csv

    import numpy as np

    (path,) = [os.path.join(root, "log", f) for f in
               os.listdir(os.path.join(root, "log"))
               if f.endswith("_scalars.csv")]
    with open(path) as fh:
        loss = [float(r["value"]) for r in csv.DictReader(fh)
                if r["tag"] == "Loss/train_epoch_label"]
    return float(np.mean(loss[:20])), float(np.mean(loss[-20:])), len(loss)


def _check_outputs(tag, root, shape, bits, ext) -> None:
    """The run's latent (uint8, ``shape``, codes < 2^bits) and its PNG or
    AVI (read back at the asset's size)."""
    import numpy as np

    from nic_torch.data.assets import read_clip

    (npy,) = os.listdir(os.path.join(root, "comp"))
    codes = np.load(os.path.join(root, "comp", npy))
    (img,) = os.listdir(os.path.join(root, "image"))
    path = os.path.join(root, "image", img)
    if ext == ".avi":
        back = read_clip(path).shape
    else:
        from PIL import Image

        back = np.asarray(Image.open(path)).shape
    print(f"phase 30: {tag}: latent {codes.shape} {codes.dtype} (codes "
          f"{int(codes.min())}-{int(codes.max())}), {img} {back}", flush=True)
    if (codes.shape != shape or codes.dtype != np.uint8
            or int(codes.max()) >= 2**bits or not img.endswith(ext)):
        fail(f"phase 30 {tag}: latent {codes.shape} {codes.dtype} max "
             f"{int(codes.max())} (want {shape} uint8 < {2**bits}), output "
             f"{img} (want {ext})")


def _convae_cli() -> dict:
    """(c) The CLIs on the card at full width: the fixture workloads at
    their fixture's flags and epochs (PSNR within CONVAE_BAND_DB of the JAX
    run), the others CONVAE_SHORT epochs (a falling loss, the latent, the
    PNG or AVI). Returns {cli: (PSNR, epochs, wall s)}."""
    import importlib

    res = {}
    short = ["--num_epochs", str(CONVAE_SHORT), "--interval_print", "100"]
    runs = [(w, [os.path.join(ROOT, a) if a.startswith("data/") else a
                 for a in _convae_meta(w)[0]["argv"]])
            for w in CONVAE_FIXTURES] + [
        ("pixel_pos_comp", short),
        ("movie_frame_comp", short + ["--image_path", CLIP]),
        ("movie_2d_comp", short + ["--image_path", CLIP]),
        ("movie_lavel_comp", short),
        ("movie_lavel_comp --label_embedding", short + [
            "--label_embedding", "true", "--image_path", CLIP])]
    want = {"image_comp": ((1, 128, 128, 8), 4, ".png"),
            "pixel_comp": ((129, 129, 8), 8, ".png"),
            "movie_3d_comp": ((1, 16, 16, 16, 16), 8, ".avi"),
            "pixel_pos_comp": ((129, 129, 8), 8, ".png"),
            "movie_frame_comp": ((1, 128, 128, 16), 8, ".avi"),
            "movie_2d_comp": ((1, 128, 128, 16), 8, ".avi"),
            "movie_lavel_comp": ((1, 128, 128, 8), 4, ".png"),
            "movie_lavel_comp --label_embedding": ((64, 16, 16, 8), 8,
                                                   ".avi")}
    for tag, argv in runs:
        mod = importlib.import_module(f"nic_torch.cli.{tag.split()[0]}")
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT,
                                                          "build")) as tmp:
            t0 = time.perf_counter()
            p = float(mod.run(list(argv) + ["--output_root", tmp]))
            wall = time.perf_counter() - t0
            epochs = int(argv[argv.index("--num_epochs") + 1])
            _check_outputs(tag, tmp, *want[tag])
            if tag.endswith("--label_embedding"):
                (log,) = os.listdir(os.path.join(tmp, "printlog"))
                with open(os.path.join(tmp, "printlog", log)) as fh:
                    line = [x for x in fh if x.startswith("loss: first")][0]
                first, last = (float(x.split()[-1]) for x in
                               line.strip().split(","))
                n = epochs
            else:
                first, last, n = _csv_loss_fell(tmp)
        res[tag] = (p, epochs, wall)
        print(f"phase 30: CLI {tag}: {epochs} epochs in {wall:.1f} s "
              f"({epochs / wall:.1f} epochs/s, host clock, decode and "
              f"outputs included); loss {first:.6f} → {last:.6f}; PSNR "
              f"{p:.4f} dB", flush=True)
        if n != epochs or not last < first:
            fail(f"phase 30 CLI {tag}: the loss did not fall over {n} "
                 f"epochs ({first:.6f} → {last:.6f})")
        if tag in CONVAE_BAND_DB:
            jax_p = _convae_meta(tag)[0]["psnr"]
            if not abs(p - jax_p) <= CONVAE_BAND_DB[tag]:
                fail(f"phase 30 CLI {tag}: PSNR {p:.4f} dB vs the fixture's "
                     f"JAX run {jax_p:.4f} (band {CONVAE_BAND_DB[tag]} dB)")
    return res


def _convae_times(assets) -> dict:
    """(d) CUDA-event times: ms per train step of each trainer (median of
    50 after 5; its device time and idle share by torch.profiler), the
    conv-AE encode and decode (the public calls: upload, convs, codes to
    the host; and the module forwards alone) at 512² and 64³, the pixel
    decode at 512²."""
    import torch

    from nic_torch.train.hyperprior import conv_flags

    out = {}
    for name, make in _convae_trainers(assets, "cuda").items():
        tr = make()
        step = out[f"{name} step"] = cuda_ms(tr.train_step, warmup=5,
                                             reps=50)
        dev, per = device_ms(tr.train_step, reps=10)
        top = sorted(per.items(), key=lambda kv: -kv[1])[:3]
        print(f"phase 30: {name} step: {step:.4f} ms, device {dev:.4f} ms "
              f"in {len(per)} kernels (torch.profiler, 10 steps), idle "
              f"{1 - dev / step:.3f}; largest: " + "; ".join(
                  f"{k[:60]} {v:.4f}" for k, v in top), flush=True)
        if name.startswith("ConvAE"):
            codes = tr.encode()
            z = tr._latent_of(codes).movedim(-1, 1).contiguous()
            with torch.no_grad(), conv_flags():
                out[f"{name} encoder forward"] = cuda_ms(
                    lambda: tr.encoder(tr.image))
                out[f"{name} decoder forward"] = cuda_ms(
                    lambda: tr.decoder(z))
            out[f"{name} encode"] = cuda_ms(tr.encode)
            out[f"{name} decode"] = cuda_ms(lambda: tr.decode(codes))
        elif name == "Pixel 512²":
            codes = tr.encode()
            lat = tr._latent_of(codes)
            with torch.no_grad():
                out[f"{name} folded decode"] = cuda_ms(
                    lambda: tr.decode_latent(lat))
            out[f"{name} decode"] = cuda_ms(lambda: tr.decode(codes))
    print("phase 30: times (ms, CUDA events, median): " + "; ".join(
        f"{k} {v:.4f}" + (f" ({1e3 / v:.1f} steps/s)"
                          if k.endswith("step") else "")
        for k, v in out.items()), flush=True)
    return out


def phase_conv_ae(device) -> dict:
    """The conv-AE and per-pixel family: serve, one step card vs CPU, the
    CLIs, times. No kernel of the port's: cuDNN's convolutions and
    cuBLAS's products, fp32 with no TF32, deterministic."""
    t0 = time.perf_counter()
    assets = _convae_assets()
    decode_ms = _convae_serve(assets)
    _convae_step(assets)
    cli = _convae_cli()
    times = _convae_times(assets)
    print(f"phase 30: conv-AE family passed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return dict(decode_ms=decode_ms, cli=cli, times=times)


# ---- phase 31: the mesh, 2 ranks on one card ------------------------------

# the NTC runs of phase 31: (kernel, label, CLI overrides, TRAIN_FORWARD,
# steps, the engine the mesh gates must pick, the train family)
MD_RUNS = (
    ("K11", "flagship 512² kernel3", TRAIN_ARGS, "kernel3", 20,
     "kernel3_sharded", "train_ff"),
    ("K12", "3D m3 64³ kernel3", MISTY, "kernel3", 10, "kernel3_sharded",
     "train_ff3"),
    ("K7", "path B 512² kernel2", PATH_B, "kernel2", 10, "kernel2_sharded",
     "train_mlp"),
)
MD_RANKS = 2  # at least; one a card where there are more cards
MD_SIZES = (2048, 256)  # the random models' 2D and 3D decode sizes
MD_FIRST, MD_RTOL = TRACK_FIRST, TRACK_RTOL  # the engines-vs-gather limits


def _md_ntc(mesh, args, engine, steps, counter) -> dict:
    """``steps`` train steps of a trainer of ``args`` on this rank (mesh
    None: one process) → losses, median step ms (CUDA events, steps 2 on),
    the kernel's wrapper launches and launch log over the steps, the engine
    and the params' digest; with a mesh also the ms of one all-reduce of
    the params' shapes over 'data'."""
    import torch

    from nic_torch.cli.image_compression import load_asset
    from nic_torch.config import parse_overrides
    from nic_torch.kernels import _build
    from nic_torch.parallel.mesh import check_replicated, pmean_
    from nic_torch.train.ntc import NTCTrainer

    cfg = parse_overrides(args + [f"TRAIN_FORWARD={engine}"])
    tr = NTCTrainer(cfg, load_asset(cfg), mesh=mesh)
    wrapper = _train_counters()[counter]
    wrapper.launches = 0
    _build.clear_body_launches()
    losses, events = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(tr.train_step()[0])
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    launches, bodies = wrapper.launches, _build.body_launches()
    s = tr.state
    params = list(s.fp) + [s.mlp[k] for k in NAMES]
    out = dict(losses=[float(v) for v in losses], launches=launches,
               bodies=bodies, engine=tr._forward_mode,
               ms=statistics.median(a.elapsed_time(b) for a, b in events[1:]),
               digest=check_replicated(params, mesh))
    if mesh is not None:
        grads = [torch.zeros_like(p) for p in params]
        out["reduce_ms"] = cuda_ms(lambda: pmean_(grads, mesh, "data"))
    return out


def _md_decodes(mesh, device) -> dict:
    """The kernel decodes through ``nic_torch.kernels.decode_sharded`` (one
    rank with mesh None) → {case: (digest of the whole output, shape)},
    the K1 and K5 launches, and the 2048² and 256³ decodes' ms."""
    import argparse

    import torch

    from nic_torch.cli.decode import _artifact
    from nic_torch.kernels.decode_fused_3d import decode_kernel_3d
    from nic_torch.kernels.decode_fused_v2 import decode_kernel_2d
    from nic_torch.grids.pyramid import pyramid_mip_levels
    from nic_torch.kernels.decode_sharded import (
        decode_image_fused_sharded, decode_volume_fused_sharded)
    from nic_torch.parallel.mesh import params_digest

    def art(path):
        a = _artifact(argparse.Namespace(artifact=path, image_size=None),
                      device)
        kw = dict(mip_to_level=a["mip_to_level"],
                  pe_channels=a["pe_channels"], use_tri_pe=a["use_tri_pe"])
        if a["ndim"] == 3:
            kw["sparse_g0"] = a["sparse_g0"]
        return a["fp"], a["mlp"], a["image_size"], kw

    cases = {}
    fp, mlp, m2l = _random_flagship(device, MD_SIZES[0])
    big2, big3 = (f"K1 {MD_SIZES[0]}² random mip 0",
                  f"K5 {MD_SIZES[1]}³ random mip 0")
    cases[big2] = (decode_image_fused_sharded, fp, mlp, 0,
                   dict(image_size=MD_SIZES[0], mip_to_level=m2l,
                        pe_channels=6))
    fp, mlp, size, kw = art(ART)
    for mip in range(10):
        cases[f"K1 512² fixture mip {mip}"] = (
            decode_image_fused_sharded, fp, mlp, mip,
            dict(kw, image_size=size))
    fp, mlp, size, kw = art(ART3)
    for mip in range(7):
        cases[f"K5 64³ fixture mip {mip}"] = (
            decode_volume_fused_sharded, fp, mlp, mip,
            dict(kw, image_size=size))
    gen = torch.Generator(device="cpu").manual_seed(MD_SIZES[1])
    fp, mlp = _pyramid3(gen, device, MD_SIZES[1], False, no_mip=True)
    cases[big3] = (decode_volume_fused_sharded, fp, mlp, 0,
                   dict(image_size=MD_SIZES[1], pe_channels=6,
                        mip_to_level=pyramid_mip_levels(
                            MD_SIZES[1], MD_SIZES[1] // 4, True)))
    out = {}
    decode_kernel_2d.launches = decode_kernel_3d.launches = 0
    with torch.inference_mode():
        for name, (fn, fp, mlp, mip, kw) in cases.items():
            rec = fn(fp, mlp, mip, mesh, **kw)
            out[name] = (params_digest([rec]), tuple(rec.shape))
            del rec
    launches = {"K1": decode_kernel_2d.launches,
                "K5": decode_kernel_3d.launches}
    times = {}
    with torch.inference_mode():
        for name in (big2, big3):
            fn, fp, mlp, mip, kw = cases[name]
            times[name] = cuda_ms(lambda: fn(fp, mlp, mip, mesh, **kw),
                                  warmup=1, reps=5)
    return dict(digests=out, launches=launches, ms=times)


def _md_family(mesh, device) -> dict:
    """One step of the hyperprior (phase 29's width, batch 8), movie-label
    (misty's 64 frames) and conv-AE trainers (sancho 512², misty 64³) on
    this rank → {trainer: (loss, reduced grads, params)} as numpy."""
    import numpy as np
    import torch

    from nic_torch.train.hyperprior import HyperpriorTrainer

    assets = _convae_assets()
    out = {}
    hp = HyperpriorTrainer(n=HP_N, m=HP_M, lam=HP_LAM, patch=HP_PATCH,
                           batch=HP_BATCH, device=device, mesh=mesh)
    staged = hp.stage_images(list(_hp_images().values())[:2])
    loss = float(hp.train_step(hp.sample_crops(staged))[0])
    ps = list(hp.model.parameters())
    out["hyperprior"] = (loss, [p.grad.cpu().numpy() for p in ps],
                         [p.detach().cpu().numpy() for p in ps])
    for name in ("ConvAE 2D 512²", "ConvAE 3D 64³", "MovieLabel 64×64²"):
        tr = _md_family_trainer(name, assets, mesh, device)
        loss = float(tr.train_step())
        out[name] = (loss, list(tr.grads_to_jax().values()),
                     list(tr.params_to_jax().values()))
        tr = None
        torch.cuda.empty_cache()
    return out


def _md_family_trainer(name, assets, mesh, device):
    from nic_torch.train.conv_ae import ConvAETrainer
    from nic_torch.train.movie_label import MovieLabelTrainer

    if name == "ConvAE 2D 512²":
        return ConvAETrainer(assets["sancho"], num_bits=4, num_epochs=1000,
                             device=device, mesh=mesh)
    if name == "ConvAE 3D 64³":
        return ConvAETrainer(assets["misty"], num_bits=8, latent_channels=16,
                             hidden_channels=32, num_epochs=1000,
                             device=device, mesh=mesh)
    return MovieLabelTrainer(assets["misty"], num_bits=8, num_epochs=1000,
                             device=device, mesh=mesh)


def _md_all(mesh, device) -> dict:
    """Phase 31's work on one rank (or, mesh None, in one process), each
    part's wall time beside it."""
    import torch

    from nic_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cuda":
        _build.load()
    out, wall = {}, {}
    for kernel, _, args, engine, steps, _, _ in MD_RUNS:
        t0 = time.perf_counter()
        out[kernel] = _md_ntc(mesh, args + [f"DEVICE={device}"], engine,
                              steps, kernel)
        wall[kernel] = time.perf_counter() - t0
    for part, fn in (("decodes", _md_decodes), ("family", _md_family)):
        t0 = time.perf_counter()
        out[part] = fn(mesh, device)
        wall[part] = time.perf_counter() - t0
    out["wall"] = wall
    out["backend"] = None if mesh is None else mesh.backend
    return out


def _md_leaves(tag, got, want, bad) -> None:
    """One trainer's step on the mesh against one rank: phase 29/30's
    limits (loss rel, worst leaf's grad max|Δ|/max|g|, params max|Δ|)."""
    import numpy as np

    (l1, g1, p1), (l0, g0, p0) = got, want
    loss = abs(l1 - l0) / abs(l0)
    grad = max(float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                                 1e-30)
               for a, b in zip(g1, g0))
    param = max(float(np.abs(a - b).max()) for a, b in zip(p1, p0))
    print(f"phase 31 (d): {tag}: loss {l1:.6f} vs "
          f"{l0:.6f} (rel {loss:.2e}), worst grad {grad:.2e}, params "
          f"{param:.2e}", flush=True)
    for key, val in (("loss", loss), ("grad", grad), ("param", param)):
        if not val <= HP_STEP_TOL[key]:
            bad.append(f"{tag} {key} {val:.2e} (limit {HP_STEP_TOL[key]})")


def phase_multidevice(device) -> dict:
    """Two ranks on the one card (``torch.distributed`` over gloo: NCCL
    refuses two ranks on one device), or one rank a card over NCCL where
    there are more cards, spawned by ``nic_torch.parallel.mesh.run_ranks``,
    against the same work in this process on one rank: (a)-(b) the NTC runs of MD_RUNS, (c) the sharded
    K1/K5 decodes, (d) one step of the hyperprior, conv-AE and movie-label
    trainers. Returns each kernel's launches per rank."""
    import numpy as np

    from nic_torch.parallel.mesh import run_ranks

    import torch

    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    world = max(MD_RANKS, torch.cuda.device_count())
    t0 = time.perf_counter()
    ranks = run_ranks(_md_all, world, device, device=device)
    t_ranks = time.perf_counter() - t0
    t1 = time.perf_counter()
    one = _md_all(None, device)
    t_one = time.perf_counter() - t1
    bad = []
    for kernel, label, _, _, steps, engine, family in MD_RUNS:
        want_body = _want_body(family, 64, "bf16")
        got = [r[kernel] for r in ranks]
        ref = one[kernel]
        for r, g in enumerate(got):
            named = _bodies_named([b for b, n in g["bodies"].items() if n])
            if (g["engine"] != engine or g["launches"] != steps
                    or want_body not in named):
                bad.append(f"{label} rank {r}: engine {g['engine']}, "
                           f"{g['launches']} {kernel} launches of {steps}, "
                           f"launch log {sorted(named)}")
        if len({g["digest"] for g in got}) != 1:
            bad.append(f"{label}: params differ across ranks "
                       f"{[g['digest'] for g in got]}")
        first = abs(got[0]["losses"][0] - ref["losses"][0]) / abs(
            ref["losses"][0])
        rel = np.abs(np.array(got[0]["losses"]) - ref["losses"]) / np.abs(
            ref["losses"])
        print(f"phase 31 (a/b): {label}: {engine} on each of {world} "
              f"ranks ({got[0]['launches']} {kernel} launches a rank, "
              f"launch log {sorted(_bodies_named(got[0]['bodies']))}), "
              f"params digest "
              f"{got[0]['digest']} on every rank; loss step 1 rel "
              f"{first:.2e}, steps 1-{steps} max rel {rel.max():.2e} vs one "
              f"rank; step ms median per rank "
              + "/".join(f"{g['ms']:.4f}" for g in got)
              + f" (one rank {ref['ms']:.4f}); all-reduce of the params' "
              f"shapes {got[0]['reduce_ms']:.4f} ms", flush=True)
        if not first <= MD_FIRST or not (rel <= MD_RTOL).all():
            bad.append(f"{label}: losses vs one rank step 1 {first:.2e}, "
                       f"max {rel.max():.2e}")
    dec = [r["decodes"] for r in ranks]
    for name, want in one["decodes"]["digests"].items():
        got = [d["digests"][name] for d in dec]
        if any(g != want for g in got):
            bad.append(f"{name}: sharded {got} vs one rank {want}")
    print(f"phase 31 (c): {len(dec[0]['digests'])} sharded decodes equal "
          f"bit for bit to one rank's (the 512² fixture's one-rank decode "
          f"is phase 4's, held to the JAX fold there); launches per rank "
          f"{dec[0]['launches']} (one rank {one['decodes']['launches']}); "
          + "; ".join(f"{k}: {dec[0]['ms'][k]:.4f} ms on {world} ranks, "
                      f"{one['decodes']['ms'][k]:.4f} on one"
                      for k in dec[0]["ms"]), flush=True)
    for name in one["family"]:
        _md_leaves(f"{name}, {world} ranks vs one", ranks[0]["family"][name],
                   one["family"][name], bad)
    print(f"phase 31: wall s per part, rank 0 / one rank: " + "; ".join(
        f"{k} {ranks[0]['wall'][k]:.1f}/{one['wall'][k]:.1f}"
        for k in one["wall"]) + f"; the spawn {t_ranks:.1f}, one rank "
        f"{t_one:.1f}; backend {ranks[0]['backend']}" + (
            " (ranks share the card's SMs: no scaling number)"
            if world > torch.cuda.device_count() else ""), flush=True)
    if bad:
        fail(f"phase 31: {bad}")
    print(f"phase 31: multidevice passed in {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    per = {k: ranks[0][k]["launches"] for k, *_ in MD_RUNS}
    per.update(ranks[0]["decodes"]["launches"])
    return per


# the phases by name, in the order a full run takes them
PHASES = ("parity", "serve", "scale", "k11", "k7", "k6", "train", "path_a",
          "path_b", "step_time", "k5", "serve3", "scale3", "k12", "k9",
          "k6_3d", "train3", "step_time3", "k3", "k4", "k2", "xla_cli",
          "folded", "widths", "small_cli", "rect", "hyperprior", "conv_ae",
          "multidevice")


# phases that launch no kernel of the port's
NO_KERNEL_PHASES = ("conv_ae",)


def main(argv=None) -> None:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--only", default=None,
        help="comma-separated phases to run after the build (of "
        f"{', '.join(PHASES)}); prints no kernels or result line")
    opts = parser.parse_args(argv)
    only = None if opts.only is None else opts.only.split(",")
    if only and set(only) - set(PHASES):
        fail(f"unknown phases {sorted(set(only) - set(PHASES))}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an "
             "NVIDIA GPU")
    try:
        import nic_torch  # noqa: F401
    except ImportError as e:
        fail(f"nic_torch is not importable next to chip_smoke.py: {e}")
    # state the float32 precision: full fp32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    print(f"phase 1: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    t0 = time.perf_counter()
    if not only or set(only) - set(NO_KERNEL_PHASES):
        phase_build()
    if only:
        for name in only:
            globals()[f"phase_{name}"]("cuda")
        print(f"phases {', '.join(only)} passed in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return
    main_err = phase_parity("cuda")
    k1_launches = phase_serve("cuda")
    timings = phase_scale("cuda")
    k11 = phase_k11("cuda")
    k7 = phase_k7("cuda")
    k6 = phase_k6("cuda")
    k11_launches = phase_train("cuda")
    k6_launches = phase_path_a("cuda")
    k7_launches = phase_path_b("cuda")
    steps = phase_step_time("cuda")
    k5_err = phase_k5("cuda")
    k5_launches = phase_serve3("cuda")
    k5_ms, k5_plain, k5_work = phase_scale3("cuda")
    k12 = phase_k12("cuda")
    k9 = phase_k9("cuda")
    phase_k6_3d("cuda")
    launches3 = phase_train3("cuda")
    steps3 = phase_step_time3("cuda")
    k3 = phase_k3("cuda")
    k4 = phase_k4("cuda")
    k2 = phase_k2("cuda")
    phase_xla_cli("cuda")
    phase_folded("cuda")
    phase_widths("cuda")
    phase_small_cli("cuda")
    phase_rect("cuda")
    hp = phase_hyperprior("cuda")
    phase_conv_ae("cuda")
    per_rank = phase_multidevice("cuda")
    k11_ms, k11_plain, k11_work = k11["timings"]["f=4 bf16·poly noise=on"]
    print(f"K11 share of the kernel3 step: {k11_ms / steps['kernel3']:.3f} "
          f"({k11_ms:.4f} of {steps['kernel3']:.4f} ms); K7 share of the "
          f"kernel2 step: {k7['bf16·poly'][0] / steps['kernel2']:.3f}; K6 "
          f"share of the kernel step: "
          f"{k6[(256, 'bf16·poly')][0] / steps['kernel']:.3f}", flush=True)
    k12_cell = "8×32³ f=4 m3 bf16·poly noise=on"
    print(f"K12 share of the 3D kernel3 step: "
          f"{k12[k12_cell][0] / steps3['kernel3']:.3f}; K9 share of the 3D "
          f"kernel2 step: {k9['bf16·poly'][0] / steps3['kernel2']:.3f}",
          flush=True)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def entry(name, source, replaces, launches, err, ms, plain, work, dtype):
        b_ms, b_by = bound(*work, dtype)
        got = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": err, "ms": ms, "plain_ms": plain,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        # the kernels phase 31's sharded paths launch: their launches on
        # each of its ranks
        key = {"decode_fused_v2": "K1", "decode_fused_3d": "K5",
               "train_fused_ff": "K11", "train_fused_ff3": "K12",
               "train_fused_ng": "K7"}.get(name)
        if key is not None:
            got["launches_per_rank"] = per_rank[key]
        return got

    # each at its path's shape and mode: K1 2048² fp32·exact; K11 8×256²
    # bf16·poly with noise; K6 8×32² (path A's largest launch) and K7
    # 8×256² (path B), bf16·poly; K5 256³ fp32·exact (its max|Δ| the worst
    # fp32·exact of phase 13); K12 8×32³ bf16·poly with noise and K9 8×32³
    # bf16·poly (the 3D protocol's LOD 0); K2, K3 and K4 at 2048²
    # fp32·exact, each with its fixture path's launches (mips 0-9); K1, K5,
    # K2, K3 and K4 take their fp32 dots as three TF32 products each
    # (tf32x3)
    print(json.dumps({"kernels": [
        entry("decode_fused_v2", KERNEL_SOURCE, REPLACES, k1_launches,
              main_err, *timings[2048][("fp32", "exact")], "tf32x3"),
        entry("train_fused_ff", K11_SOURCE, K11_REPLACES, k11_launches,
              k11["out_err"], k11_ms, k11_plain, k11_work, "bf16"),
        entry("train_fused_dx", K67_SOURCE, K6_REPLACES, k6_launches,
              k6[(32, "bf16·poly")][3], *k6[(32, "bf16·poly")][:3], "bf16"),
        entry("train_fused_ng", K67_SOURCE, K7_REPLACES, k7_launches,
              k7["bf16·poly"][3], *k7["bf16·poly"][:3], "bf16"),
        entry("decode_fused_3d", K5_SOURCE, K5_REPLACES, k5_launches,
              k5_err, k5_ms, k5_plain, k5_work, "tf32x3"),
        entry("train_fused_ff3", K12_SOURCE, K12_REPLACES, launches3["K12"],
              k12[k12_cell][3], *k12[k12_cell][:3], "bf16"),
        entry("train_fused_ng3", K67_SOURCE, K9_REPLACES, launches3["K9"],
              k9["bf16·poly"][3], *k9["bf16·poly"][:3], "bf16"),
        entry("decode_z1mm", K2_SOURCE, K2_REPLACES, k2["launches"],
              k2["err"], *k2["fp32"][:3], "tf32x3"),
        entry("decode_fused", K3_SOURCE, K3_REPLACES, k3["launches"],
              k3["err"], k3["ms"], k3["plain"], k3["work"], "tf32x3"),
        entry("mlp_tail", K4_SOURCE, K4_REPLACES, k4["launches"],
              k4["fp32"][3], *k4["fp32"][:3], "tf32x3"),
        entry("hs_bins", K13_SOURCE, K13_REPLACES, hp["launches"],
              hp["err"], hp["ms"], hp["plain"], hp["work"],
              "fp32_nofma")]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
