"""One real optimizer step of each trainer the port runs on a mesh, on
tiny shapes over N spawned ranks (the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``).

Run: ``python -m nic_torch.parallel.dryrun [N] [--device cuda|cpu]`` (N
ranks, 2 by default). ``--device`` defaults to ``cuda`` and raises
without a card; ``--device cpu`` runs the ranks on the CPU over gloo,
where each kernel runs its plain version. The mesh is (N/2, 2) for an even N > 1, else (N, 1), as
in JAX, so both axes take part: the kernel engines repeat over 'pixel'
and the gather engine splits each crop's pixels over it. Each step's
loss must be finite, the NTC engines the mesh gates' (gather,
kernel2_sharded, kernel3_sharded in 2D and 3D), the sharded decode the
whole image's shape, and the params equal on every rank after the step.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from nic_torch.parallel.mesh import check_replicated, run_ranks

__all__ = ["dryrun_multichip"]


def _steps(mesh, device: str) -> dict:
    """Every trainer's step on this rank → {name: (loss, engine, digest)}."""
    from nic_torch.config import CompressionConfig
    from nic_torch.models.mlp import PARAM_NAMES
    from nic_torch.train.conv_ae import ConvAETrainer
    from nic_torch.train.hyperprior import HyperpriorTrainer
    from nic_torch.train.movie_label import MovieLabelTrainer
    from nic_torch.train.ntc import NTCTrainer

    d = mesh.data
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (3, 32, 32)).astype(np.float32)
    vol = rng.uniform(0, 1, (3, 16, 16, 16)).astype(np.float32)
    small = dict(num_epochs=10, fp_bits=4, feature_pyramid_channels=4,
                 pe_channels=4, hidden_layer_channels=16, seed=0,
                 device=device)
    ntc = {
        "ntc gather": (dict(image_size=32, crop_mip_level=4,
                            num_crops=max(2 * d, 4), tf_no_mip=True,
                            train_forward="gather"), [img]),
        "ntc kernel2": (dict(image_size=32, crop_mip_level=4,
                             num_crops=max(2 * d, 4), tf_no_mip=True,
                             train_forward="kernel2", mlp_num_dtype=16),
                        [img]),
        "ntc kernel3": (dict(image_size=32, crop_mip_level=4,
                             num_crops=max(2 * d, 4), tf_no_mip=True,
                             train_forward="kernel3", mlp_num_dtype=16),
                        [img]),
        "ntc kernel3 3d": (dict(image_size=16, image_dimension=3,
                                compression_method=3, crop_mip_level=3,
                                num_crops=max(d, 2), max_mip_level=4,
                                train_forward="kernel3", mlp_num_dtype=16,
                                feature_pyramid_channels=2), [vol] * 5),
    }
    out = {}
    for name, (kw, images) in ntc.items():
        cfg = CompressionConfig(**{**small, **kw})
        tr = NTCTrainer(cfg, images, mesh=mesh)
        loss, _, lod = tr.train_step()
        s = tr.state
        out[name] = (float(loss), tr._plan(lod, s.frozen).mode,
                     check_replicated(list(s.fp) + [s.mlp[k] for k in
                                                     PARAM_NAMES], mesh))
    frames = rng.uniform(0, 1, (2 * d, 16, 16, 3)).astype(np.float32)
    mt = MovieLabelTrainer(frames, num_bits=4, num_epochs=4, device=device,
                           mesh=mesh)
    out["movie_label"] = (float(mt.train_step()), "frames",
                          check_replicated([p for p, _, _ in
                                            mt.leaves().values()], mesh))
    for name, asset in (
            ("conv_ae 3d", rng.uniform(0, 1, (4 * d, 16, 16, 3))),
            ("conv_ae sheet", rng.uniform(0, 1, (4 * d, 32, 3)))):
        ct = ConvAETrainer(asset.astype(np.float32), num_bits=4,
                           num_epochs=4, device=device, mesh=mesh)
        out[name] = (float(ct.train_step()), "halo",
                     check_replicated([p for p, _, _ in
                                       ct.leaves().values()], mesh))
    ht = HyperpriorTrainer(n=8, m=12, lam=0.01, patch=64, batch=2 * d,
                           seed=0, device=device, mesh=mesh)
    imgs = [rng.uniform(0, 1, (96, 96, 3)).astype(np.float32)]
    lh, _, _ = ht.train_chunk(ht.stage_images(imgs), 1)
    out["hyperprior"] = (float(lh[0]), "batch",
                         check_replicated(list(ht.model.parameters()), mesh))
    out["decode"] = _decode(mesh, device)
    return out


def _decode(mesh, device: str) -> tuple:
    """The row-sharded K1 decode of a random 64² model → (shape, whole
    decode equal)."""
    from nic_torch.grids.pyramid import create_pyramid, pyramid_mip_levels
    from nic_torch.kernels.decode_fused_v2 import decode_image_fused_v2
    from nic_torch.kernels.decode_sharded import decode_image_fused_sharded
    from nic_torch.models.mlp import init_mlp

    gen = torch.Generator().manual_seed(7)
    fp, _ = create_pyramid(gen, (16, 16), 4, 8, 2, device=device)
    mlp = init_mlp(gen, 4 * 5 + 4 * 2 + 1, 16, 3, device=device)
    kw = dict(image_size=64, mip_to_level=pyramid_mip_levels(64, 16),
              pe_channels=4, use_tri_pe=True)
    with torch.no_grad():
        rec = decode_image_fused_sharded(fp, mlp, 0, mesh, **kw)
        whole = decode_image_fused_v2(fp, mlp, 0, **kw)
    return tuple(rec.shape), bool(torch.equal(rec, whole))


WANT_ENGINES = {"ntc gather": "gather", "ntc kernel2": "kernel2_sharded",
                "ntc kernel3": "kernel3_sharded",
                "ntc kernel3 3d": "kernel3_sharded"}


def dryrun_multichip(n_devices: int = 2, device: str = "cuda") -> dict:
    """The dry run over ``n_devices`` spawned ranks on ``device`` (the
    card by default; ``cuda`` without one raises); raises on a failed
    check; returns rank 0's {name: (loss, engine, params digest)}."""
    data_axis = (n_devices // 2 if n_devices % 2 == 0 and n_devices > 1
                 else n_devices)
    ranks = run_ranks(_steps, n_devices, device, device=device,
                      data_axis=data_axis,
                      threads=1 if device == "cpu" else None)
    first = ranks[0]
    for name, value in first.items():
        if name == "decode":
            if value != ((64, 64, 3), True):
                raise RuntimeError(f"sharded decode: {value}")
            continue
        loss, engine, digest = value
        if not np.isfinite(loss):
            raise RuntimeError(f"{name}: loss {loss}")
        if WANT_ENGINES.get(name, engine) != engine:
            raise RuntimeError(f"{name}: engine {engine}, not "
                               f"{WANT_ENGINES[name]}")
        if any(r[name] != value for r in ranks):
            raise RuntimeError(f"{name}: ranks disagree: "
                               f"{[r[name] for r in ranks]}")
    return first


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, nargs="?", default=2)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = p.parse_args()
    for key, val in dryrun_multichip(a.n, a.device).items():
        print(f"{key}: {val}")
    print(f"dry run over {a.n} ranks passed")
