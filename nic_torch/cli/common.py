"""Shared scaffolding for the conv-AE / pixel workload CLIs (port of
``nic.cli.common``): the flags, the train loop with interval prints and
checkpoints, resume, and the PSNR reports.

The flags are the JAX CLIs' plus ``--device`` (``cuda`` by default, which
raises without a card; ``--device cpu`` runs on the CPU). Checkpoints and
latents keep the JAX CLIs' names and keys, so ``--resume`` and
``--resume_step`` read a checkpoint of either package.

``--data_parallel true`` under a launcher (``torchrun --nproc_per_node N
-m nic_torch.cli.image_comp --data_parallel true``) trains the conv-AE
workloads (image_comp, movie_frame_comp, movie_2d_comp, movie_3d_comp)
and the movie-label one over the ranks' mesh, one process a device
(:func:`start`); rank 0 alone writes the log, scalars, checkpoints,
latent and images. Without a launcher it runs one rank. The per-pixel
workloads have no mesh path, as in the JAX CLIs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from nic_torch.core.metrics import average_psnr, psnr
from nic_torch.obs.log import RunLog, ScalarWriter

__all__ = ["standard_parser", "resolve", "start", "is_main", "save_name",
           "run_training", "maybe_resume", "report_image", "report_video"]


def _flag(v: str) -> bool:
    return v.lower() in ("true", "1")


def standard_parser(description: str, **defaults) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--image_path",
                   default=defaults.get("image_path", "data/sancho_512.png"))
    p.add_argument("--num_epochs", type=int,
                   default=defaults.get("num_epochs", 1000))
    p.add_argument("--num_bits", type=int, default=defaults.get("num_bits", 8))
    p.add_argument("--image_size", type=int,
                   default=defaults.get("image_size", 512))
    p.add_argument("--latent_channels", type=int,
                   default=defaults.get("latent_channels", 8))
    p.add_argument("--hidden_channels", type=int,
                   default=defaults.get("hidden_channels", 16))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--train_model", type=_flag, default=True)
    p.add_argument("--save_model", type=_flag, default=True)
    p.add_argument("--resume", default=None,
                   help="checkpoint path to resume from")
    p.add_argument("--resume_step", type=int, default=None)
    p.add_argument("--interval_print", type=int, default=100)
    p.add_argument("--interval_checkpoint", type=int, default=100000)
    p.add_argument("--qat_ste", type=_flag, default=False)
    p.add_argument("--output_root", default="runs")
    p.add_argument("--data_parallel", type=_flag, default=False,
                   help="shard the frame/sheet-row axis over the ranks of a "
                        "launcher (torchrun), one process a device")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def resolve(args) -> torch.device:
    """The run's device (``cuda`` without a card raises)."""
    from nic_torch.train.hyperprior import resolve_device

    return resolve_device(args.device)


def start(args, name: str):
    """(device, mesh, log) of a run: with ``--data_parallel`` this rank's
    mesh under a launcher (None without one) and its device; the run's
    log on rank 0, a silent one on the other ranks."""
    from nic_torch.obs.log import make_filename_by_seq

    device, mesh = resolve(args), None
    if args.data_parallel:
        from nic_torch.parallel.mesh import init_from_env

        mesh = init_from_env(device)
        if mesh is not None:
            device = mesh.device
    if mesh is None or mesh.is_main:
        log = RunLog(make_filename_by_seq(
            os.path.join(args.output_root, "printlog"), f"{name}.txt"))
    else:
        log = RunLog(None, echo=False)
    if args.data_parallel:
        log("data parallel over mesh " + (
            str(mesh.shape) if mesh is not None else
            "{'data': 1, 'pixel': 1} (no launcher: one rank)"))
    return device, mesh, log


def is_main(trainer) -> bool:
    """Does this process write the run's files (no mesh, or rank 0)?"""
    mesh = getattr(trainer, "mesh", None)
    return mesh is None or mesh.is_main


def save_name(project: str, args) -> str:
    """The JAX CLIs' run name (``…_tpu_…``), kept so that the two packages'
    checkpoint and latent paths are the same."""
    base = os.path.basename(args.image_path)
    return f"{project}_tpu_{base}_{args.num_epochs}_{args.num_bits}"


def run_training(trainer, args, log: RunLog, writer: ScalarWriter | None,
                 project: str) -> None:
    """Steps from the trainer's step to ``--num_epochs``, a scalar and a
    time per step, a print every ``--interval_print`` and a checkpoint
    every ``--interval_checkpoint`` (named by the epoch, as JAX's), then
    the final checkpoint."""
    import time

    out_dir = os.path.join(args.output_root, "model")
    name = save_name(project, args)
    with log.span("train time"):
        for epoch in range(trainer.step, args.num_epochs):
            t0 = time.perf_counter()
            loss = float(trainer.train_step())
            step = epoch + 1
            if writer is not None:
                writer.add_scalar("Loss/train_epoch_label", loss, step)
                writer.add_scalar("Time/epoch_label",
                                  time.perf_counter() - t0, step)
            if step % args.interval_print == 0:
                log(f"Epoch [{step}/{args.num_epochs}], Loss: {loss:.4f}")
            if step % args.interval_checkpoint == 0 and is_main(trainer):
                trainer.save_checkpoint(
                    os.path.join(out_dir, f"{name}_{epoch}.ckpt.npz"))
    if is_main(trainer):
        trainer.save_checkpoint(os.path.join(out_dir, f"{name}.ckpt.npz"))
    if getattr(trainer, "mesh", None) is not None:
        trainer.mesh.barrier()


def maybe_resume(trainer, args, log: RunLog, project: str) -> None:
    """Restore params and Adam's state from ``--resume`` or the
    ``--resume_step`` checkpoint of this run's name."""
    path = args.resume
    if path is None and args.resume_step is not None:
        path = os.path.join(
            args.output_root, "model",
            f"{save_name(project, args)}_{args.resume_step}.ckpt.npz")
    if path:
        step = trainer.load_checkpoint(path)
        log(f"resumed from {path} at step {step}")


def _u8(rec) -> np.ndarray:
    return np.clip(np.asarray(rec) * 255.0, 0, 255).astype(np.uint8)


def report_image(log: RunLog, original_hw3: np.ndarray, rec_hw3: np.ndarray,
                 path_png: str | None) -> float:
    """Save the u8 reconstruction as PNG; log and return its PSNR (256-max,
    the reference's; and 255-max)."""
    rec_u8 = _u8(rec_hw3)
    if path_png:
        from nic_torch.data.assets import save_png

        save_png(rec_u8, path_png)
    a = torch.from_numpy(np.asarray(original_hw3, np.float32) * 255.0)
    b = torch.from_numpy(rec_u8.astype(np.float32))
    p = float(psnr(a, b))
    log(f"psnr: {p} (255-max: {float(psnr(a, b, max_value=255.0))})")
    return p


def report_video(log: RunLog, original_thw3: np.ndarray, rec_thw3: np.ndarray,
                 path_avi: str | None) -> float:
    """Save the u8 reconstruction as an uncompressed AVI; log and return
    the frames' average PSNR."""
    rec_u8 = _u8(rec_thw3)
    if path_avi:
        from nic_torch.data.assets import write_timelaps

        write_timelaps(rec_u8, path_avi)
    p = float(average_psnr(
        torch.from_numpy(np.asarray(original_thw3, np.float32) * 255.0),
        torch.from_numpy(rec_u8.astype(np.float32))))
    log(f"average psnr: {p}")
    return p
