"""Hyperprior rate–distortion codec workload (port of
``nic.cli.hyperprior_comp``): train R + λD on a directory of images, then
evaluate PSNR and bpp (the estimated rate and the real rANS bitstream's)
on an evaluation set.

Run: ``python -m nic_torch.cli.hyperprior_comp [--flags]`` with the JAX
CLI's flags plus ``--device`` (``cuda`` by default, which raises without a
card; ``--device cpu`` runs on the CPU), e.g.

    python -m nic_torch.cli.hyperprior_comp --train_dir data \\
        --eval_dir data --steps 20000 --lam 0.018
    python -m nic_torch.cli.hyperprior_comp --device cpu --n 8 --m 12 \\
        --patch 64 --batch 2 --steps 4 --interval_print 2

Checkpoints go to ``<output_root>/ckpt/hyperprior_lam<λ>_n<n>_m<m>/``
under the JAX trainer's keys (either package resumes the other's;
``--resume``); the evaluation JSON to
``<output_root>/hyperprior_lam<λ>_<steps>_eval.json``.
"""

from __future__ import annotations

import argparse
import datetime
import glob
import json
import os
import sys
import time

from nic_torch.obs.log import RunLog, ScalarWriter, make_filename_by_seq

_EXTS = ("*.png", "*.jpg", "*.jpeg")


def _paths(directory: str) -> list[str]:
    return sorted(q for e in _EXTS
                  for q in glob.glob(os.path.join(directory, e)))


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_dir", default="data")
    p.add_argument("--eval_dir", default="data")
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--lam", type=float, default=0.01)
    p.add_argument("--n", type=int, default=96)
    p.add_argument("--m", type=int, default=128)
    p.add_argument("--patch", type=int, default=256)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--interval_print", type=int, default=500)
    p.add_argument("--interval_checkpoint", type=int, default=2000)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint for this "
                        "(lam, n, m) config")
    p.add_argument("--output_root", default="runs")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    from nic_torch.data.assets import load_rgb
    from nic_torch.io.artifacts import CheckpointManager
    from nic_torch.train.hyperprior import (HyperpriorTrainer,
                                            eval_image_set, resolve_device)

    device = resolve_device(args.device)
    name = f"hyperprior_lam{args.lam}_{args.steps}"

    def out(*q):
        return os.path.join(args.output_root, *q)

    log = RunLog(make_filename_by_seq(out("printlog"), f"{name}.txt"))
    log(datetime.datetime.now())
    train_paths, eval_paths = _paths(args.train_dir), _paths(args.eval_dir)
    if not train_paths:
        raise FileNotFoundError(f"no images under {args.train_dir}")
    log(f"train images: {len(train_paths)}, eval images: "
        f"{len(eval_paths)}, device {device}")

    imgs = [load_rgb(q) for q in train_paths]
    # the patch must fit the smallest training image
    min_side = min(min(i.shape[0], i.shape[1]) for i in imgs)
    patch = min(args.patch, 1 << (min_side.bit_length() - 1))
    trainer = HyperpriorTrainer(n=args.n, m=args.m, lam=args.lam,
                                lr=args.lr, patch=patch, batch=args.batch,
                                seed=args.seed, device=device)
    writer = ScalarWriter(out("log", name), out("log", f"{name}_scalars.csv"))
    # step-count-agnostic key: a run resumes under a larger --steps
    ckpt_mgr = CheckpointManager(
        out("ckpt", f"hyperprior_lam{args.lam}_n{args.n}_m{args.m}"))
    if args.resume:
        for ckpt_path in ckpt_mgr.paths_newest_first():
            try:
                trainer.load_checkpoint(ckpt_path)
            except Exception as e:  # noqa: BLE001 — any unreadable snapshot
                log(f"checkpoint {ckpt_path} unreadable ({e!r}); trying "
                    "older")
                continue
            # the crop and noise stream restarts; statistically the same
            trainer.gen.manual_seed(args.seed + 1 + trainer.step)
            log(f"resumed from {ckpt_path} at step {trainer.step}")
            break

    staged = trainer.stage_images(imgs)
    with log.span("train time"):
        while trainer.step < args.steps:
            start = trainer.step
            n = min(args.interval_print - start % args.interval_print,
                    args.steps - start)
            next_ckpt = ((start // args.interval_checkpoint) + 1
                         ) * args.interval_checkpoint
            n = min(n, next_ckpt - start)
            t0 = time.perf_counter()
            lh, bh, mh = trainer.train_chunk(staged, n)
            dt = time.perf_counter() - t0
            for i in range(n):
                writer.add_scalar("Loss/rd", float(lh[i]), start + i + 1)
                writer.add_scalar("Rate/bpp", float(bh[i]), start + i + 1)
            step = trainer.step
            if step % args.interval_print == 0:
                log(f"step {step}/{args.steps} loss {float(lh[-1]):.4f} "
                    f"bpp {float(bh[-1]):.3f} mse {float(mh[-1]):.6f} "
                    f"({n / dt:.1f} steps/s)")
            if step % args.interval_checkpoint == 0:
                trainer.save_checkpoint(ckpt_mgr.path_for(step))
                ckpt_mgr.prune()

    res = eval_image_set(trainer, eval_paths, log)
    log(f"mean psnr {res['mean_psnr']:.2f}  mean bpp {res['mean_bpp']:.3f}  "
        f"mean bpp (bitstream) {res['mean_bpp_bitstream']:.3f}")
    res["checkpoint_dir"] = ckpt_mgr.directory
    with open(out(f"{name}_eval.json"), "w") as f:
        json.dump(res, f, indent=1)
    writer.close()
    log(datetime.datetime.now())
    return res


if __name__ == "__main__":
    run()
