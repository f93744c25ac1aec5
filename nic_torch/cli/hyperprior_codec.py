"""Compress and decompress hyperprior bitstream files (.nicx) (port of
``nic.cli.hyperprior_codec``): image → one file → image, the file bound
to its checkpoint by a parameter digest, so a decode with another model
fails loudly. The files are the JAX package's format; the port's streams
decode on its CPU and on the card alike (K13's bins are the same bits on
both), but are not promised against JAX's (whose σ sums in XLA's order).

Run: the JAX CLI's flags plus ``--device`` (``cuda`` by default, which
raises without a card; ``--device cpu`` runs on the CPU), e.g.

    python -m nic_torch.cli.hyperprior_codec compress data/sancho_512.png \\
        --ckpt runs/ckpt/hyperprior_lam0.018_n96_m128 --out sancho.nicx
    python -m nic_torch.cli.hyperprior_codec decompress sancho.nicx \\
        --ckpt runs/ckpt/hyperprior_lam0.018_n96_m128 --out sancho_dec.png
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _load_codec(ckpt: str, n: int, m: int, device):
    from nic_torch.io.bitstream import params_digest
    from nic_torch.train.hyperprior import (HyperpriorCodec,
                                            HyperpriorTrainer, resolve_ckpt)

    trainer = HyperpriorTrainer(n=n, m=m, lam=0.0, patch=64, batch=1,
                                seed=0, device=device)
    ckpt = resolve_ckpt(ckpt)
    trainer.load_checkpoint(ckpt)  # raises on stored shapes that differ
    info = {"n": n, "m": m, "params_digest": params_digest(trainer.jax_tree()),
            "ckpt": os.path.basename(ckpt)}
    return HyperpriorCodec(trainer), info


def run(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("compress", help="image → .nicx bitstream")
    pc.add_argument("image")
    pc.add_argument("--out", default=None, help="default: <image>.nicx")
    pd = sub.add_parser("decompress", help=".nicx bitstream → image")
    pd.add_argument("bitstream")
    pd.add_argument("--out", default=None, help="default: <bitstream>.png")
    pd.add_argument("--allow_model_mismatch", action="store_true",
                    help="decode even if the checkpoint digest differs "
                         "(output will NOT match the encoded image)")
    for q in (pc, pd):
        q.add_argument("--ckpt", required=True,
                       help="checkpoint file or directory (newest used)")
        q.add_argument("--n", type=int, default=96)
        q.add_argument("--m", type=int, default=128)
        q.add_argument("--device", default="cuda",
                       help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    from nic_torch.train.hyperprior import resolve_device

    codec, info = _load_codec(args.ckpt, args.n, args.m,
                              resolve_device(args.device))
    if args.cmd == "compress":
        from nic_torch.data.assets import load_rgb
        from nic_torch.io.bitstream import write_nicx

        img = load_rgb(args.image)
        blob = codec.compress(img)
        out = args.out or (os.path.splitext(args.image)[0] + ".nicx")
        total = write_nicx(out, blob, info)
        px = img.shape[0] * img.shape[1]
        res = {"out": out, "bytes": total, "bpp": round(total * 8 / px, 4),
               "bpp_payload": round(codec.num_bits(blob) / px, 4)}
        print(f"wrote {out}: {total} bytes ({res['bpp']} bpp incl. header, "
              f"{res['bpp_payload']} payload)")
        return res

    from nic_torch.data.assets import save_png
    from nic_torch.io.bitstream import read_nicx

    blob, model = read_nicx(args.bitstream)
    if model.get("params_digest") != info["params_digest"]:
        msg = (f"{args.bitstream} was encoded by model "
               f"{model.get('params_digest')} (ckpt {model.get('ckpt')}), "
               f"but --ckpt resolves to {info['params_digest']}")
        if not args.allow_model_mismatch:
            raise ValueError(msg + " — pass --allow_model_mismatch to force")
        print("WARNING:", msg)
    rec = codec.decompress(blob)
    out = args.out or (os.path.splitext(args.bitstream)[0] + ".png")
    save_png((rec * 255.0 + 0.5).astype(np.uint8), out)
    print(f"wrote {out} ({rec.shape[0]}x{rec.shape[1]})")
    return {"out": out, "shape": list(rec.shape), "image": rec}


if __name__ == "__main__":
    run()
