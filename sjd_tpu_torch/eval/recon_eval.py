"""Reconstruction evaluation of the VQ image tokenizers (examples/
recon_eval.py's counterpart): images -> encode -> decode -> the
reconstruction FID and PSNR against the originals, the image quality the
tokenizer itself loses.

Tokenizers: chameleon (the f16 taming VQGAN), llamagen (VQ-16, l2-normed
codebook), llamagen8 (VQ-8), emu3 (Emu3VisionVQ, f8). Without --vq-ckpt the
tokenizer is random (the whole flow runs on noise; the JSON says
smoke_weights). Features come from --inception-ckpt, from torchvision's
InceptionV3 where installed, or from the mean-pooled pixels
(--smoke-extractor, or when neither is there).

    python -m sjd_tpu_torch.eval.recon_eval --images DIR [--out DIR] \\
        [--tokenizer chameleon|llamagen|llamagen8|emu3] [--vq-ckpt PATH] \\
        [--size 256] [--inception-ckpt PATH | --smoke-extractor] [--device cuda]

Prints one JSON line: {"tokenizer", "n", "rfid", "psnr_db", "smoke_weights",
"smoke_extractor"}.

The pixel range is the JAX script's, on purpose, so that both give the
same numbers: ``load_image_dir`` returns [0, 1], which goes to the encoder
as it is (the tokenizers were trained on [-1, 1]), the reconstructions are
clipped to [-1, 1] only when written, and PSNR takes a peak-to-peak of 2.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .. import resolve_device


def make_roundtrip(args, dev):
    """(roundtrip(pixels [B, H, W, 3] numpy) -> reconstructions numpy,
    smoke_weights)."""
    from ..models import vq

    if args.tokenizer == "emu3":
        cfg = vq.EMU3_VQ
        if args.vq_ckpt:
            from ..utils.port import load_sharded_state

            params = vq.port_emu3_vq(load_sharded_state(args.vq_ckpt), cfg, device=dev)
        else:
            params = vq.init_emu3_vq_params(1, cfg, device=dev)
        from ..models.vq.emu3_vq import decode as emu3_decode
        from ..models.vq.emu3_vq import encode as emu3_encode

        def roundtrip(px):
            ids = emu3_encode(params, cfg, torch.as_tensor(px, device=dev))
            return emu3_decode(params, cfg, ids).float().cpu().numpy()

        return roundtrip, not args.vq_ckpt

    cfg = {"chameleon": vq.CHAMELEON_VQ, "llamagen": vq.LLAMAGEN_VQ16,
           "llamagen8": vq.LLAMAGEN_VQ8}[args.tokenizer]
    if args.vq_ckpt:
        from ..utils.port import load_torch_checkpoint

        style = "llamagen" if args.tokenizer.startswith("llamagen") else "chameleon"
        params = vq.port_vqgan(load_torch_checkpoint(args.vq_ckpt), cfg, style=style,
                               device=dev)
    else:
        params = vq.init_vq_params(0, cfg, device=dev)
    f = cfg.downsample_factor
    grid = (args.size // f, args.size // f)

    def roundtrip(px):
        ids = vq.encode(params, cfg, torch.as_tensor(px, device=dev))
        return vq.decode(params, cfg, ids.reshape(ids.shape[0], -1), grid).float().cpu().numpy()

    return roundtrip, not args.vq_ckpt


def main(argv=None) -> None:
    from ..utils.image_io import write_png
    from .metrics import (
        frechet_distance, load_image_dir, make_inception_extractor, make_pixel_extractor)

    ap = argparse.ArgumentParser()
    ap.add_argument("--images", required=True, help="directory of PNG/JPG")
    ap.add_argument("--out", default=None, help="save reconstructions here")
    ap.add_argument("--tokenizer", default="llamagen",
                    choices=["chameleon", "llamagen", "llamagen8", "emu3"])
    ap.add_argument("--vq-ckpt", default=None)
    ap.add_argument("--size", type=int, default=256,
                    help="resize to this square size")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--smoke-extractor", action="store_true")
    ap.add_argument("--inception-ckpt", default=None,
                    help="torch InceptionV3 checkpoint for the rFID through "
                         "eval/inception.py")
    ap.add_argument("--device", default="cuda",
                    help="the device that encodes, decodes and scores (cpu only when asked)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    roundtrip, smoke = make_roundtrip(args, dev)

    originals = load_image_dir(args.images, size=args.size)  # [N, H, W, 3] in [0, 1]
    with torch.no_grad():
        recons = np.concatenate([roundtrip(originals[i : i + args.batch])
                                 for i in range(0, len(originals), args.batch)])
    if recons.shape[1:3] != originals.shape[1:3]:
        # a --size the downsample factor does not divide gives a smaller
        # reconstruction: compare on the common grid
        h = min(recons.shape[1], originals.shape[1])
        w = min(recons.shape[2], originals.shape[2])
        recons = recons[:, :h, :w]
        originals = originals[:, :h, :w]

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for i, r in enumerate(recons):
            write_png(os.path.join(args.out, f"{i}.png"),
                      ((np.clip(r, -1, 1) + 1) * 127.5).astype(np.uint8))

    if args.inception_ckpt:
        from .inception import make_inception_extractor_from_ckpt

        feature_fn = make_inception_extractor_from_ckpt(args.inception_ckpt, device=dev)
    elif args.smoke_extractor:
        feature_fn = make_pixel_extractor()
    else:
        try:
            feature_fn = make_inception_extractor(device=dev)
        except RuntimeError:  # no torchvision: the pixel statistics, so marked
            feature_fn = make_pixel_extractor()
            args.smoke_extractor = True
    rfid = frechet_distance(feature_fn(originals), feature_fn(recons))
    mse = np.mean((recons - originals) ** 2)
    psnr = float(10 * np.log10(4.0 / max(mse, 1e-12)))  # peak-to-peak 2.0
    print(json.dumps({
        "tokenizer": args.tokenizer,
        "n": int(len(originals)),
        "rfid": round(float(rfid), 4),
        "psnr_db": round(psnr, 2),
        "smoke_weights": smoke,
        "smoke_extractor": bool(args.smoke_extractor),
    }))


if __name__ == "__main__":
    main()
