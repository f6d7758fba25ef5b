"""VQGAN tokenizer training command line (examples/vq_train.py of the JAX
package): alternating generator and discriminator steps with LPIPS and
PatchGAN (:func:`.train.make_vqgan_train_steps`).

    python -m sjd_tpu_torch.models.vq.vq_train --images DIR --steps 2000 --size 128 \\
        [--vq-config llamagen|llamagen8|chameleon] [--disc-start 500] \\
        [--lpips-lins PATH_TO_vgg.pth] [--vgg-ckpt PATH] [--out CKPT_DIR]
    python -m sjd_tpu_torch.models.vq.vq_train --synthetic --steps 20   # offline smoke

It runs on ``--device`` (default ``cuda``; ``cpu`` on request). Images
(``.png``, ``.jpg``, ``.jpeg``, ``.webp``) are read by
``utils/image_io.read_image`` and resized by ``resize_bicubic_uint8``:
PNGs need no PIL, a JPEG or WEBP without PIL raises naming the file.
Without ``--lpips-lins``/``--vgg-ckpt`` the perceptual net is random (an
untrained-feature distance, not the calibrated LPIPS metric). Checkpoints
``{"params", "ema", "disc"}`` are written by ``utils/checkpoints.py`` every
``--save-every`` steps and at the end; one JSON line every ``--log-every``
steps carries the JAX script's keys.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np

IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".webp")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--vq-config", default="llamagen",
                    choices=["llamagen", "llamagen8", "chameleon"])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--disc-start", type=int, default=500)
    ap.add_argument("--disc-weight", type=float, default=0.5)
    ap.add_argument("--disc-loss", default="hinge",
                    choices=["hinge", "vanilla", "non-saturating"])
    ap.add_argument("--gen-loss", default="hinge",
                    choices=["hinge", "non-saturating"])
    ap.add_argument("--perceptual-weight", type=float, default=1.0)
    ap.add_argument("--adaptive-weight", action="store_true")
    ap.add_argument("--lpips-lins", default=None, help="taming vgg.pth")
    ap.add_argument("--vgg-ckpt", default=None, help="torchvision vgg16 state_dict")
    ap.add_argument("--out", default=None)
    ap.add_argument("--save-every", type=int, default=1000)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not (args.images or args.synthetic):
        ap.error("--images DIR or --synthetic")
    return args


def image_batches(images_dir: str, size: int, batch: int, rng: np.random.RandomState):
    """Batches [batch, size, size, 3] in [-1, 1] drawn with replacement only
    when the directory holds fewer images than a batch."""
    from ...utils.image_io import read_image, resize_bicubic_uint8

    files = [os.path.join(images_dir, f) for f in sorted(os.listdir(images_dir))
             if f.lower().endswith(IMAGE_SUFFIXES)]
    if not files:
        raise FileNotFoundError(f"no images under {images_dir}")
    data = np.stack([resize_bicubic_uint8(read_image(f), (size, size)).astype(np.float32)
                     / 127.5 - 1.0 for f in files])
    while True:
        idx = rng.choice(len(data), batch, replace=len(data) < batch)
        yield data[idx]


def synthetic_batches(size: int, batch: int, rng: np.random.RandomState):
    """Smooth random fields (image-like statistics, not pure noise)."""
    while True:
        x = rng.randn(batch, size // 4, size // 4, 3).astype(np.float32)
        x = np.repeat(np.repeat(x, 4, axis=1), 4, axis=2)
        yield np.tanh(x)


def patchgan_layers(size: int) -> int:
    """PatchGAN depth that leaves a non-empty patch map: 3 from 64 px."""
    return max(1, min(3, int(math.log2(max(size, 16))) - 3))


def lpips_params_for(args: argparse.Namespace, device) -> dict:
    from ...utils.port import load_torch_checkpoint
    from .lpips import init_lpips_params, port_lpips, port_vgg16_features

    if args.lpips_lins:
        return port_lpips(load_torch_checkpoint(args.lpips_lins),
                          load_torch_checkpoint(args.vgg_ckpt) if args.vgg_ckpt else None,
                          device=device)
    lpips_params = init_lpips_params(1, device=device)
    if args.vgg_ckpt:
        # VGG backbone only: trained features, random lins
        lpips_params["convs"] = port_vgg16_features(load_torch_checkpoint(args.vgg_ckpt),
                                                    device=device)
        lpips_params["calibrated"] = True
        print("vq_train: --vgg-ckpt without --lpips-lins: VGG features "
              "ported, LPIPS lins random (pass --lpips-lins for the "
              "calibrated taming weights)")
    elif args.perceptual_weight:
        print("vq_train: no --vgg-ckpt/--lpips-lins — the perceptual "
              "term uses RANDOM-init VGG features (smoke mode)")
    return lpips_params


def main(argv=None) -> None:
    args = parse_args(argv)
    import torch

    from ... import resolve_device
    from ...utils.checkpoints import make_manager, save
    from .discriminator import PatchGANConfig
    from .taming import CHAMELEON_VQ, LLAMAGEN_VQ8, LLAMAGEN_VQ16, init_vq_params
    from .train import VQTrainConfig, make_vqgan_train_steps

    dev = resolve_device(args.device)
    cfg = {"llamagen": LLAMAGEN_VQ16, "llamagen8": LLAMAGEN_VQ8,
           "chameleon": CHAMELEON_VQ}[args.vq_config]
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    tcfg = VQTrainConfig(
        learning_rate=args.lr, disc_start=args.disc_start, disc_weight=args.disc_weight,
        disc_loss=args.disc_loss, gen_adv_loss=args.gen_loss,
        perceptual_weight=args.perceptual_weight, disc_adaptive_weight=args.adaptive_weight,
        recon_loss="l2")
    lpips_params = lpips_params_for(args, dev)
    params = init_vq_params(args.seed, cfg, device=dev)
    n_layers = patchgan_layers(args.size)
    init_fn, g_step, d_step = make_vqgan_train_steps(
        cfg, tcfg, lpips_params=lpips_params, disc_cfg=PatchGANConfig(n_layers=n_layers))
    if n_layers < 3:
        print(f"vq_train: --size {args.size} < 64 — PatchGAN n_layers={n_layers}")
    g_opt, d_params, d_opt, ema = init_fn(params, 2)

    rng = np.random.RandomState(args.seed)
    batches = (image_batches(args.images, args.size, args.batch, rng) if args.images
               else synthetic_batches(args.size, args.batch, rng))

    def checkpoint(step: int) -> None:
        save(make_manager(args.out), step, {"params": params, "ema": ema, "disc": d_params})

    t0, saved = time.time(), None
    for step in range(args.steps):
        pixels = torch.from_numpy(next(batches)).to(dev)
        params, g_opt, ema, g_aux = g_step(params, g_opt, ema, d_params, pixels, step)
        d_params, d_opt, d_aux = d_step(d_params, d_opt, params, pixels, step)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(json.dumps({
                "step": step,
                "loss": round(float(g_aux["loss"]), 4),
                "recon": round(float(g_aux["recon"]), 4),
                "perceptual": round(float(g_aux["perceptual"]), 4),
                "gan_g": round(float(g_aux["gan_g"]), 4),
                "d_loss": round(float(d_aux["d_loss"]), 4),
                "usage": round(float(g_aux["usage"]), 4),
                "img_per_s": round(args.batch * (step + 1) / (time.time() - t0), 2),
            }), flush=True)
        if args.out and (step + 1) % args.save_every == 0:
            checkpoint(step + 1)
            saved = step + 1
    if args.out and saved != args.steps:
        checkpoint(args.steps)


if __name__ == "__main__":
    main()
