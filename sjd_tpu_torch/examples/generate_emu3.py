"""Emu3-Gen SJD text-to-image (examples/generate_emu3.py).

    python -m sjd_tpu_torch.examples.generate_emu3 --ckpt-dir DIR --vq-ckpt-dir DIR \\
        --prompt "a portrait of young girl." --image-area 518400 --out out.png

The latent grid comes from ``--ratio`` and ``--image-area``; the loader's
default weights are int8 (W8A16) unless ``--quantize`` is given.
"""

from __future__ import annotations

import argparse
import time

from ..data.emu3_processor import calculate_generate_size
from ..loader import load_emu3
from ..utils.image_io import write_png


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", default="a portrait of young girl.")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--vq-ckpt-dir", default=None)
    ap.add_argument("--ratio", default="1:1")
    ap.add_argument("--image-area", type=int, default=720 * 720)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--cfg", type=float, default=3.0)
    ap.add_argument("--image-top-k", type=int, default=2048)
    ap.add_argument("--scheme", default="speculative_jacobi")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--quantize", nargs="?", const="8", default=None, choices=["4", "8"],
                    help="quantized weight serving: 8 = int8 W8A16, 4 = int4 W4A16")
    ap.add_argument("--out", default="emu3_sjd.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    h, w = calculate_generate_size(args.ratio, args.image_area)
    print(f"latent grid {h}x{w}")
    model = load_emu3(
        args.ckpt_dir, args.vq_ckpt_dir, h=h, w=w, window=args.window,
        guidance_scale=args.cfg, image_top_k=args.image_top_k, scheme=args.scheme,
        device=args.device,
        # the loader's default is int8 (the 8B's memory); 4 = int4 W4A16
        **({"quantize": int(args.quantize)} if args.quantize else {}))
    t0 = time.time()
    image = model.sample_fn(args.prompt, rng_seed=args.seed)
    print(f"Time elapsed: {time.time() - t0:.2f}s")
    write_png(args.out, image)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
