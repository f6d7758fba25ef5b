"""Lumina-mGPT-7B SJD text-to-image (examples/generate_lumina_mgpt.py).

    python -m sjd_tpu_torch.examples.generate_lumina_mgpt \\
        --ckpt-dir ckpts/lumina_mgpt_768 --vq-ckpt ckpts/chameleon/tokenizer/vqgan.ckpt \\
        --prompt "A fluffy red panda" --target-size 768 --out out.png

Without --ckpt-dir the pipeline runs with random weights: prompting, SJD
decoding, the grammar and the VQ decode all run, and the image is noise.
``--num-repeats N`` tiles N images (seeds seed .. seed + N - 1) into one row.
"""

from __future__ import annotations

import argparse
import time

from ..loader import load_lumina_mgpt
from ..utils.image_io import write_png


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", default="A fluffy red panda sitting in a bamboo forest")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--vq-ckpt", default=None)
    ap.add_argument("--target-size", type=int, default=768)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--cfg", type=float, default=3.0)
    ap.add_argument("--image-top-k", type=int, default=2000)
    ap.add_argument("--scheme", default="speculative_jacobi",
                    choices=["speculative_jacobi", "jacobi"])
    ap.add_argument("--init", default="random",
                    choices=["random", "repeat_horizon", "sample_horizon"])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--quantize", nargs="?", const="8", default=None, choices=["4", "8"],
                    help="quantized weight serving: 8 = int8 W8A16, 4 = int4 W4A16")
    ap.add_argument("--num-repeats", type=int, default=1,
                    help=">1 tiles repeats into a grid (generate_examples/generate.py)")
    ap.add_argument("--out", default="lumina_sjd.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = load_lumina_mgpt(
        args.ckpt_dir, args.vq_ckpt, target_size=args.target_size, window=args.window,
        guidance_scale=args.cfg, image_top_k=args.image_top_k, scheme=args.scheme,
        init=args.init, seed=args.seed,
        quantize=int(args.quantize) if args.quantize else False, device=args.device)
    t0 = time.time()
    if args.num_repeats > 1:
        from ..data.item_processor import image_grid

        images = [model.sample_fn(args.prompt, rng_seed=args.seed + r)
                  for r in range(args.num_repeats)]
        image = image_grid(images, 1, args.num_repeats)
    else:
        image = model.sample_fn(args.prompt)
    print(f"Time elapsed: {time.time() - t0:.2f}s")
    write_png(args.out, image)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
