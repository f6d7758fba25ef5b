"""LlamaGen SJD image generation (examples/generate_llamagen.py).

    c2i: python -m sjd_tpu_torch.examples.generate_llamagen --model-type c2i --prompt 207
    t2i: python -m sjd_tpu_torch.examples.generate_llamagen --model-type t2i \\
             --prompt "a photo of a corgi" --t5-dir ckpts/flan-t5-xl

For c2i the prompt is the ImageNet class id. The port reads no
sentencepiece model, so ``--t5-dir`` needs a T5 tokenizer object, which a
command line cannot pass: the loader refuses it with its message. Without
``--t5-dir``, t2i has no caption encoder, as in the JAX script.
"""

from __future__ import annotations

import argparse
import time

from ..loader import load_llamagen
from ..utils.image_io import write_png


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", default="207")
    ap.add_argument("--gpt-ckpt", default=None)
    ap.add_argument("--vq-ckpt", default=None)
    ap.add_argument("--t5-dir", default=None)
    ap.add_argument("--gpt-model", default="GPT-XL")
    ap.add_argument("--model-type", default="c2i", choices=["c2i", "t2i"])
    ap.add_argument("--latent-size", type=int, default=16)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--cfg", type=float, default=7.5)
    ap.add_argument("--image-top-k", type=int, default=1000)
    ap.add_argument("--scheme", default="speculative_jacobi")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--quantize", nargs="?", const="8", default=None, choices=["4", "8"],
                    help="quantized weight serving: 8 = int8 W8A16, 4 = int4 W4A16")
    ap.add_argument("--out", default="llamagen_sjd.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = load_llamagen(
        args.gpt_ckpt, args.vq_ckpt, name=args.gpt_model, latent_size=args.latent_size,
        model_type=args.model_type, window=args.window, guidance_scale=args.cfg,
        image_top_k=args.image_top_k, scheme=args.scheme, t5_dir=args.t5_dir,
        quantize=int(args.quantize) if args.quantize else False, device=args.device)
    t0 = time.time()
    image = model.sample_fn(args.prompt, rng_seed=args.seed)
    print(f"Time elapsed: {time.time() - t0:.2f}s")
    write_png(args.out, image)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
