"""Lumina-mGPT image-to-image SJD generation (examples/generate_image2image.py):
the prompt carries ``<|image|>`` placeholders; each is VQ-encoded, mapped
into the LM's image vocabulary and spliced as a FlexAR block.

    python -m sjd_tpu_torch.examples.generate_image2image \\
        --ckpt-dir ckpts/lumina_mgpt_768 --vq-ckpt ckpts/.../vqgan.ckpt \\
        --image input.png --prompt "Redraw <|image|> as an oil painting" \\
        --target-size 768 --out out.png

``--image`` is read by ``utils/image_io.read_image`` (a PNG without PIL; a
JPEG needs PIL) and resized to ``--input-size`` by ``resize_bicubic_uint8``
(PIL's bicubic, within 1 LSB). Without it the input is uniform noise from
``--seed``. Without ``--ckpt-dir`` the weights are random and the text goes
through :class:`HashTokenizer`.
"""

from __future__ import annotations

import argparse
import time
import zlib

import numpy as np

from ..loader import load_lumina_mgpt
from ..utils.image_io import read_image, resize_bicubic_uint8, write_png


class HashTokenizer:
    """Structure-only text stand-in for random-weight runs (no get_vocab, so
    the loader keeps the offset image mapping). It hashes with
    ``zlib.crc32``: the JAX script's ``hash()`` changes with every process."""

    def encode(self, text):
        h = zlib.crc32(text.encode())
        return [(h >> (4 * i)) % 4000 + 9000 for i in range(min(12, max(4, len(text) // 8)))]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", default="Redraw <|image|> with vivid colors")
    ap.add_argument("--image", default=None, help="input image path; random noise if absent")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--vq-ckpt", default=None)
    ap.add_argument("--tokenizer-dir", default=None)
    ap.add_argument("--target-size", type=int, default=512)
    ap.add_argument("--input-size", type=int, default=256,
                    help="input image is resized to this (multiple of 32)")
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--cfg", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--quantize", nargs="?", const="8", default=None, choices=["4", "8"],
                    help="quantized weight serving: 8 = int8 W8A16, 4 = int4 W4A16")
    ap.add_argument("--out", default="lumina_i2i.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.tokenizer_dir:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer_dir)
    else:
        tokenizer = HashTokenizer()
    model = load_lumina_mgpt(
        args.ckpt_dir, args.vq_ckpt, target_size=args.target_size, window=args.window,
        guidance_scale=args.cfg, seed=args.seed, tokenizer=tokenizer,
        quantize=int(args.quantize) if args.quantize else False, device=args.device)

    s = args.input_size
    if args.image:
        arr = resize_bicubic_uint8(read_image(args.image), (s, s))
        arr = arr.astype(np.float32) / 127.5 - 1.0
    else:
        rs = np.random.RandomState(args.seed)
        arr = rs.rand(s, s, 3).astype(np.float32) * 2 - 1

    t0 = time.time()
    image = model.extras["sample_i2i_fn"](args.prompt, [arr], rng_seed=args.seed)
    print(f"Time elapsed: {time.time() - t0:.2f}s")
    write_png(args.out, image)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
