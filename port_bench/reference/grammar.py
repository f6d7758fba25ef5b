"""The image grammar of each family, as a function of the generated
position j = 0, 1, ...: the forced token there (or -1 where any image token
may stand), and the image-token range.

lumina: offsets count after the header; rows of w tokens each closed by
<new_line>, then <image_end> at offset (w + 1) h.
emu3: p = j + 1 counted from the <image token> marker; <eol> where
p % (w + 1) == 0, then <eof>, <image end>, <eos> at (w + 1) h + 1, 2, 3.
"""

from __future__ import annotations

import numpy as np

from ..traffic.generator import grid


def image_range(cfg: dict) -> tuple:
    g = cfg["serving"]["grammar"]
    return g["image_vocab_start"], g["image_vocab_end"]


def image_tokens(cfg: dict, mix: dict) -> int:
    """Generated tokens of one whole image, the stop token included."""
    h, w = grid(cfg, mix)
    return (w + 1) * h + (1 if cfg["serving"]["grammar"]["kind"] == "lumina" else 3)


def positions_forced(cfg: dict, mix: dict, G: int) -> np.ndarray:
    g = cfg["serving"]["grammar"]
    h, w = grid(cfg, mix)
    j = np.arange(G)
    out = np.full(G, -1, np.int64)
    end = (w + 1) * h
    if g["kind"] == "lumina":
        out[(j + 1) % (w + 1) == 0] = g["newline_id"]
        out[j == end] = g["image_end_id"]
        return out
    if g["kind"] == "emu3":
        p = j + 1
        eol = p % (w + 1) == 0
        out[eol] = g["newline_id"]
        out[p == end + 1] = g["eof_id"]
        out[p == end + 2] = g["image_end_id"]
        out[p == end + 3] = g["eos_id"]
        out[(p > end + 3) & ~eol] = g["pad_id"]
        return out
    raise ValueError(f"unknown grammar kind {g['kind']!r}")


def image_codes(cfg: dict, mix: dict, gen) -> np.ndarray:
    """The served tokens of a whole image -> codebook ids [h, w]."""
    h, w = grid(cfg, mix)
    g = cfg["serving"]["grammar"]
    body = np.asarray(gen[: (w + 1) * h], np.int64).reshape(h, w + 1)[:, :w]
    return body - g["image_vocab_start"]


def interval_r(cfg: dict, mix: dict) -> int:
    """Where the window stops reaching ahead, in generated tokens: past it
    every step takes one token. Lumina's loader sets (px/16)^2 + px/16 - 10,
    Emu3's the image's rows less one token."""
    h, w = grid(cfg, mix)
    kind = cfg["serving"]["grammar"]["kind"]
    if kind == "lumina":
        g = mix["image_px"] // 16
        return g * g + g - 10
    if kind == "emu3":
        return h * (w + 1) - 1
    raise ValueError(f"unknown grammar kind {kind!r}")
