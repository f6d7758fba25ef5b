"""Emu3 prompts and output parsing (sjd_tpu/data/emu3_processor.py), at the
token level: a generation prompt is bos + text + <|image start|> +
ids("{H}*{W}") + <|image token|>; the output's visual tokens are read back
into the [h, w] grid, rows split on <|extra_200|> (eol)."""

from __future__ import annotations

import math
import warnings
from collections import Counter
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..models.emu3 import (
    BOI_ID, BOS_ID, EOF_ID, EOI_ID, EOL_ID, EOS_ID, IMG_ID, PAD_ID, VISUAL_END, VISUAL_START)

# the chat template of understanding mode
CHAT_PRE = "You are a helpful assistant. USER: "
CHAT_POST = ". ASSISTANT:"


def calculate_generate_size(ratio: str, image_area: int, spatial_factor: int = 8):
    """A "{W}:{H}" ratio and a pixel area -> the latent (h, w): one shared
    scale, each side rounded."""
    w_r, h_r = map(int, ratio.split(":"))
    target = math.sqrt(image_area / (w_r * h_r))
    return (int(round(h_r * target / spatial_factor)),
            int(round(w_r * target / spatial_factor)))


def build_gen_prompt(text_ids: Sequence[int], h: int, w: int,
                     tokenize: Callable[[str], Sequence[int]]) -> List[int]:
    """Generation prompt ids; ``tokenize`` encodes the "{H}*{W}" string."""
    return [BOS_ID, *text_ids, BOI_ID, *tokenize(f"{h}*{w}"), IMG_ID]


def image_ids_from_grid(grid: np.ndarray, *, eol_id: int = EOL_ID,
                        visual_start: int = VISUAL_START) -> List[int]:
    """[h, w] codebook ids -> visual-token ids with <eol> after every row."""
    out: List[int] = []
    for row in np.asarray(grid, np.int64):
        out.extend(int(c) + visual_start for c in row)
        out.append(eol_id)
    return out


def build_understanding_prompt(text: str, grid: np.ndarray,
                               tokenize: Callable[[str], Sequence[int]], *,
                               special: Optional[dict] = None) -> List[int]:
    """Understanding-mode prompt ids: bos + chat prefix + <boi> + "{H}*{W}" +
    <img> + the image's visual tokens (eol per row) + <eof> <eoi> + text +
    ". ASSISTANT:". ``special`` overrides the ids (toy vocabularies)."""
    s = special or dict(bos=BOS_ID, boi=BOI_ID, img=IMG_ID, eol=EOL_ID, eof=EOF_ID,
                        eoi=EOI_ID, visual_start=VISUAL_START)
    h, w = grid.shape
    return [s["bos"], *tokenize(CHAT_PRE), s["boi"], *tokenize(f"{h}*{w}"), s["img"],
            *image_ids_from_grid(grid, eol_id=s["eol"], visual_start=s["visual_start"]),
            s["eof"], s["eoi"], *tokenize(text + CHAT_POST)]


def visual_id_to_codebook(tok: int) -> int:
    return tok - VISUAL_START


def codebook_to_visual_id(code: int) -> int:
    return code + VISUAL_START


def extract_image_grid(tokens: Sequence[int]) -> np.ndarray:
    """Generated ids -> the [h, w] codebook grid: from after the
    <|image token|> marker (if present), rows split on <eol>, ending at
    eof/eoi/eos/pad or a stray text token; rows of the modal width kept
    (others dropped with a warning)."""
    toks = list(tokens)
    if IMG_ID in toks:
        toks = toks[toks.index(IMG_ID) + 1:]
    rows, cur = [], []
    for t in toks:
        if t == EOL_ID:
            rows.append(cur)
            cur = []
        elif t in (EOF_ID, EOI_ID, EOS_ID, PAD_ID):
            break
        elif VISUAL_START <= t <= VISUAL_END:
            cur.append(t - VISUAL_START)
        else:
            break
    if not rows:
        raise ValueError("no image rows found")
    w, _ = Counter(len(r) for r in rows).most_common(1)[0]
    kept = [r for r in rows if len(r) == w]
    if len(kept) < len(rows):
        warnings.warn(f"extract_image_grid: dropped {len(rows) - len(kept)} of "
                      f"{len(rows)} rows with width != {w} (malformed generation)")
    return np.asarray(kept, np.int32)
