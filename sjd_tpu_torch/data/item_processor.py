"""FlexAR token layout for Lumina-mGPT (sjd_tpu/data/item_processor.py),
the parts the text-to-image path needs: the size token, splitting a
generation into text and image spans, and an image span back to its grid
of codebook ids. Tokenizer-backed prompting is not ported yet.

  image block = <image_start> <size h_grids> <size w_grids>
                (row of w_lat ids + <new_line>) x h_lat <image_end>
  size token id = 8804 + pixels // 32; latent dim = n_grids * 2
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..models.chameleon import IMAGE_END_ID, IMAGE_START_ID, NEW_LINE_ID, SIZE_TOKEN_BASE
from .vocab_translation import VocabMapping, bpe_to_img


def size_token_id(pixels: int, patch_size: int = 32) -> int:
    return SIZE_TOKEN_BASE + pixels // patch_size


def image_grid_from_block(tokens: Sequence[int],
                          mapping: Optional[VocabMapping] = None) -> np.ndarray:
    """Image token span (from <image_start>) -> [h, w] grid of ids, through
    ``mapping`` when given."""
    tokens = list(tokens)
    if tokens[0] != IMAGE_START_ID:
        raise ValueError("expected <image_start>")
    h_lat = (tokens[1] - SIZE_TOKEN_BASE) * 2
    w_lat = (tokens[2] - SIZE_TOKEN_BASE) * 2
    body = tokens[3:]
    rows = []
    for r in range(h_lat):
        row = body[r * (w_lat + 1): r * (w_lat + 1) + w_lat]
        if len(row) != w_lat:
            raise ValueError(f"truncated image at row {r}")
        eol = body[r * (w_lat + 1) + w_lat]
        if eol != NEW_LINE_ID:
            raise ValueError(f"missing <new_line> at row {r}: {eol}")
        rows.append(row)
    grid = np.asarray(rows, np.int32)
    if mapping is not None:
        grid = bpe_to_img(mapping, grid)
    return grid


def split_generation(tokens: Sequence[int]):
    """Split ids into ('text', [ids]) and ('image', [ids]) spans."""
    spans, cur = [], []
    tokens = list(tokens)
    i = 0
    while i < len(tokens):
        if tokens[i] == IMAGE_START_ID:
            if cur:
                spans.append(("text", cur))
            j = i
            while j < len(tokens) and tokens[j] != IMAGE_END_ID:
                j += 1
            spans.append(("image", tokens[i: j + 1]))
            cur, i = [], j + 1
        else:
            cur.append(tokens[i])
            i += 1
    if cur:
        spans.append(("text", cur))
    return spans
