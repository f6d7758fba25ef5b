"""Offline pre-tokenization (sjd_tpu/data/pre_tokenize.py).

(caption, image-token grid) items become one pickle per item plus a record
JSON that ``data/dataset.py`` reads, sharded by (splits, rank) for parallel
runs; ``concat_records`` merges the shards' records.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Callable, Iterable, List, Sequence

import numpy as np

from .item_processor import conversation_prompt, image_block_from_grid, t2i_question


def shard_items(items: Sequence, splits: int, rank: int) -> Sequence:
    per = (len(items) + splits - 1) // splits
    return items[rank * per:(rank + 1) * per]


def tokenize_t2i_item(caption: str, grid_ids: np.ndarray, pixels: int,
                      encode_text: Callable[[str], List[int]], sep_id: int,
                      mapping=None) -> dict:
    """Conversation [question, image answer]: the prompt's labels are -100;
    ``mapping`` (a ``VocabMapping``) turns codebook ids into the LM's image
    tokens."""
    q = conversation_prompt([[t2i_question(caption, pixels, pixels), None]])
    prompt_ids = list(encode_text(q))
    image_ids = image_block_from_grid(grid_ids, pixels, pixels, mapping=mapping) + [sep_id]
    input_ids = prompt_ids + image_ids
    labels = [-100] * len(prompt_ids) + image_ids
    return {"input_ids": input_ids, "labels": labels, "len": len(input_ids)}


def run_pretokenize(items: Iterable[dict], out_dir: str, *,
                    encode_text: Callable[[str], List[int]], pixels: int = 768,
                    sep_id: int = 8710, splits: int = 1, rank: int = 0, mapping=None) -> str:
    """items: {"caption": str, "grid": [h, w] ids}. Writes
    files/{rank}-{i}.pkl and records-{rank}.json; returns the record path."""
    os.makedirs(os.path.join(out_dir, "files"), exist_ok=True)
    records = []
    for i, item in enumerate(shard_items(list(items), splits, rank)):
        tok = tokenize_t2i_item(item["caption"], np.asarray(item["grid"]), pixels,
                                encode_text, sep_id, mapping=mapping)
        path = os.path.join(out_dir, "files", f"{rank}-{i}.pkl")
        with open(path, "wb") as f:
            pickle.dump(tok, f)
        records.append({"file": path, "len": tok["len"]})
    rec_path = os.path.join(out_dir, f"records-{rank}.json")
    with open(rec_path, "w") as f:
        json.dump(records, f)
    return rec_path


def concat_records(out_dir: str, splits: int) -> str:
    """Merge the per-rank record files into records.json."""
    merged = []
    for rank in range(splits):
        with open(os.path.join(out_dir, f"records-{rank}.json")) as f:
            merged.extend(json.load(f))
    path = os.path.join(out_dir, "records.json")
    with open(path, "w") as f:
        json.dump(merged, f)
    return path
