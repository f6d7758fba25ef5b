"""Benchmark prompt sets and their static split across nodes and workers
(sjd_tpu/eval/datasets.py): PartiPrompts' TSV and MS-COCO captions (the
longest caption per image), split contiguously by (node, worker) with no
communication, so that a run resumes from the files it wrote.

The TSV is read with the standard ``csv`` module (no pandas on the machine
with the GPU), as ``pandas.read_csv(sep="\\t")`` reads it: a header row,
double-quoted fields with doubled quotes and tabs inside, blank lines
skipped, and pandas' default missing-value strings (``NA``, ``null``,
``nan``, an empty field, ...) given as ``"nan"``, the ``str`` of pandas'
NaN. One difference stays: pandas turns a column whose every value is a
number into numbers (``"1.50"`` into ``"1.5"``); here every prompt keeps
its text.
"""

from __future__ import annotations

import csv
import json
from dataclasses import dataclass
from typing import List, Sequence

# pandas' default missing values (pandas._libs.parsers.STR_NA_VALUES)
PANDAS_NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})


@dataclass
class PromptRecord:
    index: int  # global index (names the output file)
    prompt: str
    negative_prompt: str = ""


def load_parti_prompts(tsv_path: str, prompt_column: str = "Prompt") -> List[PromptRecord]:
    with open(tsv_path, newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f, delimiter="\t") if r]
    if not rows or prompt_column not in rows[0]:
        raise ValueError(f"{tsv_path}: no {prompt_column!r} column in the header")
    col = rows[0].index(prompt_column)
    prompts = [r[col] if col < len(r) else "" for r in rows[1:]]
    return [PromptRecord(index=i, prompt="nan" if p in PANDAS_NA_VALUES else p)
            for i, p in enumerate(prompts)]


def load_coco_captions(annotation_json: str) -> List[PromptRecord]:
    """captions_val*.json: keep the longest caption per image."""
    with open(annotation_json) as f:
        ann = json.load(f)
    per_image = {}
    for a in ann["annotations"]:
        cap = a["caption"].strip()
        img = a["image_id"]
        if img not in per_image or len(cap) > len(per_image[img]):
            per_image[img] = cap
    items = sorted(per_image.items())
    return [PromptRecord(index=i, prompt=c) for i, (_, c) in enumerate(items)]


def create_dataset(name: str, path: str) -> List[PromptRecord]:
    if "parti" in name.lower():
        return load_parti_prompts(path)
    if "coco" in name.lower():
        return load_coco_captions(path)
    raise ValueError(f"unknown dataset {name!r}")


def shard_prompts(
    records: Sequence[PromptRecord],
    *,
    node_id: int = 0,
    num_nodes: int = 1,
    worker_id: int = 0,
    num_workers: int = 1,
) -> List[PromptRecord]:
    """Contiguous split by node, then by worker, keeping global indices."""

    def split(seq, k, n):
        per = (len(seq) + n - 1) // n
        return list(seq[k * per : (k + 1) * per])

    return split(split(list(records), node_id, num_nodes), worker_id, num_workers)
