"""Fine-tuning dataset over pre-tokenized record JSONs
(sjd_tpu/data/dataset.py).

  * a JSON meta (YAML when ``yaml`` imports) lists record files with an
    optional per-meta ``type`` and sampling ``ratio`` (read by
    ``data/sampler.py``);
  * records inline their tokens (``input_ids``) or name a pickle that
    ``data/pre_tokenize.py`` wrote (``file`` / ``token_file``);
  * an item that fails to load is retried with a random substitute.
"""

from __future__ import annotations

import json
import pickle
import random
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np


def load_meta(path: str) -> List[Dict[str, Any]]:
    """Meta file: [{"path": record.json, "type": "t2i", "ratio": 1.0}, ...],
    or a dict holding that list under "META" or "meta"."""
    with open(path) as f:
        text = f.read()
    try:
        metas = json.loads(text)
    except json.JSONDecodeError:
        import yaml  # type: ignore

        metas = yaml.safe_load(text)
    if isinstance(metas, dict):
        metas = metas.get("META", metas.get("meta", []))
    return metas


class FinetuneDataset:
    """Items are dicts with at least {"input_ids": [...], "labels": [...]}.
    The pickles it reads must come from this program's own pre-tokenization
    (unpickling runs code)."""

    def __init__(self, meta_path: str, *, max_retries: int = 5):
        self.records: List[Dict[str, Any]] = []
        self.types: List[str] = []
        self.ratios: Dict[str, float] = {}
        for meta in load_meta(meta_path):
            rtype = meta.get("type", "default")
            if "ratio" in meta:
                self.ratios[rtype] = float(meta["ratio"])
            with open(meta["path"]) as f:
                recs = json.load(f)
            for r in recs:
                self.records.append(r)
                self.types.append(rtype)
        self.max_retries = max_retries

    def __len__(self) -> int:
        return len(self.records)

    def lengths(self) -> List[int]:
        out = [int(r.get("len", len(r.get("input_ids", [])) or 1)) for r in self.records]
        # pre_tokenize always writes "len"; records without it count as
        # length 1, which defeats the sampler's length clustering
        n_fallback = sum(1 for r in self.records if "len" not in r and "input_ids" not in r)
        if n_fallback:
            warnings.warn(f"{n_fallback}/{len(out)} records lack a 'len' field; "
                          "length clustering will treat them as length 1")
        return out

    def _load(self, idx: int) -> Dict[str, Any]:
        rec = self.records[idx]
        if "input_ids" in rec:
            return {"input_ids": rec["input_ids"],
                    "labels": rec.get("labels", rec["input_ids"])}
        with open(rec.get("file") or rec.get("token_file"), "rb") as f:
            blob = pickle.load(f)
        return {"input_ids": blob["input_ids"], "labels": blob.get("labels", blob["input_ids"])}

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        for _ in range(self.max_retries):
            try:
                return self._load(idx)
            except Exception:  # any broken item is replaced, as the reference does
                time.sleep(0.1)
                idx = random.randrange(len(self.records))
        raise RuntimeError(f"failed to load any item after {self.max_retries} retries")


def pad_batch(items: List[Dict[str, Any]], pad_id: int = 0, max_len: Optional[int] = None):
    """Right-pad items to a rectangular batch: (ids int32, labels int32 with
    -100 on padding, mask bool), numpy arrays [B, L]."""
    L = max_len or max(len(it["input_ids"]) for it in items)
    B = len(items)
    ids = np.full((B, L), pad_id, np.int32)
    labels = np.full((B, L), -100, np.int32)
    mask = np.zeros((B, L), bool)
    for b, it in enumerate(items):
        n = min(len(it["input_ids"]), L)
        ids[b, :n] = it["input_ids"][:n]
        labels[b, :n] = it["labels"][:n]
        mask[b, :n] = True
    return ids, labels, mask
