"""Length-clustered distributed batch sampler (sjd_tpu/data/sampler.py).

  * items grouped by dataset ``type``, each group up- or down-sampled by its
    ratio;
  * sorted by length and shuffled within buckets, so batches are
    length-homogeneous;
  * global units of (replicas x batch x grad_accum) items, shuffled as
    units, so each replica sees whole accumulation windows;
  * ``set_epoch(epoch, start_iter)`` resumes mid-epoch.

The stream is ``random.Random(seed + epoch)``, drawn in the JAX package's
order: both yield the same indices.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence


class LengthClusteredSampler:
    def __init__(
        self,
        lengths: Sequence[int],
        *,
        batch_size: int,
        num_replicas: int = 1,
        rank: int = 0,
        grad_accum: int = 1,
        bucket_size: int = 500,
        seed: int = 0,
        groups: Optional[Sequence[str]] = None,
        group_ratios: Optional[Dict[str, float]] = None,
    ):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} outside {num_replicas} replicas")
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.grad_accum = grad_accum
        self.bucket_size = bucket_size
        self.seed = seed
        self.groups = list(groups) if groups is not None else None
        self.group_ratios = group_ratios or {}
        self.epoch = 0
        self.start_iter = 0

    def set_epoch(self, epoch: int, start_iter: int = 0) -> None:
        self.epoch = epoch
        self.start_iter = start_iter

    def _indices_for_epoch(self) -> List[int]:
        rng = random.Random(self.seed + self.epoch)
        by_group: Dict[str, List[int]] = {}
        for i in range(len(self.lengths)):
            g = self.groups[i] if self.groups else "default"
            by_group.setdefault(g, []).append(i)

        selected: List[int] = []
        for g, idxs in by_group.items():
            ratio = self.group_ratios.get(g, 1.0)
            if ratio < 1.0:
                idxs = rng.sample(idxs, max(1, int(len(idxs) * ratio)))
            elif ratio > 1.0:
                whole = int(ratio)
                idxs = idxs * whole + rng.sample(idxs, int(len(idxs) * (ratio - whole)))
            selected.extend(idxs)

        selected.sort(key=lambda i: self.lengths[i])
        bucketed: List[int] = []
        for s in range(0, len(selected), self.bucket_size):
            bucket = selected[s:s + self.bucket_size]
            rng.shuffle(bucket)
            bucketed.extend(bucket)

        unit = self.num_replicas * self.batch_size * self.grad_accum
        units = [bucketed[u * unit:(u + 1) * unit] for u in range(len(bucketed) // unit)]
        rng.shuffle(units)
        return [i for u in units for i in u]

    def __iter__(self):
        flat = self._indices_for_epoch()
        unit = self.num_replicas * self.batch_size * self.grad_accum
        per_rank = self.batch_size * self.grad_accum
        out: List[int] = []
        for u in range(len(flat) // unit):
            block = flat[u * unit:(u + 1) * unit]
            out.extend(block[self.rank * per_rank:(self.rank + 1) * per_rank])
        # resume: skip start_iter optimizer iterations of batch * accum
        # items each
        return iter(out[self.start_iter * per_rank:])

    def __len__(self) -> int:
        unit = self.num_replicas * self.batch_size * self.grad_accum
        if self.group_ratios:
            flat_len = (len(self._indices_for_epoch()) // unit) * unit
        else:
            flat_len = (len(self.lengths) // unit) * unit
        return flat_len // self.num_replicas
