"""The one traffic generator: requests from a mix's parameters and a seed.

A mix fixes the work that every seed shares: a pool of ``pool`` prompts
(lengths spread evenly over ``prompt_len``, text ids drawn once from the
mix), the image size and the load, and the requests: request k holds pool
prompt ``k % pool`` and a sampling seed (its generator's) drawn once from
k. The run's seed orders the first ``outstanding`` requests, the batcher's
first wave, each of which goes to its own slot; later ones follow in
their own order. So every seed sends the same requests, the first ones in
another order (another slot for each): SJD's acceptance follows each
request's prompt and sampled tokens, and requests drawn per seed change
the work in the window by 10% and more from seed to seed.

A mix with ``cycle`` sends a ring of ``cycle`` requests over and over:
request k is ring entry ``(start + k) % cycle``, whose prompt and seed
follow from that entry, and the run's seed picks ``start``. So one client
that sends one request after another runs the same ring from every seed,
beginning at another request.

Prompts follow the configuration's family: Lumina's placeholder text then
``<image_start> <size> <size>``; Emu3's ``<bos>`` text, suffix,
``<image start>``, size ids, ``<image token>``, against a negative prompt
fixed by the configuration.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

POOL_SEED = 20260418


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    prompt: List[int]  # real ids (no padding)
    neg_prompt: Optional[List[int]]
    seed: int  # the request's own generator seed


def grid(cfg: dict, mix: dict) -> tuple:
    """The image's latent grid (h, w) from its pixel size."""
    srv = cfg["serving"]
    factor = srv["vq"]["factor"] if "vq" in srv else srv["vq_factor"]
    side = mix["image_px"] // factor
    return side, side


def _lengths(mix: dict) -> List[int]:
    lo, hi = mix["prompt_len"]
    n = mix["pool"]
    return [int(round(lo + (hi - lo) * j / max(n - 1, 1))) for j in range(n)]


def max_prompt_len(cfg: dict, mix: dict) -> int:
    """The longest prompt the generator can draw: the batcher's bucket."""
    return len(_wrap(cfg, mix, [0] * mix["prompt_len"][1]))


def neg_prompt(cfg: dict, mix: dict) -> Optional[List[int]]:
    """The configuration's fixed negative prompt (neg_prompt CFG only)."""
    srv = cfg["serving"]
    if srv["cfg_mode"] != "neg_prompt":
        return None
    rng = np.random.default_rng(srv["neg_text_len"])
    lo, hi = srv["text_ids"]
    return _wrap(cfg, mix, rng.integers(lo, hi, srv["neg_text_len"]).tolist())


def _wrap(cfg: dict, mix: dict, text: List[int]) -> List[int]:
    srv = cfg["serving"]
    g = srv["grammar"]
    if srv["family"] == "lumina":
        size = g["size_token_base"] + mix["image_px"] // 32
        return list(text) + [g["image_start_id"], size, size]
    if srv["family"] == "emu3":
        lo, hi = srv["text_ids"]
        fixed = np.random.default_rng(7)  # the suffix and size ids: the same for all
        suffix = fixed.integers(lo, hi, srv["suffix_len"]).tolist()
        size = fixed.integers(lo, hi, srv["size_ids"]).tolist()
        return [srv["bos_id"], *text, *suffix, g["image_start_id"], *size, g["img_token_id"]]
    raise ValueError(f"unknown family {srv['family']!r}")


class Traffic:
    """Requests of one mix for one seed: ``request(i)`` for i = 0, 1, ..."""

    def __init__(self, cfg: dict, mix: dict, seed: int):
        self.cfg, self.mix, self.seed = cfg, mix, int(seed)
        lo, hi = cfg["serving"]["text_ids"]
        self.pool = []
        for j, n in enumerate(_lengths(mix)):
            rng = np.random.default_rng([POOL_SEED, j])
            self.pool.append(rng.integers(lo, hi, n).tolist())
        words = [self.seed & 0xFFFFFFFF, (self.seed >> 32) & 0xFFFFFFFF]
        self.first = np.random.default_rng(words + [1]).permutation(mix["outstanding"])
        self.cycle = mix.get("cycle")
        self.start = (int(np.random.default_rng(words + [2]).integers(self.cycle))
                      if self.cycle else 0)
        self.neg = neg_prompt(cfg, mix)

    def request(self, i: int) -> Request:
        k = int(self.first[i]) if i < len(self.first) else i
        if self.cycle:
            k = (self.start + k) % self.cycle
        seed = int(np.random.default_rng([POOL_SEED, 2, k]).integers(0, 2**31 - 1))
        return Request(index=i, prompt=_wrap(self.cfg, self.mix, self.pool[k % len(self.pool)]),
                       neg_prompt=self.neg, seed=seed)

    def warm_request(self) -> Request:
        """A request for the warm-up, outside the pool (its prompt at the
        bucket's width)."""
        lo, hi = self.cfg["serving"]["text_ids"]
        rng = np.random.default_rng([POOL_SEED, 10**6])
        text = rng.integers(lo, hi, self.mix["prompt_len"][1]).tolist()
        return Request(index=-1, prompt=_wrap(self.cfg, self.mix, text), neg_prompt=self.neg,
                       seed=int(rng.integers(0, 2**31 - 1)))
