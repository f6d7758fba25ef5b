"""Frozen copies of what a served request's randomness is: its generator,
and the draws it makes, in their order.

A request's generator is seeded from its own seed alone (the batcher's
per-request seed: ``SeedSequence(seed)``'s first 64-bit word, shifted
right by one). It draws once for the prefill's token (``V`` uniforms), then
once per decode step, in this order: the fresh drafts (``W - 1`` integers in
the image range), the Gumbel noise of the window's samples (``W x V``
uniforms), the acceptance uniforms (``W - 1``) and the Gumbel noise of the
residual resample (``V`` uniforms). The Gumbel noise is ``-log(-log(u))``
with ``u`` floored at the smallest normal float32. The check draws the same
numbers again from the seed, on the same kind of device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

TINY = float(torch.finfo(torch.float32).tiny)


def generator_seed(seed: int) -> int:
    """The initial seed of the generator a request with ``seed`` gets."""
    state = np.random.SeedSequence(int(seed)).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


def gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u.clamp_min(TINY)))


@dataclasses.dataclass
class StepDraws:
    rand: torch.Tensor  # [W - 1] int64 fresh drafts
    g_tok: torch.Tensor  # [W, V] Gumbel noise of the window's samples
    u: torch.Tensor  # [W - 1] acceptance uniforms
    g_res: torch.Tensor  # [V] Gumbel noise of the residual resample


def draws(seed: int, steps: int, window: int, vocab: int, lo: int, hi: int,
          device) -> tuple:
    """(the prefill's Gumbel noise [V], an iterator of ``steps`` StepDraws)."""
    g = torch.Generator(device=device)
    g.manual_seed(generator_seed(seed))
    W, V = window, vocab
    g0 = gumbel(torch.rand((V,), generator=g, device=device))

    def it() -> Iterator[StepDraws]:
        for _ in range(steps):
            rand = torch.randint(lo, hi + 1, (W - 1,), generator=g, device=device)
            g_tok = gumbel(torch.rand((W, V), generator=g, device=device))
            u = torch.rand((W - 1,), generator=g, device=device)
            g_res = gumbel(torch.rand((V,), generator=g, device=device))
            yield StepDraws(rand, g_tok, u, g_res)
    return g0, it()
