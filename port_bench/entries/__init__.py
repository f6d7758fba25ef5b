"""The entries a cell's window drives (``entry`` in its traffic mix):
``batcher`` (``StreamingBatcher``, closed-loop clients)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..account import Work


@dataclasses.dataclass
class Window:
    t_open: float
    t_close: float
    work: Work  # the whole window
    active: Optional[Work]  # the recorded steps only (None untraced)
    quiet: Work  # the steps with the profiler off (the whole window untraced)
    items: List[dict]  # what the timed path produced: prompt, neg, gen, seed,
    # prompt_rows, steps[, image]
    attempted: int
    failed: int
    peak_setup: int
    peak_window: int
    read_s: float = 0.0  # host seconds the trace reading took inside the window
    notes: dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open


def warm_image(cfg: dict, mix: dict) -> List[int]:
    """A whole image's tokens that the grammar admits (for the VQ warm-up)."""
    from ..reference.grammar import image_range, image_tokens, positions_forced

    n = image_tokens(cfg, mix)
    forced = positions_forced(cfg, mix, n)
    lo, hi = image_range(cfg)
    return [int(f) if f >= 0 else lo + (j * 7919) % (hi - lo + 1)
            for j, f in enumerate(forced)]
