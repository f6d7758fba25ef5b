"""What the engine did over a window, from the benchmark's records: the
prefill and decode forwards with their shapes and fills, the tokens
committed, the acceptance histogram and the seconds inside the engine."""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class Work:
    prefills: List[tuple] = dataclasses.field(default_factory=list)  # (S, P, head_rows)
    decodes: List[tuple] = dataclasses.field(default_factory=list)  # (n, S, T, fills_sum)
    tokens: int = 0  # generated tokens committed
    engine_s: float = 0.0
    wall_s: float = 0.0  # the steps' wall seconds
    hist: List[int] = dataclasses.field(default_factory=list)

    @property
    def forwards(self) -> int:
        return len(self.prefills) + sum(d[0] for d in self.decodes)

    def add_hist(self, h):
        if not self.hist:
            self.hist = [0] * len(h)
        self.hist = [a + b for a, b in zip(self.hist, h)]


def _fills(n: int, a: list, b: list, T: int, cfg_factor: int) -> list:
    """Rows read per sample summed over ``n`` forwards whose per-slot
    lengths grow linearly from ``a`` to ``b``: each forward reads the live
    cache (length - 1 rows) and its own window (T rows)."""
    per_slot = [n * ((x + y) / 2.0 - 1 + T) for x, y in zip(a, b)]
    return per_slot * cfg_factor


def from_calls(calls, T: int, cfg_factor: int, wall_s: float = 0.0) -> Work:
    """``recorder.Call`` records of a batcher's window."""
    w = Work(wall_s=wall_s)
    for c in calls:
        S = c.slots * cfg_factor
        w.engine_s += c.t1 - c.t0
        w.add_hist(c.hist)
        if c.kind == "resume":
            n = c.nfe1 - c.nfe0
            w.decodes.append((n, S, T, _fills(n, c.len0, c.len1, T, cfg_factor)))
            w.tokens += sum(max(0, y - x) for x, y in zip(c.len0, c.len1))
        elif c.kind == "refill":
            w.prefills.append((S, c.prompt_rows, S))
            w.tokens += c.refilled
        else:  # a fresh batch: its prefill, then its first chunk
            w.prefills.append((S, c.prompt_rows, S))
            n = c.nfe1 - 1
            start = [c.prompt_rows + 1] * c.slots
            w.decodes.append((n, S, T, _fills(n, start, c.len1, T, cfg_factor)))
            w.tokens += sum(y - c.prompt_rows for y in c.len1)
    return w
