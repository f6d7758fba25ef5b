"""The entries a cell's window drives (``entry`` in its traffic mix):
``batcher`` (``StreamingBatcher``, closed-loop clients) and ``solo`` (one
request at a time through ``SJDEngine.generate``), and what both share:
the window's chunk steps and the requests in flight at its close."""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

from ..account import Work, from_calls


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


class Chunks:
    """The window's chunk steps, boundary to boundary, as
    ``EngineProxy``'s ``on_boundary``: each step is quiet (the profiler
    off), warm or active (recorded) by the tracer, which is started at the
    opening boundary, stepped at each later one and stopped at the closing
    one. ``on_close`` runs at the closing boundary."""

    def __init__(self, rec, tracer, on_close=None):
        self.rec, self.tracer, self.on_close = rec, tracer, on_close
        self.steps = []  # (kind, t_start, t_end, calls) per chunk step of the window
        self._last = {}

    def __call__(self, px, now, closing):
        tracer, last = self.tracer, self._last
        i = len(px.calls)
        if not last:
            if tracer is not None:
                self.rec.annotate = True
                tracer.start()
        else:
            kind = ("quiet" if tracer is None or not tracer.profiled() else
                    "active" if tracer.active() else "warm")
            self.steps.append((kind, last["t"], now, px.calls[last["i"]:i]))
            if closing and self.on_close is not None:
                self.on_close()
            if tracer is not None:
                if closing:
                    tracer.stop()
                else:
                    tracer.step()
                # the trace reading is no part of the window: the next step
                # starts after it, and the window runs on for as long
                px.excluded_s = tracer.read_s
        last.update(i=i, t=time.perf_counter())

    def window(self, proxy, T: int, failed: int) -> Window:
        """The window's accounts (CFG: two rows a slot); no items yet."""
        steps, tracer, f = self.steps, self.tracer, 2
        quiet = [c for s in steps if s[0] == "quiet" for c in s[3]]
        active = [c for s in steps if s[0] == "active" for c in s[3]]
        return Window(
            t_open=proxy.t_open, t_close=proxy.t_close,
            work=from_calls(proxy.window_calls(), T, f, proxy.t_close - proxy.t_open),
            active=(from_calls(active, T, f,
                               sum(s[2] - s[1] for s in steps if s[0] == "active"))
                    if tracer is not None else None),
            quiet=from_calls(quiet, T, f, sum(s[2] - s[1] for s in steps if s[0] == "quiet")),
            items=[], attempted=0, failed=failed, peak_setup=proxy.peak_setup,
            peak_window=proxy.peak_window,
            read_s=tracer.read_s if tracer is not None else 0.0)


def in_flight(proxy, log, submitted, finished) -> List[dict]:
    """The requests still in the slots at the closing boundary, with the
    tokens they had committed then (``gen`` stops there): each slot's
    request is the one whose seed gave the slot's generator (the latest
    submitted, where a ring sends one seed again)."""
    from ..reference.sampling import generator_seed

    rows, lengths = proxy.final
    by_seed = {generator_seed(req.seed): (i, req) for i, req in submitted.items()}
    seen = {it["index"] for it in finished}
    out = []
    for b, n in enumerate(lengths):
        i, req = by_seed.get(log.seeds[-1][b] if log.seeds else None, (None, None))
        if req is None or i in seen:
            continue
        out.append(dict(index=i, prompt=req.prompt, neg=req.neg_prompt,
                        gen=[int(t) for t in rows[b][log.prompt_rows:n]], seed=req.seed,
                        image=None, in_flight=True))
        seen.add(i)
    return out
