"""An in-memory span recorder for the port's serving and decode paths.

Off by default. :func:`enable` turns it on, :func:`disable` off, and
:func:`drain` hands over what was recorded and clears it. While it is on,
the engine and the batcher record:

- spans, each a tuple ``(name, start_ns, end_ns, span_id, parent_id,
  thread_id, request)``: times from ``time.perf_counter_ns()``, the parent
  the innermost span open on the same thread when it was recorded (or
  None), ``request`` the request's index where the span belongs to one
  request (else None);
- counter samples ``(name, time_ns, value)`` taken at chunk boundaries
  (the counters themselves live where the port keeps them: the batcher's
  ``stats()``, the engine state's).

Cost when off: a span site is one check of :data:`ON` and allocates
nothing. On the per-step path the engine reads :data:`ON` once per call
and times its phases with :func:`now` and :func:`record`.

Nothing here calls ``torch.profiler.record_function``: the profiler
mirrors each such annotation onto the device timeline, where it would read
as busy time. To lay the spans over a profiler trace, map their times with
:meth:`Drained.to_profiler_ns`: :func:`enable` and :func:`drain` each take
an anchor pair linking this clock to the Unix clock that the profiler's
events carry (``start_ns``), and the mapping interpolates between the two.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import List, NamedTuple, Optional, Tuple

ON = False

_spans: list = []
_samples: list = []
_ids = itertools.count(1)  # next() on a count is atomic under the GIL
_local = threading.local()
_anchor: Optional[Tuple[int, int]] = None

now = time.perf_counter_ns


class Drained(NamedTuple):
    spans: List[tuple]  # (name, start_ns, end_ns, span_id, parent_id, thread_id, request)
    samples: List[tuple]  # (name, time_ns, value)
    anchors: List[Tuple[int, int]]  # (perf_counter_ns, unix ns) at enable and at drain

    def to_profiler_ns(self, t: float) -> float:
        """``t`` (perf_counter ns) on the profiler's clock (Unix ns)."""
        (p0, u0), (p1, u1) = self.anchors[0], self.anchors[-1]
        rate = (u1 - u0) / (p1 - p0) if p1 > p0 else 1.0
        return u0 + (t - p0) * rate


def _anchor_pair() -> Tuple[int, int]:
    """(perf_counter ns, Unix ns) read together: the Unix read between two
    perf reads, paired with their midpoint, from the tightest of a few."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, u)
    return best[1], best[2]


def enable() -> None:
    """Start recording (the anchor of this clock to the profiler's is
    taken here)."""
    global ON, _anchor
    _anchor = _anchor_pair()
    ON = True


def disable() -> None:
    global ON
    ON = False


def drain() -> Drained:
    """What was recorded since the last drain, with the anchors that map it
    onto the profiler's clock; the recorder is left empty, on or off as it
    was."""
    global _spans, _samples, _anchor
    spans, samples = _spans, _samples
    _spans, _samples = [], []
    end = _anchor_pair()
    anchors = [_anchor or end, end]
    _anchor = end
    return Drained(spans, samples, anchors)


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def record(name: str, t0: int, t1: int, request: Optional[int] = None) -> None:
    """A finished span from ``t0`` to ``t1`` (``now()`` values), child of the
    innermost span open on this thread."""
    s = _stack()
    _spans.append((name, t0, t1, next(_ids), s[-1] if s else None,
                   threading.get_ident(), request))


def lap(name: str, t0: int) -> int:
    """Record ``name`` from ``t0`` to now and return now: the start of the
    next phase, so that a chain of phases leaves no gap between them."""
    t1 = now()
    record(name, t0, t1)
    return t1


def sample(name: str, value) -> None:
    """A counter's value now."""
    _samples.append((name, now(), value))


class _Span:
    __slots__ = ("name", "request", "id", "t0")

    def __init__(self, name, request):
        self.name, self.request = name, request

    def __enter__(self):
        self.id = next(_ids)
        _stack().append(self.id)
        self.t0 = now()
        return self

    def __exit__(self, *exc):
        t1 = now()
        s = _stack()
        s.pop()
        _spans.append((self.name, self.t0, t1, self.id, s[-1] if s else None,
                       threading.get_ident(), self.request))
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, request: Optional[int] = None):
    """``with span(name):`` records the block as a span while tracing is
    on; spans recorded inside it, on the same thread, are its children."""
    return _Span(name, request) if ON else _OFF
