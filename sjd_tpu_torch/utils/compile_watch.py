"""Start-up accounting (sjd_tpu/utils/compile_watch.py's counterpart).

The port compiles nothing through XLA. What a process pays before its
first image instead is the ``nvcc`` build of the kernel libraries
(``ops/_build.py``: a library named by its source hash is compiled once
into ``build/`` and loaded from there afterwards) and, on CUDA, each
engine's warm-up step and the capture of its decode step as a CUDA graph
(``core/engine.py``). The build and the engines add to process-global
counters:

- ``build_s``: wall seconds inside ``nvcc`` (the sources of one
  ``build_all`` compile in parallel and count once);
- ``builds``: libraries compiled;
- ``library_hits``: libraries loaded from ``build/`` without a compile;
- ``captures`` and ``capture_s``: CUDA-graph captures of the decode step
  and their wall seconds, summed over every engine (each engine's own
  ``GraphStats`` keeps its part);
- ``warmup_steps``: the eager decode steps that precede a capture.

Scope a measurement with :func:`snapshot` and :func:`delta`, as in the JAX
module; the counters only grow.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()
_ACC = {
    "build_s": 0.0,
    "builds": 0,
    "library_hits": 0,
    "captures": 0,
    "capture_s": 0.0,
    "warmup_steps": 0,
}


def add(**increments) -> None:
    """Add to the named counters (the build and the engines call this)."""
    with _LOCK:
        for k, v in increments.items():
            _ACC[k] += v


def snapshot() -> dict:
    """The current cumulative counters."""
    with _LOCK:
        return dict(_ACC)


def delta(since: dict) -> dict:
    """The counters accumulated since a :func:`snapshot`, seconds rounded
    for JSON."""
    cur = snapshot()
    out = {}
    for k, v in cur.items():
        d = v - since.get(k, 0)
        out[k] = round(d, 3) if isinstance(d, float) else d
    return out
