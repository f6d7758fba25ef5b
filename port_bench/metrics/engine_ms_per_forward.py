"""Milliseconds inside the engine's calls per forward (prefills and
decode steps), over the steps with the profiler off (benchmark spans,
engine counters)."""


def read(run):
    q = run.window.quiet
    return 1000.0 * q.engine_s / q.forwards if q.forwards else None
