"""Tokens committed per live slot per decode forward in the window: the
engine's acceptance histogram over the window (SJD's gain)."""


def read(run):
    h = run.window.work.hist
    steps = sum(h)
    return sum(n * c for n, c in enumerate(h)) / steps if steps else None
