"""Share of the traced steps' time with no operation on the card: the
union of the device intervals of each recorded step's own timeline."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
