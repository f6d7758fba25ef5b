"""Share of the recorded steps' time with the card idle while the drive
thread waits in a decode step's flags read: the graph's own gaps between
kernels and the read's round trip (program spans on the device trace's
clock, exact overlap)."""

from port_bench import program_spans


def read(run):
    split = program_spans.idle_split(run)
    return None if split is None else split["wait"]
