"""Share of the recorded steps' time with the card idle while the drive
thread is at a chunk boundary: the batcher's harvest, admission and rows,
a prefill or a refill (program spans on the device trace's clock, exact
overlap). Notes the whole split: with the remainder under no such span
(``other``), the shares sum to ``device_idle_pct``."""

from port_bench import program_spans


def read(run):
    split = program_spans.idle_split(run)
    if split is None:
        return None
    run.note("idle_split", split)
    return split["boundary"]
