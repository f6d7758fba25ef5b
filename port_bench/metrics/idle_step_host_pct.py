"""Share of the recorded steps' time with the card idle while the drive
thread is inside a decode step's draws, their copy or the replay call
(program spans mapped onto the device trace's clock, exact overlap).
Notes the check of that mapping against the trace."""

from port_bench import program_spans


def read(run):
    split = program_spans.idle_split(run)
    if split is None:
        return None
    run.note("clock_check", program_spans.clock_check(run))
    return split["host"]
