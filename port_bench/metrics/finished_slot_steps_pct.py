"""Share of the batcher's decode slot-steps spent on slots whose request
had finished and waited for the chunk's end, over the window's chunk
boundaries (the batcher's counters, sampled by the program's recorder).
Notes the requests' queue and service times and the rate of committed
tokens over the same boundaries (``program_spans.requests``)."""

from port_bench import program_spans


def read(run):
    tr = program_spans.tracer(run)
    if tr is None:
        return None
    got = program_spans.requests(tr)
    if got is not None:
        run.note("requests", got)
    return program_spans.finished_slot_steps_pct(tr)
