"""Host milliseconds per replayed decode step, from the end of its flags
read to the end of its replay call (the draws, their copy into the graph's
buffers and the launch): the median over the chunk steps with the profiler
off (program spans). Notes the p99 and the count, and the median over the
recorded steps, which the profiler inflates."""

from port_bench import program_spans


def read(run):
    tr = program_spans.tracer(run)
    if tr is None:
        return None
    quiet = sorted(program_spans.step_host_ms(tr, "quiet"))
    if not quiet:
        return None
    recorded = program_spans.step_host_ms(tr, "active")
    run.note("step_host_ms", {
        "steps": len(quiet), "p99": quiet[min(len(quiet) - 1, int(0.99 * len(quiet)))],
        "recorded_median": sorted(recorded)[len(recorded) // 2] if recorded else None})
    return quiet[len(quiet) // 2]
