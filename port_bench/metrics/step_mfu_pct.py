"""Model operations of the forwards over the seconds of the steps traced
with the profiler off, against the H100's bf16 peak (989 TFLOP/s)."""

from port_bench.roofline import peaks, step


def read(run):
    q = run.window.quiet
    if q.wall_s <= 0 or not q.forwards:
        return None
    m = run.model
    flops = sum(step.prefill_flops(m, S, P, hr) for S, P, hr in q.prefills)
    for n, S, T, fills in q.decodes:
        flops += n * step.decode_flops(m, S, T, [f / max(n, 1) for f in fills])
    return 100.0 * flops / (q.wall_s * peaks.BF16_FLOPS)
