"""Bytes the forwards of the steps traced with the profiler off have to
move through HBM (``roofline/step_bytes.py``: weights, scales, activations,
the embedding rows, the KV rows read and written) over their seconds x
3.35 TB/s: how far a step bound by its weight bytes is from streaming them
at the card's rate."""

from port_bench.roofline import peaks, step_bytes


def read(run):
    q = run.window.quiet
    if q.wall_s <= 0 or not q.forwards:
        return None
    m = run.model
    nbytes = sum(step_bytes.prefill_bytes(m, S, P, hr) for S, P, hr in q.prefills)
    for n, S, T, fills in q.decodes:
        if n:
            nbytes += n * step_bytes.decode_bytes(m, S, T, [f / n for f in fills])
    return 100.0 * nbytes / (q.wall_s * peaks.HBM_BYTES_S)
