"""Decode attention (split and merge kernels): the bound of its calls in
the traced steps, from the live fills read at the chunk boundaries (per
slot, linear between two boundaries), over their device time."""

from port_bench.roofline import attention
from port_bench.trace import ATTN_NAMES


def read(run):
    if run.trace is None or run.window.active is None:
        return None
    secs, launches = run.trace.kernel_s(ATTN_NAMES)
    if not secs:
        return None
    m, bound, calls = run.model, 0.0, 0
    for n, S, T, fills in run.window.active.decodes:
        if n:
            bound += n * attention.forward_bound(m, T, [f / n for f in fills])
            calls += 2 * n * m["NL"]
    run.note("attn_launches", {"traced": launches, "expected": calls})
    return 100.0 * bound * min(1.0, launches / calls) / secs if bound else None
