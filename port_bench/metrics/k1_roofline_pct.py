"""K1 (``quant_linear_kernel``): the bound of its launches in the traced
steps (each launch's larger of operations over 989 TFLOP/s and bytes over
3.35 TB/s, from the shapes) over their device time in the trace. The
launches traced are counted against the launches the steps ran."""

from port_bench.roofline import k1
from port_bench.trace import K1_NAMES


def read(run):
    if run.trace is None or run.window.active is None:
        return None
    secs, launches = run.trace.kernel_s(K1_NAMES)
    if not secs:
        return None
    a, m = run.window.active, run.model
    want = []
    for S, P, head_rows in a.prefills:
        want += k1.forward_launches(m, S * P, head_rows)
    for n, S, T, _ in a.decodes:
        want += k1.forward_launches(m, S * T, S * T) * n
    run.note("k1_launches", {"traced": launches, "expected": len(want)})
    # where the trace dropped some launches' records, the bound of the ones
    # it kept: the same share of the expected launches
    return 100.0 * k1.bound(want) * min(1.0, launches / len(want)) / secs
