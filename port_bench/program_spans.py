"""The program's own spans (``sjd_tpu_torch.utils.tracing``) laid over a
traced run's device timeline.

:class:`SpanTracer` is :class:`port_bench.trace.Tracer` with the program's
recorder on from the window's opening boundary to its closing one. Besides
what the plain tracer keeps, it holds what it drained there (``program``),
each chunk step's interval on the program's clock with whether the
profiler recorded it (``chunks``), the host's ``cudaGraphLaunch`` calls in
the recorded steps with the first and last device operation of each
(``launches``), and an anchor per synchronous device-to-host copy
(``anchors``): the host call's end and its device copy's end.

The trace's host events and the program's spans share one clock
(``tracing.Drained.to_profiler_ns``). Its device events need not: on an
H100 80GB HBM3 under torch 2.11 and CUDA 12.8 they drifted from the host
clock by 300 to 7500 ppm within a recorded step and jumped back at
resyncs, so that a copy's device end read up to a quarter of a second
from its host call's end. So a host time is carried onto the device
timeline through the anchors' offsets, interpolated between neighbours
(:func:`device_clock`).

The functions below read a :class:`port_bench.run.RunView`; each returns
None where the run's tracer holds no program spans (an untraced run, the
plain tracer, or a program without the recorder).

    python3 -m port_bench.program_spans --workload <cell> --seed <n> --seconds <s>

runs one traced run of a cell with :class:`SpanTracer` in place of the
plain tracer and prints its result line with :data:`METRICS` beside the
benchmark's own per-layer metrics (``run.py``'s ``tracer_for`` returns the
plain tracer, so ``run.py --trace 1`` does not read them).
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import time
from collections import Counter, defaultdict
from typing import List, Optional

import torch

from .trace import Tracer, _ns

HOST = ("engine.step.draws", "engine.step.copy", "engine.step.replay")
WAIT = "engine.step.wait"
CALLS = ("engine.generate", "engine.resume")

# the per-layer entries these readers serve, as BENCHMARK.json would list them
_A, _B = "lumina7b-w4a16.batch5-768", "emu3gen-w4a16.batch3-720"
METRICS = [
    {"name": "step_host_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "engine", "moves": "gen_tokens_per_s", "workloads": [_A, _B]},
    {"name": "idle_step_host_pct", "unit": "%", "better": "lower", "source": "device_trace",
     "layer": "engine", "moves": "gen_tokens_per_s", "workloads": [_A, _B]},
    {"name": "idle_step_wait_pct", "unit": "%", "better": "lower", "source": "device_trace",
     "layer": "engine", "moves": "gen_tokens_per_s", "workloads": [_A, _B]},
    {"name": "idle_boundary_pct", "unit": "%", "better": "lower", "source": "device_trace",
     "layer": "serving", "moves": "gen_tokens_per_s", "workloads": [_A, _B]},
    {"name": "finished_slot_steps_pct", "unit": "%", "better": "lower",
     "source": "program_counter", "layer": "serving", "moves": "gen_tokens_per_s",
     "workloads": [_A]},
]


def category(name: str) -> Optional[str]:
    """What the drive thread does inside a span of this name, for the idle
    split: the step's host work, its wait for the card, the chunk
    boundary, or None (counted in the remainder)."""
    if name in HOST:
        return "host"
    if name == WAIT:
        return "wait"
    if name.startswith("serving.") or name in ("engine.prefill", "engine.refill"):
        return "boundary"
    return None


class SpanTracer(Tracer):
    """The plain tracer, with the program's spans of the window."""

    def __init__(self, every: int, repeat: int):
        super().__init__(every, repeat)
        self.program = None  # tracing.Drained, after stop()
        self.chunks: List[tuple] = []  # (start_ns, end_ns, "quiet" | "warm" | "active")
        # (start_ns, end_ns, first_op_start_ns, last_op_end_ns) per cudaGraphLaunch
        self.launches: List[tuple] = []
        self.anchors: List[tuple] = []  # (host end ns, host end - device end ns) per copy
        self._t = 0

    def _close_chunk(self):
        from sjd_tpu_torch.utils import tracing

        kind = "active" if self.active() else "warm" if self.profiled() else "quiet"
        self.chunks.append((self._t, tracing.now(), kind))

    def start(self):
        from sjd_tpu_torch.utils import tracing

        tracing.drain()
        tracing.enable()
        super().start()
        self._t = tracing.now()

    def step(self):
        from sjd_tpu_torch.utils import tracing

        self._close_chunk()
        super().step()
        self._t = tracing.now()

    def stop(self):
        from sjd_tpu_torch.utils import tracing

        if self.prof is not None:
            self._close_chunk()
        super().stop()
        tracing.disable()
        self.program = tracing.drain()

    def _ready(self, p):
        super()._ready(p)
        t = time.perf_counter()
        calls, copies, ops = {}, {}, {}  # by correlation id: the host call, the device side
        for ev in p.profiler.kineto_results.events():
            name = ev.name()
            s = _ns(ev, "start")
            e = s + _ns(ev, "duration")
            if ev.device_type() == torch.autograd.DeviceType.CPU:
                if "GraphLaunch" in name or name.startswith("cudaMemcpy"):
                    calls[ev.correlation_id()] = (name, s, e)
                continue
            c = ev.correlation_id()
            if name.startswith("Memcpy DtoH") and "Pageable" in name:
                # a pageable copy returns to the host when its last part ends
                copies[c] = max(e, copies.get(c, e))
            lo, hi = ops.get(c, (s, e))
            ops[c] = (min(lo, s), max(hi, e))
        for c, (name, s, e) in calls.items():
            if "GraphLaunch" in name and c in ops:
                self.launches.append((s, e) + ops[c])
            elif c in copies:
                self.anchors.append((e, e - copies[c]))
        self.read_s += time.perf_counter() - t


def tracer(run) -> Optional[SpanTracer]:
    tr = getattr(run.trace, "tr", None) if run.trace is not None else None
    return tr if getattr(tr, "program", None) is not None else None


def drive_thread(spans) -> Optional[int]:
    """The thread that calls the engine."""
    tids = Counter(s[5] for s in spans if s[0] in CALLS)
    return tids.most_common(1)[0][0] if tids else None


def device_clock(tr: SpanTracer):
    """Host ns (the profiler's clock) -> the device events' clock: minus the
    anchors' offset, each the median of three neighbouring anchors' (a host
    call that returned late reads high), interpolated between anchors and
    held beyond them; the identity without anchors."""
    a = sorted(tr.anchors)
    hs = [h for h, _ in a]
    first = [max(0, min(i - 1, len(a) - 3)) for i in range(len(a))]
    offs = [statistics.median(o for _, o in a[j:j + 3]) for j in first]

    def to_device(h: float) -> float:
        if not hs:
            return h
        i = bisect.bisect_left(hs, h)
        if i == 0 or i == len(hs):
            return h - offs[min(i, len(hs) - 1)]
        w = (h - hs[i - 1]) / (hs[i] - hs[i - 1])
        return h - (offs[i - 1] + w * (offs[i] - offs[i - 1]))

    return to_device


def innermost(spans) -> List[tuple]:
    """(start, end, name) segments, each under the innermost of the nested
    ``(name, start, end)`` spans open over it, in order; time under no span
    has no segment."""
    out, stack, cur = [], [], None

    def close_until(t):
        nonlocal cur
        while stack and stack[-1][1] <= t:
            name, end = stack.pop()
            if end > cur:
                out.append((cur, end, name))
                cur = end

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        close_until(s)
        if stack and s > cur:
            out.append((cur, s, stack[-1][0]))
        cur = s
        stack.append((name, e))
    close_until(float("inf"))
    return out


def step_host_ms(tr: SpanTracer, kind: str = "quiet") -> List[float]:
    """Per decode step replayed in the chunks of ``kind``: host ms from the
    end of its flags read (the start of its draws) to the end of its
    replay call."""
    spans = tr.program.spans
    nxt = {(s[5], s[0], s[1]): s for s in spans if s[0] in HOST[1:]}
    chunks = sorted((a, b) for a, b, k in tr.chunks if k == kind)
    starts = [a for a, _ in chunks]
    out = []
    for s in spans:
        if s[0] != HOST[0]:
            continue
        i = bisect.bisect_right(starts, s[1]) - 1
        if i < 0 or s[1] > chunks[i][1]:
            continue
        copy = nxt.get((s[5], HOST[1], s[2]))
        replay = copy and nxt.get((s[5], HOST[2], copy[2]))
        if replay:
            out.append((replay[2] - s[1]) / 1e6)
    return out


def _split(windows, ops, segs) -> dict:
    """Idle time (ns) in ``windows`` outside the device ``ops``, split by
    the drive thread's innermost span ``segs`` (exact overlap)."""
    starts = [s[0] for s in segs]
    out, other = defaultdict(float), defaultdict(float)
    for lo, hi in windows:
        out["window"] += hi - lo
        cur = lo
        gaps = []
        for s, e in sorted((s, e) for s, e in ops if e > lo and s < hi):
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if hi > cur:
            gaps.append((cur, hi))
        for a, b in gaps:
            out["idle"] += b - a
            other["none"] += b - a
            i = max(bisect.bisect_right(starts, a) - 1, 0)
            while i < len(segs) and segs[i][0] < b:
                s, e, name = segs[i]
                if min(b, e) > max(a, s):
                    cat = category(name)
                    (out if cat else other)[cat or name] += min(b, e) - max(a, s)
                    other["none"] -= min(b, e) - max(a, s)
                i += 1
    window = out["window"] or 1.0
    shares = {k: 100.0 * out[k] / window for k in ("host", "wait", "boundary", "idle")}
    shares["other"] = shares["idle"] - shares["host"] - shares["wait"] - shares["boundary"]
    shares["other_by"] = {k: 100.0 * v / window for k, v in other.items() if v > 0}
    return shares


def idle_split(run) -> Optional[dict]:
    """Shares (%) of the recorded steps' time with the card idle, split by
    the drive thread's innermost span over each idle interval (exact
    overlap): ``host``, ``wait``, ``boundary`` (:func:`category`) and
    ``other``, the rest; ``idle`` is their sum, ``device_idle_pct``'s
    reading. ``other_by`` splits ``other`` by the innermost span's name
    ("none" where the drive thread is under no span of its own).

    The window is ``device_idle_pct``'s: each recorded step's host window
    (``ProfilerStep``) taken as it is onto the device events' clock, widened
    to its last device operation. ``device_window`` holds the same split
    over each step's host window carried through :func:`device_clock`, with
    every device operation inside it, and its length against the first
    (``window_ratio``)."""
    tr = tracer(run)
    view = run.trace
    if tr is None or view.window_s <= 0:
        return None
    tid = drive_thread(tr.program.spans)
    host, dev = tr.program.to_profiler_ns, device_clock(tr)

    def to(t):
        return dev(host(t))

    # the request spans cross the drive thread's own and are left out
    segs = [(to(a), to(b), n) for a, b, n in
            innermost([s[:3] for s in tr.program.spans
                       if s[5] == tid and s[0].startswith(("engine.", "serving."))])]
    shares = _split(view.spans, [(s, e) for _, s, e in view.dev], segs)
    moved = [(dev(lo), dev(hi)) for lo, hi in tr.steps]
    shares["device_window"] = _split(moved, [(s, e) for _, s, e in tr.device], segs)
    shares["device_window"]["window_ratio"] = (
        sum(b - a for a, b in moved) / (view.window_s * 1e9))
    return shares


def requests(tr: SpanTracer) -> Optional[dict]:
    """What the batcher's request spans and ``tokens_committed`` samples
    show over the window: the requests admitted (``queued``: median and
    largest ms from submit to a slot) and resolved (``served``: median s
    from a slot to the result), and ``committed_tokens_per_s``, the tokens
    committed between the first and the last boundary sampled (completed and
    in flight) over the time between them. None without a boundary."""
    got = [(t, v) for name, t, v in tr.program.samples if name == "tokens_committed"]
    if len(got) < 2 or got[-1][0] <= got[0][0]:
        return None
    out = {"committed_tokens_per_s": 1e9 * (got[-1][1] - got[0][1]) / (got[-1][0] - got[0][0])}
    for name, unit in (("queued", 1e6), ("served", 1e9)):
        d = sorted((s[2] - s[1]) / unit for s in tr.program.spans if s[0] == f"request.{name}")
        out[name] = {"n": len(d), "median": statistics.median(d) if d else None,
                     "max": d[-1] if d else None}
    return out


def clock_check(run) -> Optional[dict]:
    """How the program's spans line up with the trace, over the replayed
    steps of the recorded chunks that a flags read follows (the j-th replay
    span paired with the j-th ``cudaGraphLaunch`` of the recorded step):
    ``host_held_pct``, the share whose mapped replay span holds its launch
    call (both on the host's clock); ``raw_held_pct``, the share whose
    mapped replay span starts before the graph's first device operation
    and whose next flags read ends after its last, on the device events'
    own times; ``held_pct``, the same through :func:`device_clock`; and the
    anchors' offsets (5th percentile, median, 95th, us) and the median drift
    between neighbouring anchors (ppm)."""
    tr = tracer(run)
    if tr is None:
        return None
    tid = drive_thread(tr.program.spans)
    to, dev = tr.program.to_profiler_ns, device_clock(tr)
    mine = sorted((s for s in tr.program.spans if s[5] == tid and s[0] in (WAIT, HOST[2])),
                  key=lambda s: s[1])
    active = [(a, b) for a, b, k in tr.chunks if k == "active"]
    steps = host_held = raw_held = held = mismatched = 0
    for (a, b), (lo, hi) in zip(active, tr.steps):
        chunk = [s for s in mine if a <= s[1] <= b]
        replays = [i for i, s in enumerate(chunk) if s[0] == HOST[2]]
        launches = sorted(x for x in tr.launches if lo <= x[0] <= hi)
        if len(launches) != len(replays):
            mismatched += 1
            continue
        for i, (ls, le, first, last) in zip(replays, launches):
            if i + 1 >= len(chunk) or chunk[i + 1][0] != WAIT:
                continue
            r0, r1, w1 = to(chunk[i][1]), to(chunk[i][2]), to(chunk[i + 1][2])
            steps += 1
            host_held += r0 <= ls and le <= r1
            raw_held += r0 <= first and w1 >= last
            held += dev(r0) <= first and dev(w1) >= last
    out = {"steps": steps, "mismatched_chunks": mismatched}
    if steps:
        out.update(host_held_pct=100.0 * host_held / steps, raw_held_pct=100.0 * raw_held / steps,
                   held_pct=100.0 * held / steps)
    a = sorted(tr.anchors)
    if a:
        rates = [abs(o1 - o0) / (h1 - h0) for (h0, o0), (h1, o1) in zip(a, a[1:])
                 if h1 - h0 > 1e6]
        o = sorted(o for _, o in a)
        out.update(offset_us=[o[len(o) // 20] / 1e3, o[len(o) // 2] / 1e3,
                              o[-1 - len(o) // 20] / 1e3],
                   drift_ppm=1e6 * statistics.median(rates) if rates else None)
    return out


def finished_slot_steps_pct(tr: SpanTracer) -> Optional[float]:
    """The batcher's ``finished_slot_steps`` over its ``slot_steps``,
    between the first and the last chunk boundary sampled in the window."""
    got = defaultdict(list)
    for name, _, v in tr.program.samples:
        got[name].append(v)
    slot, fin = got["slot_steps"], got["finished_slot_steps"]
    if len(slot) < 2 or slot[-1] <= slot[0]:
        return None
    return 100.0 * (fin[-1] - fin[0]) / (slot[-1] - slot[0])


def main(argv=None) -> int:
    from . import run

    ap = argparse.ArgumentParser(description="one traced run with the program's spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    spec = run.load_spec(args.workload)
    spec["per_layer"] = spec["per_layer"] + [m for m in METRICS
                                             if args.workload in m["workloads"]]
    if not torch.cuda.is_available():
        print("port_bench.program_spans: no CUDA device", file=sys.stderr)
        return 2
    print(f"card: {run.device_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr)
    run.tracer_for = lambda mix: SpanTracer(every=mix.get("trace_every", 6),
                                            repeat=mix.get("trace_repeat", 3))
    result = run.run_cell(spec, args.seed, args.seconds, True, "cuda")
    bad = run.forbidden_modules()
    if bad:
        print(f"port_bench.program_spans: the process loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
