"""The readers of the program's spans (``program_spans.py`` and its
metrics) on synthetic spans and device intervals, and once through the
harness on the CPU: the idle shares and their remainder sum to
``device_idle_pct``, an idle gap under two spans is split by overlap, and
a run without the program's spans reads nothing."""

import types

import pytest
import torch

from port_bench import program_spans, run
from port_bench.program_spans import SpanTracer
from port_bench.tests import tiny
from port_bench.trace import Tracer, TraceView
from sjd_tpu_torch.utils import tracing

DRIVE, CLIENT = 11, 12


def view_of(tr):
    v = types.SimpleNamespace(trace=TraceView(tr), window=None, notes={})
    v.note = v.notes.__setitem__
    return v


def step_chain(t, tid=DRIVE, wait=30, host=(10, 5, 5)):
    """One decode step's spans from ``t``: its flags read, then its draws,
    copy and replay, each starting where the last ended."""
    out = [("engine.step.wait", t, t + wait)]
    t += wait
    for name, d in zip(program_spans.HOST, host):
        out.append((name, t, t + d))
        t += d
    return [(n, a, b, 0, None, tid, None) for n, a, b in out], t


def traced(spans, device, steps=((0, 1000),), chunks=((0, 1000, "active"),), samples=(),
           shift=0):
    """A SpanTracer as a run leaves it, its device events ``shift`` ns
    behind the host's clock, which the spans share."""
    tr = SpanTracer(every=2, repeat=1)
    tr.steps = list(steps)
    tr.device = [("k", s + shift, e + shift) for s, e in device]
    tr.chunks = list(chunks)
    tr.program = tracing.Drained(list(spans), list(samples), [(0, 0), (10**9, 10**9)])
    if shift:  # two synchronous copies read the offset
        tr.anchors = [(0, -shift), (10**6, -shift)]
    return tr


@pytest.mark.parametrize("shift", [0, 7000])
def test_idle_split_sums_to_device_idle_and_splits_a_gap_by_overlap(shift):
    call = [("engine.resume", 0, 1000, 0, None, DRIVE, None),
            ("serving.harvest", 900, 1000, 0, None, DRIVE, None)]
    spans, t = step_chain(100)  # wait 100-130, draws 130-140, copy 140-145, replay 145-150
    # the card busy 0-120 and 150-880: the gap 120-150 lies under the wait
    # (10) and the step's host work (20); 880-1000 under no step span (20,
    # the resume call's own time) and the harvest (100)
    tr = traced(call + spans + [("request.served", 50, 950, 0, None, DRIVE, 3)],
                [(0, 120), (150, 880)], steps=[(shift, 1000 + shift)], shift=shift)
    v = view_of(tr)
    split = program_spans.idle_split(v)
    assert split["wait"] == pytest.approx(1.0) and split["host"] == pytest.approx(2.0)
    assert split["boundary"] == pytest.approx(10.0) and split["other"] == pytest.approx(2.0)
    assert split["other_by"] == {"engine.resume": pytest.approx(2.0)}
    idle = run.reader("device_idle_pct")(v)
    assert split["idle"] == pytest.approx(idle) == pytest.approx(15.0)
    got = {name: run.reader(name)(v) for name in
           ("idle_step_host_pct", "idle_step_wait_pct", "idle_boundary_pct")}
    assert sum(got.values()) + v.notes["idle_split"]["other"] == pytest.approx(idle)


def test_device_window_carries_the_host_steps_through_the_anchors():
    """Recorded steps on the host's clock, device events 7 us behind it:
    the split over the steps' windows carried through the anchors reads
    the gaps as they were, whatever the window taken as it is reads."""
    shift = 7000
    call = [("engine.resume", 0, 1000, 0, None, DRIVE, None),
            ("serving.harvest", 900, 1000, 0, None, DRIVE, None)]
    spans, _ = step_chain(100)
    tr = traced(call + spans, [(0, 120), (150, 880)], steps=[(0, 1000)], shift=shift)
    got = program_spans.idle_split(view_of(tr))["device_window"]
    assert got["wait"] == pytest.approx(1.0) and got["host"] == pytest.approx(2.0)
    assert got["boundary"] == pytest.approx(10.0) and got["other"] == pytest.approx(2.0)
    assert got["idle"] == pytest.approx(15.0)
    assert got["window_ratio"] == pytest.approx(1000 / (880 + shift))


def test_requests_read_queue_service_and_committed_rate():
    spans = [("request.queued", 0, 2 * 10**6, 0, None, DRIVE, 1),
             ("request.queued", 0, 4 * 10**6, 0, None, DRIVE, 2),
             ("request.served", 2 * 10**6, 3 * 10**9, 0, None, DRIVE, 1)]
    samples = [("tokens_committed", 10**9, 100), ("slot_steps", 10**9, 5),
               ("tokens_committed", 3 * 10**9, 600)]
    v = view_of(traced(spans, [], samples=samples + [("finished_slot_steps", 10**9, 0),
                                                      ("slot_steps", 3 * 10**9, 15),
                                                      ("finished_slot_steps", 3 * 10**9, 1)]))
    assert run.reader("finished_slot_steps_pct")(v) == pytest.approx(10.0)
    got = v.notes["requests"]
    assert got["committed_tokens_per_s"] == pytest.approx(250.0)
    assert got["queued"] == {"n": 2, "median": pytest.approx(3.0), "max": pytest.approx(4.0)}
    assert got["served"] == {"n": 1, "median": pytest.approx(2.998), "max": pytest.approx(2.998)}
    assert program_spans.requests(traced([], [])) is None


def test_other_threads_and_crossing_request_spans_do_not_count():
    spans, _ = step_chain(0, wait=100)  # wait 0-100, host 100-120
    other, _ = step_chain(0, tid=CLIENT, wait=10, host=(90, 0, 0))
    call = [("engine.resume", 0, 200, 0, None, DRIVE, None),
            ("request.queued", 50, 150, 0, None, DRIVE, 1)]
    tr = traced(call + spans + other, [(200, 1000)])
    split = program_spans.idle_split(view_of(tr))
    assert split["wait"] == pytest.approx(10.0) and split["host"] == pytest.approx(2.0)
    assert split["other"] == pytest.approx(8.0) and split["idle"] == pytest.approx(20.0)
    assert split["other_by"] == {"engine.resume": pytest.approx(8.0)}


def test_innermost_nests_and_chains():
    segs = program_spans.innermost([("a", 0, 100), ("b", 10, 20), ("c", 20, 30),
                                    ("d", 25, 28), ("e", 200, 210)])
    assert segs == [(0, 10, "a"), (10, 20, "b"), (20, 25, "c"), (25, 28, "d"), (28, 30, "c"),
                    (30, 100, "a"), (200, 210, "e")]


def test_step_host_ms_over_quiet_chunks_and_finished_share():
    spans = []
    t = 0
    for host in ((1e6, 2e5, 3e5), (2e6, 2e5, 3e5), (9e6, 0, 0)):
        s, t = step_chain(t, wait=1e6, host=host)
        spans += s
    tr = traced(spans, [], chunks=[(0, 3e6, "quiet"), (3e6 + 1, 1e9, "active")],
                samples=[("slot_steps", 1, 10), ("finished_slot_steps", 1, 2),
                         ("slot_steps", 2, 60), ("finished_slot_steps", 2, 7)])
    assert program_spans.step_host_ms(tr, "quiet") == [pytest.approx(1.5)]
    assert program_spans.step_host_ms(tr, "active") == [pytest.approx(2.5), pytest.approx(9.0)]
    v = view_of(tr)
    assert run.reader("step_host_ms")(v) == pytest.approx(1.5)
    assert v.notes["step_host_ms"]["recorded_median"] == pytest.approx(9.0)
    assert run.reader("finished_slot_steps_pct")(v) == pytest.approx(10.0)


def test_device_clock_follows_the_anchors():
    tr = traced([], [])
    tr.anchors = [(1000, 100), (2000, 300), (3000, 9000), (4000, 500)]  # 9000: a late return
    to_device = program_spans.device_clock(tr)
    assert to_device(500) == 200 and to_device(1500) == 1200
    assert to_device(2500) == 2100 and to_device(5000) == 4500
    assert program_spans.device_clock(traced([], []))(123) == 123


def test_clock_check_pairs_replays_with_launches_by_order():
    spans, t = step_chain(100)  # replay 145-150
    nxt, _ = step_chain(t + 50)  # the next flags read 200-230
    tr = traced(spans + nxt + [("engine.resume", 0, 1000, 0, None, DRIVE, None)], [])
    # each launch call inside its replay span, its graph's operations after
    # the launch began and ending before the next flags read returned
    tr.launches = [(146, 149, 160, 190), (246, 249, 260, 290)]
    got = program_spans.clock_check(view_of(tr))
    assert got["steps"] == 1 and got["mismatched_chunks"] == 0
    assert got["host_held_pct"] == got["raw_held_pct"] == got["held_pct"] == 100.0
    # the device's clock 500 ns behind: the raw times fail, the anchors repair them
    tr.launches = [(146, 149, 660, 690), (246, 249, 760, 790)]
    tr.anchors = [(0, -500), (2 * 10**6, -500)]
    got = program_spans.clock_check(view_of(tr))
    assert (got["raw_held_pct"], got["held_pct"]) == (0.0, 100.0)
    assert got["offset_us"] == [-0.5, -0.5, -0.5] and got["drift_ppm"] == 0.0
    # a program span mapped 100 ns late: outside its launch call
    tr.program = tracing.Drained(tr.program.spans, [], [(0, 100), (10**9, 10**9 + 100)])
    assert program_spans.clock_check(view_of(tr))["host_held_pct"] == 0.0


@pytest.mark.parametrize("name", [m["name"] for m in program_spans.METRICS])
def test_nothing_to_read_without_program_spans(name):
    tr = Tracer(every=2, repeat=1)
    tr.steps, tr.device = [(0, 1000)], [("k", 0, 10)]
    assert run.reader(name)(view_of(tr)) is None
    v = types.SimpleNamespace(trace=None, window=None, notes={})
    assert run.reader(name)(v) is None


def test_traced_cpu_run_reads_the_program_spans(monkeypatch):
    """The harness's traced run on the CPU with :class:`SpanTracer`: the
    program's spans reach the readers; no device op means every recorded
    second is idle, and the split still sums to it."""
    monkeypatch.setattr(run, "tracer_for", lambda mix: SpanTracer(
        every=mix.get("trace_every", 6), repeat=mix.get("trace_repeat", 3)))
    torch.manual_seed(0)
    spec = tiny.spec("lumina7b-w4a16.batch5-768", "lumina-mgpt-7b-w4a16", "batch5-768",
                     limits={"mean_gap": 0.1, "vq_mean_abs": 1.0})
    spec["per_layer"] = spec["per_layer"] + program_spans.METRICS
    r = run.run_cell(spec, 2**33 + 17, 3.0, True, "cpu")
    assert r["correct"], r["checks"]
    m = r["metrics"]
    # the CPU runs every step eagerly: no replayed step for step_host_ms
    assert {"idle_step_host_pct", "idle_step_wait_pct", "idle_boundary_pct",
            "finished_slot_steps_pct"} <= set(m) and "step_host_ms" not in m
    shares = sum(m[k]["value"] for k in ("idle_step_host_pct", "idle_step_wait_pct",
                                         "idle_boundary_pct"))
    assert 0 < shares <= m["device_idle_pct"]["value"] == pytest.approx(100.0)
    assert tracing.ON is False
