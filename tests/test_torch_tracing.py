"""The port's span recorder (sjd_tpu_torch/utils/tracing.py) and what the
engine and the batcher record with it, at tests/test_torch_serving.py's
tiny shapes on the CPU: off it records nothing; on, spans nest per thread
under their call, carry their request's index, map onto the profiler's
clock, and leave the tokens as they were. The batcher's slot-step counters
are held against a hand count of the finished flags at each step."""

import statistics
import threading
import time

import numpy as np
import pytest
import torch

import jax

from sjd_tpu_torch.core.serving import StreamingBatcher, latency_summary, seed_generators
from sjd_tpu_torch.utils import tracing
from test_torch_serving import CFG, engine, grid_prompt

WAIT_S = 120
PROBES = 5
STEP_PHASES = ("engine.step.wait", "engine.step.eager")


@pytest.fixture(scope="module")
def params():
    from helpers import tiny_params
    from sjd_tpu_torch.convert import params_from_jax

    return params_from_jax(jax.tree.map(np.asarray, tiny_params()), CFG, device="cpu")


@pytest.fixture
def tracer():
    """The recorder on for one test, left off and empty after it."""
    tracing.drain()
    tracing.enable()
    try:
        yield tracing
    finally:
        tracing.disable()
        tracing.drain()


def by_id(spans):
    return {s[3]: s for s in spans}


def test_off_records_nothing(params):
    tracing.disable()
    tracing.drain()
    assert tracing.span("a") is tracing.span("b")  # the shared no-op: nothing allocated
    eng = engine()
    eng.generate(params, 3, torch.tensor([grid_prompt(54)] * 2), max_steps=6)
    sb = StreamingBatcher(engine(), params, batch=2, chunk_steps=4, prompt_width=5)
    sb.submit(grid_prompt(53), seed=1).wait(timeout=WAIT_S)
    sb.close()
    got = tracing.drain()
    assert got.spans == [] and got.samples == []


def test_nesting_parents_requests_and_drain_across_threads(tracer):
    """Spans nest under the innermost open span of their own thread only;
    each carries its thread and request; drain() hands them over once."""
    opened = threading.Barrier(3)

    def client(i):
        with tracer.span("client.request", request=i):
            opened.wait(timeout=WAIT_S)  # every thread inside its span at once
            t0 = tracer.now()
            tracer.record("client.phase", t0, tracer.now(), request=i)

    threads = [threading.Thread(target=client, args=(i,)) for i in (7, 8)]
    with tracer.span("outer"):
        for t in threads:
            t.start()
        opened.wait(timeout=WAIT_S)
        with tracer.span("inner"):
            t = tracer.lap("leaf", tracer.now())
        for th in threads:
            th.join(WAIT_S)
    assert not any(th.is_alive() for th in threads)
    got = tracer.drain()
    spans = by_id(got.spans)
    assert len(spans) == len(got.spans) == 7  # ids unique
    named = {}
    for s in got.spans:
        named.setdefault(s[0], []).append(s)
    (outer,), (inner,), (leaf,) = named["outer"], named["inner"], named["leaf"]
    me = threading.get_ident()
    assert outer[4] is None and inner[4] == outer[3] and leaf[4] == inner[3]
    assert {outer[5], inner[5], leaf[5]} == {me}
    assert outer[1] <= inner[1] <= leaf[1] <= leaf[2] == t <= inner[2] <= outer[2]
    for req in named["client.request"]:
        (phase,) = [p for p in named["client.phase"] if p[6] == req[6]]
        assert req[4] is None and phase[4] == req[3]  # not under the main thread's spans
        assert req[5] == phase[5] != me and req[6] in (7, 8)
    assert {r[6] for r in named["client.request"]} == {7, 8}
    assert outer[6] is None
    again = tracer.drain()
    assert again.spans == [] and len(again.anchors) == 2


def test_clock_maps_onto_the_profiler_and_leaves_it_no_annotation(tracer, params):
    """A program span and a ``record_function`` around the same block agree
    within 200 us once mapped; no profiler event carries a program span's
    name, though the engine and the batcher record while it runs."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):  # the first annotation pays for its set-up
            pass
        for i in range(PROBES):
            with record_function(f"probe{i}"), tracer.span(f"probe{i}"):
                torch.randn(64, 64) @ torch.randn(64, 64)
            time.sleep(0.01)
        engine().generate(params, 3, torch.tensor([grid_prompt(54)]), max_steps=4)
        sb = StreamingBatcher(engine(), params, batch=2, chunk_steps=4, prompt_width=5)
        sb.submit(grid_prompt(53), seed=1).wait(timeout=WAIT_S)
        sb.close()
    got = tracer.drain()
    events = {ev.name(): ev for ev in prof.profiler.kineto_results.events()}
    starts, ends = [], []
    for i in range(PROBES):
        (mine,) = [s for s in got.spans if s[0] == f"probe{i}"]
        ev = events[f"probe{i}"]
        starts.append(abs(got.to_profiler_ns(mine[1]) - ev.start_ns()))
        ends.append(abs(got.to_profiler_ns(mine[2]) - ev.start_ns() - ev.duration_ns()))
    # the median: a probe whose thread was preempted between the two opens
    # reads late by the preemption, not by the mapping
    assert statistics.median(starts) < 200e3 and statistics.median(ends) < 200e3
    names = {s[0] for s in got.spans} - {f"probe{i}" for i in range(PROBES)}
    assert {"engine.generate", "engine.step.wait", "serving.harvest",
            "request.served"} <= names
    assert not names & set(events)


def test_eager_engine_step_spans_nest_and_change_nothing(tracer, params):
    """generate(max_steps=n) on the CPU: one ``engine.step.eager`` per decode
    step (NFE - 1), each after its flags read, under the call's span; the
    tokens and the acceptance histogram equal the untraced run's."""
    prompt = torch.tensor([grid_prompt(54), grid_prompt(53)])
    res_on = engine().generate(params, 5, prompt, max_steps=7)
    got = tracer.drain()
    tracer.disable()
    res_off = engine().generate(params, 5, prompt, max_steps=7)
    np.testing.assert_array_equal(res_on.tokens.numpy(), res_off.tokens.numpy())
    np.testing.assert_array_equal(res_on.accept_hist.numpy(), res_off.accept_hist.numpy())
    assert res_on.nfe == res_off.nfe == 7
    (call,) = [s for s in got.spans if s[0] == "engine.generate"]
    (prefill,) = [s for s in got.spans if s[0] == "engine.prefill"]
    steps = sorted((s for s in got.spans if s[0] in STEP_PHASES), key=lambda s: s[1])
    assert sum(s[0] == "engine.step.eager" for s in steps) == res_on.nfe - 1
    assert [s[0] for s in steps] == ["engine.step.wait", "engine.step.eager"] * (res_on.nfe - 1)
    assert prefill[4] == call[3] and call[1] <= prefill[1] <= prefill[2] <= steps[0][1]
    for a, b in zip(steps, steps[1:]):
        assert a[2] <= b[1]
    for s in steps:
        assert s[4] == call[3] and call[1] <= s[1] <= s[2] <= call[2]


def test_batcher_counts_finished_slot_steps_and_request_spans(tracer, params):
    """Two slots, one request ending mid-chunk: ``finished_slot_steps``
    equals the finished flags counted by hand at the start of every decode
    step; each completed request has its queue and service spans, with its
    index, on the drive thread; the tokens committed end equal to those
    generated."""
    eng = engine()
    seen = []  # per decode step: the slots finished when it starts
    real = eng._draws

    def counting(st):
        seen.append(int(st.finished.sum()))
        return real(st)

    eng._draws = counting  # called once by every decode step
    sb = StreamingBatcher(eng, params, batch=2, chunk_steps=16, prompt_width=5)
    handles = [sb.submit(grid_prompt(53), seed=3), sb.submit(grid_prompt(54), seed=4)]
    results = [h.wait(timeout=WAIT_S) for h in handles]
    stats = sb.stats()
    sb.close()
    got = tracer.drain()
    assert stats["slot_steps"] == 2 * len(seen) and stats["finished_slot_steps"] == sum(seen)
    assert stats["finished_slot_steps"] > 0  # the 2x2 request waited for the 4x4 one
    assert stats["tokens_committed"] == stats["tokens_generated"] == sum(
        r.gen_count for r in results)
    drive = {s[5] for s in got.spans if s[0].startswith("engine.")}
    assert len(drive) == 1
    for h in handles:
        (queued,) = [s for s in got.spans if s[0] == "request.queued" and s[6] == h.index]
        (served,) = [s for s in got.spans if s[0] == "request.served" and s[6] == h.index]
        assert queued[2] == served[1] and queued[1] <= queued[2] <= served[2]
        assert queued[5] == served[5] in drive
    samples = [v for name, _, v in got.samples if name == "finished_slot_steps"]
    assert samples == sorted(samples) and samples[-1] <= stats["finished_slot_steps"]
    spans = by_id(got.spans)
    for s in got.spans:
        if s[0].startswith("engine.step."):
            assert spans[s[4]][0] in ("engine.generate", "engine.resume")
        if s[0].startswith("serving."):
            assert s[4] is None and s[5] in drive


def test_tokens_committed_counts_the_slots_in_flight(params):
    """At every chunk boundary, ``tokens_committed - tokens_generated`` is
    what the requests still in their slots have committed: each equal to a
    solo ``generate`` of the same request stopped after as many forwards,
    with the finished request left out once it is counted as generated."""
    tracing.disable()
    prompts = {3: grid_prompt(53), 4: grid_prompt(54)}  # seed -> prompt
    sb = StreamingBatcher(engine(), params, batch=2, chunk_steps=2, prompt_width=5)
    seen = []  # per boundary: (forwards so far, seeds of the requests still in a slot, stats)
    real = sb._harvest

    def harvest(state, occupants):
        real(state, occupants)
        seeds = [3 + h.index for h in occupants if h is not None]
        seen.append((state.nfe, seeds, sb.stats()))

    sb._harvest = harvest
    handles = [sb.submit(prompts[3], seed=3), sb.submit(prompts[4], seed=4)]
    results = [h.wait(timeout=WAIT_S) for h in handles]
    sb.close()
    solo = engine()

    def committed(seed, nfe):
        _, st = solo.generate(params, seed_generators([seed], "cpu"),
                              np.asarray([prompts[seed]], np.int32),
                              prompt_mask=np.ones((1, 5), bool), max_steps=nfe,
                              return_state=True)
        return int(st.length[0]) - st.prompt_rows

    assert {len(s) for _, s, _ in seen} >= {1, 2}  # both in flight, then the 4x4 alone
    for nfe, seeds, stats in seen:
        done = [r.gen_count for r, h in zip(results, handles) if 3 + h.index not in seeds]
        assert stats["tokens_generated"] == sum(done)
        assert stats["tokens_committed"] - stats["tokens_generated"] == sum(
            committed(s, nfe) for s in seeds)


@pytest.mark.parametrize("n,p90", [(0, None), (99, None), (100, 90.9)])
def test_latency_summary_over_every_completion(n, p90):
    """Median and mean over every completion; p90 once 10 lie beyond it."""
    lat = [float(i + 1) for i in range(n)][::-1]
    got = latency_summary(lat)
    if n == 0:
        assert got == {"latency_s_median": None, "latency_s_p90": None,
                       "latency_s_mean": None}
        return
    assert got["latency_s_median"] == (n + 1) / 2 == got["latency_s_mean"]
    assert got["latency_s_p90"] == (None if p90 is None else pytest.approx(p90))
