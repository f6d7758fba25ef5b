"""One request at a time through ``SJDEngine.generate``, as the generate
command line serves an interactive user.

One closed-loop client sends a request, follows it through
``generate(..., return_state=True)`` and ``resume`` in chunks of
``chunk_steps`` forwards, decodes the finished image to ``uint8`` pixels
on the card, and only then sends the next. The engine is the benchmark's
:class:`~port_bench.recorder.EngineProxy`: the window opens and closes on
its chunk boundaries, and the rate is the tokens committed between them,
the request in flight at the close included. Every prompt is left-padded
to the mix's one width, so every request replays the decode step that the
warm-up captured; a capture inside the window is noted
(``captures_in_window``). A :class:`~port_bench.recorder.StepLog` records
every decode step for the check; each request's steps are the run of them
between its ``generate`` and its end, since a ring of requests
(``cycle``) may send one seed twice.
"""

from __future__ import annotations

import time

import torch

from ..families import left_pad
from ..recorder import EngineProxy, StepLog, WindowClosed
from ..traffic.generator import Traffic
from . import Chunks, Window, in_flight, warm_image


def _serve(eng, params, sys_, req, chunk: int):
    """One request, chunk by chunk, to its end (or the engine's forward
    cap); returns its final state."""
    from sjd_tpu_torch.core.serving import seed_generators

    ids, mask = left_pad([req.prompt], sys_.prompt_width)
    kw = dict(prompt=ids, prompt_mask=mask)
    if sys_.neg_width:
        nids, nmask = left_pad([req.neg_prompt], sys_.neg_width)
        kw.update(neg_prompt=nids, neg_mask=nmask)
    if sys_.gstate is not None:
        kw["gstate"] = sys_.gstate(1)
    _, state = eng.generate(params, seed_generators([req.seed], eng.device),
                            max_steps=chunk, return_state=True, **kw)
    cap = eng.config.resolved_nfe_cap()
    while not bool(state.finished.all()) and state.nfe < cap:
        _, state = eng.resume(params, state, max_steps=chunk, return_state=True)
    return state


def run(ctx) -> Window:
    sys_, mix, rec, tracer = ctx.system, ctx.mix, ctx.rec, ctx.tracer
    eng, params, chunk = sys_.engine, sys_.params, mix["chunk_steps"]
    traffic = Traffic(ctx.cfg, mix, ctx.seed)
    # warm-up: one whole image at the prompt width (its prefill, the eager
    # warm-up step, the capture, the replays) and one VQ decode
    _serve(eng, params, sys_, traffic.warm_request(), chunk)
    if sys_.decode_image is not None:
        sys_.decode_image(traffic.warm_request().prompt, warm_image(ctx.cfg, mix))
    if torch.cuda.is_available():
        torch.cuda.synchronize()

    chunks = Chunks(rec, tracer)
    proxy = EngineProxy(eng, rec, ctx.seconds, on_boundary=chunks)
    # a step takes 5 ms or more: room for the window and its set-up
    log = StepLog(eng, 1, int((ctx.seconds + 120) * 200))
    captures = eng.stats.captures
    done, submitted, first_step = [], {}, {}
    ctx.setup_done()
    # the window opens at the first request's first chunk boundary
    proxy.open_requested.set()
    i = 0
    while not proxy.closed.is_set():
        req = traffic.request(i)
        submitted[i], first_step[i] = req, len(log.seeds)
        try:
            state = _serve(proxy, params, sys_, req, chunk)
        except WindowClosed:
            break
        t_done = time.perf_counter()
        gen = state.tokens[0, state.prompt_rows:int(state.length[0])].tolist()
        item = dict(index=i, prompt=req.prompt, neg=req.neg_prompt, gen=gen,
                    seed=req.seed, t_done=t_done, image=None, last_step=len(log.seeds))
        # a request cut by the engine's forward cap has no whole image
        if (sys_.decode_image is not None and not proxy.closed.is_set()
                and bool(state.finished.all())):
            with rec.span("vq_decode"):
                item["image"] = sys_.decode_image(req.prompt, gen)
        done.append(item)
        i += 1
    if proxy.t_close is None:
        raise RuntimeError("the window did not close")
    captures_in_window = eng.stats.captures - captures
    log.close()
    w = chunks.window(proxy, mix["window"], 0)
    finished = [it for it in done if proxy.t_open <= it["t_done"] <= proxy.t_close]
    w.items = finished + in_flight(proxy, log, submitted, finished)
    rows = log.buf[:len(log.seeds), 0].cpu().numpy()
    for it in w.items:
        it.update(prompt_rows=log.prompt_rows,
                  steps=rows[first_step[it["index"]]:it.pop("last_step", len(rows))])
    w.attempted = len(w.items)
    vq = [(t0, t1) for name, t0, t1, _ in rec.spans if name == "vq_decode"
          and proxy.t_open <= t0 and t1 <= proxy.t_close]
    w.notes.update(completed=len(finished), captures_in_window=captures_in_window,
                   vq_decodes=len(vq), vq_decode_s=sum(t1 - t0 for t0, t1 in vq),
                   lengths_at_close=proxy.final[1])
    return w
