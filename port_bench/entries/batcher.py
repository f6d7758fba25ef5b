"""``StreamingBatcher`` under closed-loop clients.

``outstanding`` clients each keep one request in the batcher: when theirs
completes they submit the next at once, then decode the finished image to
``uint8`` pixels on the card (where the mix decodes images). So every slot
holds a request through the window. The engine handed to the batcher is
the benchmark's :class:`~port_bench.recorder.EngineProxy`; the window opens
and closes on its chunk boundaries, and the rate is the tokens committed
between them, requests in flight included. A
:class:`~port_bench.recorder.StepLog` records every decode step from the
first batch on, for the check.
"""

from __future__ import annotations

import logging
import sys
import threading
import time

import numpy as np
import torch

from ..families import left_pad
from ..recorder import EngineProxy, StepLog
from ..reference.sampling import generator_seed
from ..traffic.generator import Traffic
from . import Chunks, Window, in_flight, warm_image


def _warm(ctx, traffic):
    """The cell's own shapes, once each: a fresh batch at the bucket (its
    prefill, the warm-up step, the capture), a refill prefill, a VQ decode."""
    sys_, mix = ctx.system, ctx.mix
    eng, params, B = sys_.engine, sys_.params, mix["batch"]
    reqs = [traffic.warm_request()] * B
    ids, mask = left_pad([r.prompt for r in reqs], sys_.prompt_width)
    kw = dict(prompt=ids, prompt_mask=mask)
    if sys_.neg_width:
        nids, nmask = left_pad([r.neg_prompt for r in reqs], sys_.neg_width)
        kw.update(neg_prompt=nids, neg_mask=nmask)
    if sys_.gstate is not None:
        kw["gstate"] = sys_.gstate(B)
    _, state = eng.generate(params, reqs[0].seed, max_steps=3, return_state=True, **kw)
    if mix.get("warm_refill"):
        refill = np.zeros(B, bool)
        refill[0] = True
        eng.refill(params, state, refill_mask=refill, rng=reqs[0].seed, **kw)
    if sys_.decode_image is not None:
        sys_.decode_image(reqs[0].prompt, warm_image(ctx.cfg, mix))
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def run(ctx) -> Window:
    from sjd_tpu_torch.core.serving import StreamingBatcher

    sys_, mix, cfg, rec, tracer = ctx.system, ctx.mix, ctx.cfg, ctx.rec, ctx.tracer
    traffic = Traffic(cfg, mix, ctx.seed)
    _warm(ctx, traffic)

    def quiet_log():
        # the batcher logs each batch that the closed window fails
        logging.getLogger("sjd_tpu_torch.serving").setLevel(logging.CRITICAL)

    chunks = Chunks(rec, tracer, on_close=quiet_log)
    proxy = EngineProxy(sys_.engine, rec, ctx.seconds, on_boundary=chunks)
    # a step takes 5 ms or more: room for the window and its set-up
    log = StepLog(sys_.engine, mix["batch"], int((ctx.seconds + 120) * 200))
    batcher = StreamingBatcher(proxy, sys_.params, batch=mix["batch"],
                               chunk_steps=mix["chunk_steps"], prompt_width=sys_.prompt_width,
                               neg_width=sys_.neg_width, make_gstate=sys_.make_gstate)
    lock = threading.Lock()
    counter = [0]
    done, failed, submitted = [], [], {}
    stop = threading.Event()

    def next_request():
        with lock:
            i = counter[0]
            counter[0] += 1
        req = traffic.request(i)
        h = batcher.submit(req.prompt, neg_prompt_ids=req.neg_prompt, seed=req.seed)
        with lock:
            submitted[i] = req
        return req, h

    def client(req, h):
        while True:
            try:
                r = h.wait()
            except Exception as e:  # the window closed under it, or a failure
                if not proxy.closed.is_set():
                    with lock:
                        failed.append((req.index, repr(e)))
                return
            t_done = time.perf_counter()
            gen = [int(t) for t in r.tokens[len(r.tokens) - r.gen_count:]]
            item = dict(index=req.index, prompt=req.prompt, neg=req.neg_prompt, gen=gen,
                        seed=req.seed, t_done=t_done, image=None)
            old = req
            if not stop.is_set():
                req, h = next_request()
            # a request that finished in the window is decoded even where the
            # window closed meanwhile: its pixels are checked
            if sys_.decode_image is not None:
                with rec.span("vq_decode"):
                    item["image"] = sys_.decode_image(old.prompt, gen)
            with lock:
                done.append(item)
            if stop.is_set():
                return

    # every client's first request before the drive thread wakes, so that
    # the first batch admits a whole pool pass and every slot starts on the
    # same step (a slot admitted a chunk later would change the window's work)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1.0)
    try:
        first = [next_request() for _ in range(mix["outstanding"])]
    finally:
        sys.setswitchinterval(interval)
    clients = [threading.Thread(target=client, args=rh, name=f"client{c}", daemon=True)
               for c, rh in enumerate(first)]
    for t in clients:
        t.start()
    # set-up ends when every slot holds a request: the window opens at the
    # next chunk boundary
    deadline = time.perf_counter() + 600
    while batcher.stats()["in_flight"] < mix["batch"]:
        if time.perf_counter() > deadline:
            raise RuntimeError("the batcher never filled its slots")
        time.sleep(0.005)
    ctx.setup_done()
    proxy.open_requested.set()
    if not proxy.closed.wait(ctx.seconds + 600):
        raise RuntimeError("the window did not close")
    stop.set()
    for t in clients:
        t.join(120)
    batcher.close(120)
    log.close()
    calls = proxy.window_calls()
    w = chunks.window(proxy, mix["window"], len(failed))
    finished = [it for it in done if proxy.t_open <= it["t_done"] <= proxy.t_close]
    w.items = finished + in_flight(proxy, log, submitted, finished)
    for it in w.items:
        it.update(prompt_rows=log.prompt_rows, steps=log.steps_of(generator_seed(it["seed"])))
    w.attempted = len(w.items) + len(failed)
    w.notes.update(
        completed=len(finished), failures=failed[:3],
        fresh_batches=sum(c.kind == "generate" for c in calls),
        refills_before_window=sum(c.kind == "refill" for c in proxy.calls[:proxy.i_open]),
        refills=sum(c.kind == "refill" for c in calls),
        lengths_at_close=proxy.final[1])
    return w
