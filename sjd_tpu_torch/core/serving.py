"""Continuous batching: stream prompts through a fixed-B SJD engine
(sjd_tpu/core/serving.py).

A batch runs until every sample finishes, so a fixed batch pays for its
slowest member. ``ContinuousBatcher`` chunks the generation
(``SJDEngine.generate(max_steps=..., return_state=True)`` then ``resume``),
harvests finished slots at each chunk boundary, and refills them from the
queue with one prefill forward (``SJDEngine.refill``), while live slots'
trajectories are kept bit-exactly. On CUDA every chunk replays the engine's
captured decode step; a refill changes the state's contents in place, so
the same graph replays on.

``StreamingBatcher`` does the same online: ``submit`` from any thread, a
drive thread admits requests at chunk boundaries and resolves each
request's ``PendingResult``. Only the drive thread touches the device.
Requests are token ids or, with ``embed_dim`` (LlamaGen), embedding rows.

Data-parallel slots (``row_sharding``) are not ported yet:
``StreamingBatcher`` refuses them.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.logging import MetricLogger
from .engine import seeded_generator

_log = logging.getLogger("sjd_tpu_torch.serving")


@dataclasses.dataclass
class CompletedGeneration:
    prompt_index: int  # position in the input stream
    tokens: np.ndarray  # prompt + generation rows (left-aligned, unpadded tail)
    gen_count: int


def seed_generators(seeds: Sequence[int], device) -> List[torch.Generator]:
    """Per-request seeds -> one generator per slot (sjd_tpu's seed_keys): a
    request's trajectory is then a function of its prompt and seed alone."""
    return [seeded_generator(np.random.SeedSequence(int(s)), device) for s in seeds]


class ContinuousBatcher:
    """Run a stream of same-width prompts through B engine slots.

    prompts: [N, P] int (pad shorter prompts and pass prompt_masks).
    ``chunk_steps`` trades refill latency against host round trips: a
    finished slot idles for at most one chunk before it is refilled.
    ``make_gstate(indices) -> GrammarState`` supplies per-prompt grammar
    state; by default the engine's own.
    """

    def __init__(self, engine, params, *, chunk_steps: int = 128,
                 make_gstate: Optional[Callable[[List[int]], Any]] = None):
        self.engine = engine
        self.params = params
        self.chunk_steps = chunk_steps
        self.make_gstate = make_gstate
        # after run(): the decode steps by accepted length over the whole
        # stream, the forwards, and each refill as {"nfe", "refilled":
        # {slot: prompt index}, "live": [prompt indices still generating]}
        self.last_accept_hist: Optional[np.ndarray] = None
        self.last_nfe: int = 0
        self.last_refills: List[Dict[str, Any]] = []

    def run(
        self,
        rng,  # a seed for per-slot generators (ignored with ``seeds``)
        prompts: np.ndarray,  # [N, P] int
        prompt_masks: Optional[np.ndarray] = None,  # [N, P] bool
        batch: int = 4,
        neg_prompts: Optional[np.ndarray] = None,  # [N, Pn] (cfg_mode=neg_prompt)
        seeds: Optional[Sequence[int]] = None,  # per-prompt seeds: prompt i's
        # output becomes a function of (prompts[i], seeds[i]) alone
    ) -> List[CompletedGeneration]:
        eng = self.engine
        dev = eng.device
        prompts = np.asarray(prompts)
        N, P = prompts.shape
        B = min(batch, N)
        if seeds is not None and len(seeds) != N:
            raise ValueError(f"{len(seeds)} seeds for {N} prompts")
        if prompt_masks is None:
            prompt_masks = np.ones((N, P), bool)

        slot_prompt: List[Optional[int]] = list(range(B))  # stream index per slot
        next_idx = B
        done: List[CompletedGeneration] = []
        self.last_refills = []

        def batch_rows(idx_list):
            ids = torch.as_tensor(prompts[idx_list], dtype=torch.int32, device=dev)
            mask = torch.as_tensor(prompt_masks[idx_list], dtype=torch.bool, device=dev)
            neg = (torch.as_tensor(neg_prompts[idx_list], dtype=torch.int32, device=dev)
                   if neg_prompts is not None else None)
            g = self.make_gstate(list(idx_list)) if self.make_gstate else None
            return ids, mask, neg, g

        def gens_for(idx_list):
            return seed_generators([seeds[i] for i in idx_list], dev)

        ids, mask, neg, g = batch_rows(slot_prompt)
        _, state = eng.generate(
            self.params, gens_for(slot_prompt) if seeds is not None else rng,
            ids, prompt_mask=mask, neg_prompt=neg, gstate=g,
            max_steps=self.chunk_steps, return_state=True)

        def harvest(state) -> List[int]:
            """Collect finished slots into ``done``; return their indices.
            The [B] flags come first; token rows only for the slots that
            finished (most chunk boundaries harvest nothing), copied: the
            state's buffers are reused."""
            finished = state.finished.cpu().numpy()
            hits = [b for b in range(B) if finished[b] and slot_prompt[b] is not None]
            if not hits:
                return []
            lengths = state.length.cpu().numpy()
            for b in hits:
                n = int(lengths[b])
                done.append(CompletedGeneration(
                    prompt_index=slot_prompt[b], tokens=state.tokens[b, :n].cpu().numpy().copy(),
                    gen_count=n - state.prompt_rows))
                slot_prompt[b] = None
            return hits

        while True:
            refill_slots = []
            for b in harvest(state):
                if next_idx < N:
                    slot_prompt[b] = next_idx
                    refill_slots.append(b)
                    next_idx += 1
            if all(s is None for s in slot_prompt):
                break  # queue drained and every slot harvested
            if refill_slots:
                # fresh rows matter only where refill_mask is set; the other
                # slots re-present their own prompt (ignored)
                idx_rows = [slot_prompt[b] if slot_prompt[b] is not None else 0
                            for b in range(B)]
                ids, mask, neg, g = batch_rows(idx_rows)
                refill_mask = np.zeros((B,), bool)
                refill_mask[refill_slots] = True
                self.last_refills.append(dict(
                    nfe=state.nfe, refilled={b: slot_prompt[b] for b in refill_slots},
                    live=[slot_prompt[b] for b in range(B)
                          if b not in refill_slots and slot_prompt[b] is not None]))
                state = eng.refill(
                    self.params, state, ids, refill_mask, prompt_mask=mask,
                    neg_prompt=neg, gstate=g,
                    rng=gens_for(idx_rows) if seeds is not None else None)
            _, state = eng.resume(self.params, state, max_steps=self.chunk_steps,
                                  return_state=True)

        self.last_accept_hist = state.accept_hist.cpu().numpy().copy()
        self.last_nfe = state.nfe
        done.sort(key=lambda c: c.prompt_index)
        return done


class PendingResult:
    """Handle returned by :meth:`StreamingBatcher.submit`; ``wait`` blocks
    until the generation completes and returns its CompletedGeneration."""

    def __init__(self, index: int):
        self.index = index
        self.submitted_at = time.perf_counter()
        self._event = threading.Event()
        self._result: Optional[CompletedGeneration] = None
        self._error: Optional[BaseException] = None

    def _resolve(self, result: CompletedGeneration) -> None:
        self._result = result
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> CompletedGeneration:
        if not self._event.wait(timeout):
            raise TimeoutError("generation not finished")
        if self._error is not None:
            raise self._error
        return self._result


class StreamingBatcher:
    """Online continuous batching: ``submit()`` prompts at any time from any
    thread; a drive thread keeps ``batch`` engine slots busy, admitting
    requests at chunk boundaries through ``SJDEngine.refill`` and resolving
    finished requests' handles.

    A request's slot gets a generator seeded from its own ``seed``
    (:func:`seed_generators`) when it is admitted, into a fresh batch or by
    a refill, so its tokens are a function of (prompt, seed) alone, whatever
    the arrival order and the co-scheduled load. Idle slots carry a copy of
    the first prompt, whose output is discarded; a refill re-arms them as
    soon as a request arrives, finished or not.

    ``prompt_width`` is the fixed token bucket: shorter prompts are
    left-padded (mask False), longer ones refused; with ``neg_width`` (the
    engine's ``cfg_mode="neg_prompt"``) each request brings a negative
    prompt of at most that many ids. With ``embed_dim`` the requests are
    embedding rows (``submit(prompt_embeds=, neg_prompt_embeds=,
    prompt_mask=)``, each [P', embed_dim] with P' <= ``prompt_width``),
    left-padded with zero rows; the padding is masked out of the cond half
    only, as the engine attends every row of an embedding prompt's uncond
    half. ``make_gstate(metas)`` (optional) builds the slots' grammar state
    from each request's ``meta`` (None for idle slots), the Emu3 seam;
    without it the engine's own default arms each slot.
    ``submit`` keeps its payload on the host (lists, CPU tensors): a
    CUDA call from a client thread while the drive thread captures the
    decode step would break the capture, so device tensors are refused.
    The drive thread makes the engine's device its current device (a
    per-thread setting).
    """

    def __init__(self, engine, params, *, batch: int = 4, chunk_steps: int = 128,
                 prompt_width: int, neg_width: int = 0, embed_dim: int = 0,
                 make_gstate: Optional[Callable[[List[Optional[dict]]], Any]] = None,
                 row_sharding: Any = None):
        if row_sharding is not None:
            raise NotImplementedError("row_sharding (data-parallel slots) is not ported: the "
                                      "port serves one device")
        self.engine = engine
        self.params = params
        self.B = batch
        self.chunk_steps = chunk_steps
        self.P = prompt_width
        self.neg_width = neg_width
        self.embed_dim = embed_dim
        self.make_gstate = make_gstate
        dev = engine.device
        # the drive thread's current device (a per-thread setting)
        self._cuda_index = (None if dev.type != "cuda" else
                            dev.index if dev.index is not None else torch.cuda.current_device())
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        # (PendingResult, ids or (embeds, neg embeds, mask), neg ids, seed, meta)
        self._pending: List[tuple] = []
        self._count = 0
        self._completed = 0
        self._in_flight = 0
        self._tokens_out = 0
        self._batches = 0  # fresh batches (generate)
        self._refills = 0
        self._chunks = 0  # generate and resume calls
        self._metrics = MetricLogger()  # latency_s, gen_tokens per completion
        self._closed = False
        self._thread = threading.Thread(target=self._drive, name="StreamingBatcher",
                                        daemon=True)
        self._thread.start()

    def stats(self) -> dict:
        """A snapshot of the serving counters: requests submitted, completed,
        in flight and pending, generated tokens, fresh batches, refills and
        chunks (generate and resume calls), and each completion's latency
        from submit (median, mean)."""
        with self._lock:
            lat = self._metrics.meters["latency_s"]
            return {"submitted": self._count, "completed": self._completed,
                    "in_flight": self._in_flight, "pending": len(self._pending),
                    "tokens_generated": self._tokens_out, "batches": self._batches,
                    "refills": self._refills,
                    "chunks": self._chunks, "latency_s_median": lat.median,
                    "latency_s_mean": lat.global_avg}

    # -- client side -----------------------------------------------------

    def submit(self, prompt_ids=None, neg_prompt_ids=None, seed: int = 0,
               meta: Optional[dict] = None, prompt_embeds=None, neg_prompt_embeds=None,
               prompt_mask=None) -> PendingResult:
        neg = None
        if self.embed_dim:
            payload = self._embed_payload(prompt_ids, prompt_embeds, neg_prompt_embeds,
                                          prompt_mask)
        else:
            if prompt_embeds is not None:
                raise ValueError("a token-mode batcher (embed_dim=0) takes prompt_ids")
            payload = [int(t) for t in prompt_ids]
            if not 0 < len(payload) <= self.P:
                raise ValueError(f"prompt length {len(payload)} is outside the bucket "
                                 f"(1..{self.P})")
            neg = [int(t) for t in neg_prompt_ids] if neg_prompt_ids is not None else None
            if self.neg_width and (neg is None or len(neg) > self.neg_width):
                raise ValueError(f"a negative prompt of at most {self.neg_width} ids is "
                                 "required")
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher closed")
            handle = PendingResult(self._count)
            self._count += 1
            self._pending.append((handle, payload, neg, int(seed), meta))
            self._wake.notify()
        return handle

    def close(self, timeout: float = 60.0) -> None:
        """Serve what was submitted, then stop the drive thread."""
        with self._lock:
            self._closed = True
            self._wake.notify()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"the drive thread did not stop within {timeout} s")

    def _embed_payload(self, prompt_ids, prompt_embeds, neg_prompt_embeds, prompt_mask):
        """An embedding request's host payload: (embeds, neg embeds, mask)."""
        if prompt_ids is not None or prompt_embeds is None or neg_prompt_embeds is None:
            raise ValueError("an embedding-mode batcher takes prompt_embeds and "
                             "neg_prompt_embeds (the CFG unconditional rows), not prompt_ids")
        if any(isinstance(t, torch.Tensor) and t.device.type != "cpu"
               for t in (prompt_embeds, neg_prompt_embeds, prompt_mask)):
            raise ValueError("submit takes host data: a device tensor would need a CUDA "
                             "call from the client's thread")
        pe, ne = torch.as_tensor(prompt_embeds), torch.as_tensor(neg_prompt_embeds)
        if pe.dim() != 2 or pe.shape[1] != self.embed_dim or not 0 < pe.shape[0] <= self.P:
            raise ValueError(f"prompt_embeds {tuple(pe.shape)}: expected [1..{self.P}, "
                             f"{self.embed_dim}]")
        if ne.shape != pe.shape:
            raise ValueError("neg_prompt_embeds must have prompt_embeds' shape")
        pm = (torch.ones(pe.shape[0], dtype=torch.bool) if prompt_mask is None
              else torch.as_tensor(prompt_mask, dtype=torch.bool).reshape(pe.shape[0]))
        return pe, ne.to(pe.dtype), pm

    # -- drive loop ------------------------------------------------------

    @staticmethod
    def _pad_row(ids: List[int], width: int):
        pad = width - len(ids)
        return [0] * pad + ids, [False] * pad + [True] * len(ids)

    def _rows(self, reqs: Dict[int, tuple], fill: tuple) -> dict:
        """[B]-row engine arguments (host numpy or CPU tensors) and per-slot
        seeds; slots outside ``reqs`` get ``fill``'s prompt."""
        B = self.B
        seeds = [reqs[b][3] if b in reqs else 0 for b in range(B)]
        gstate = {}
        if self.make_gstate is not None:
            gstate["gstate"] = self.make_gstate([reqs[b][4] if b in reqs else None
                                                 for b in range(B)])
        if self.embed_dim:
            pe_rows, ne_rows, mask_rows = [], [], []
            for b in range(B):
                pe, ne, pm = reqs.get(b, fill)[1]
                z = torch.zeros((self.P - pe.shape[0], self.embed_dim), dtype=pe.dtype)
                pe_rows.append(torch.cat([z, pe]))
                ne_rows.append(torch.cat([z, ne]))
                mask_rows.append(torch.cat([torch.zeros(len(z), dtype=torch.bool), pm]))
            kw = dict(prompt=None, prompt_embeds=torch.stack(pe_rows),
                      neg_prompt_embeds=torch.stack(ne_rows),
                      prompt_mask=torch.stack(mask_rows), **gstate)
            return dict(kw=kw, seeds=seeds)
        ids_rows, mask_rows, neg_rows, negm_rows = [], [], [], []
        for b in range(B):
            r = reqs.get(b, fill)
            row, m = self._pad_row(r[1], self.P)
            ids_rows.append(row)
            mask_rows.append(m)
            if self.neg_width:
                row, m = self._pad_row(r[2], self.neg_width)
                neg_rows.append(row)
                negm_rows.append(m)
        kw = dict(prompt=np.asarray(ids_rows, np.int32),
                  prompt_mask=np.asarray(mask_rows, bool), **gstate)
        if self.neg_width:
            kw.update(neg_prompt=np.asarray(neg_rows, np.int32),
                      neg_mask=np.asarray(negm_rows, bool))
        return dict(kw=kw, seeds=seeds)

    def _drive(self) -> None:
        """The drive loop; an error outside a batch (none is expected) fails
        every queued request and closes the batcher, so no wait hangs."""
        try:
            self._drive_loop()
        except Exception as e:
            _log.exception("StreamingBatcher: the drive thread failed")
            with self._lock:
                self._closed = True
                queued, self._pending = self._pending, []
            for r in queued:
                r[0]._fail(e)

    def _drive_loop(self) -> None:
        eng = self.engine
        dev = eng.device
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        B = self.B
        occupants: List[Optional[PendingResult]] = [None] * B
        fill: Optional[tuple] = None  # the prompt idle slots carry
        state = None

        def take(n):
            out = []
            while self._pending and len(out) < n:
                out.append(self._pending.pop(0))
            return out

        def set_in_flight():
            with self._lock:
                self._in_flight = sum(o is not None for o in occupants)

        while True:
            with self._lock:
                while not self._pending and not self._closed and state is None:
                    self._wake.wait()
                if self._closed and not self._pending and all(o is None for o in occupants):
                    return
                new = take(B if state is None else sum(o is None for o in occupants))
            try:
                if state is None:
                    if not new:
                        continue
                    reqs = dict(enumerate(new))
                    for b, r in reqs.items():
                        occupants[b] = r[0]
                    fill = new[0]
                    rows = self._rows(reqs, fill)
                    _, state = eng.generate(
                        self.params, seed_generators(rows["seeds"], dev),
                        max_steps=self.chunk_steps, return_state=True, **rows["kw"])
                    with self._lock:
                        self._batches += 1
                        self._chunks += 1
                    set_in_flight()
                    continue

                # chunk boundary: harvest the finished occupied slots
                finished = state.finished.cpu().numpy()
                lengths = None
                for b in range(B):
                    h = occupants[b]
                    if h is None or not finished[b]:
                        continue
                    if lengths is None:
                        lengths = state.length.cpu().numpy()
                    n = int(lengths[b])
                    done = CompletedGeneration(
                        prompt_index=h.index,
                        tokens=state.tokens[b, :n].cpu().numpy().copy(),
                        gen_count=n - state.prompt_rows)
                    occupants[b] = None
                    with self._lock:
                        self._completed += 1
                        self._tokens_out += done.gen_count
                        self._metrics.update(latency_s=time.perf_counter() - h.submitted_at,
                                             gen_tokens=done.gen_count)
                    h._resolve(done)

                # slots the harvest freed admit requests at this boundary
                free = sum(o is None for o in occupants) - len(new)
                if free > 0:
                    with self._lock:
                        new += take(free)
                if new:
                    reqs = {}
                    for r in new:
                        b = occupants.index(None)
                        occupants[b] = r[0]
                        reqs[b] = r
                    rows = self._rows(reqs, fill)
                    refill_mask = np.zeros((B,), bool)
                    refill_mask[list(reqs)] = True
                    state = eng.refill(self.params, state, refill_mask=refill_mask,
                                       rng=seed_generators(rows["seeds"], dev), **rows["kw"])
                    with self._lock:
                        self._refills += 1
                set_in_flight()
                if all(o is None for o in occupants):
                    state = None  # park until the next request
                    continue
                _, state = eng.resume(self.params, state, max_steps=self.chunk_steps,
                                      return_state=True)
                with self._lock:
                    self._chunks += 1
            except Exception as e:  # the serving loop must outlive one failed batch
                # only the occupants reached the failed batch: fail them;
                # queued requests stay queued for a fresh batch
                _log.exception("StreamingBatcher: a batch failed")
                for b in range(B):
                    if occupants[b] is not None:
                        occupants[b]._fail(e)
                        occupants[b] = None
                set_in_flight()
                state = None
