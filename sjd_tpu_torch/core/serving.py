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

Data-parallel slots (``row_sharding``, both batchers): the value is a
``parallel.make_mesh`` mesh (its 'data' axis) or a data-axis
``ProcessGroup``. Every rank of the data axis runs the batcher; data rank d
holds slots ``[d B/n, (d+1) B/n)`` in its own engine (and its own CUDA
graph). At each chunk boundary the ranks all-gather the finished flags,
the lengths and the NFE, and the token rows when a slot finished; every
rank then harvests and refills in global slot order from the same queue,
so the stream is the one-device stream: the NFE is the longest rank's (as
one device steps until its last slot finishes), a refill counts one forward
on every rank, and ``last_accept_hist`` is summed over the ranks. A mesh
with a 'model' axis too runs each data rank's engine tensor-parallel.
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
from .engine import seeded_generator, slot_generators

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


class _DataAxis:
    """``row_sharding`` resolved: this rank's slots of a batch and the
    chunk boundary's gathers over the data axis (none on one rank)."""

    def __init__(self, row_sharding: Any):
        self.group, self.rank, self.size = None, 0, 1
        if row_sharding is None:
            return
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        if isinstance(row_sharding, DeviceMesh):
            names = row_sharding.mesh_dim_names or ()
            if "data" not in names:
                raise ValueError(f"row_sharding: a mesh without a 'data' axis ({names})")
            n = row_sharding.mesh.shape[names.index("data")]
            if n == 1:
                return
            group = row_sharding.get_group("data")
        elif dist.is_initialized() and isinstance(row_sharding, dist.ProcessGroup):
            group = row_sharding
        else:
            raise ValueError(f"row_sharding takes a parallel.make_mesh mesh or the data "
                             f"axis' ProcessGroup, not {type(row_sharding).__name__}")
        self.group, self.rank, self.size = (group, dist.get_rank(group),
                                            dist.get_world_size(group))

    def slots(self, B: int) -> slice:
        """This rank's slots of a batch of ``B``."""
        if B % self.size:
            raise ValueError(f"a batch of {B} slots does not split over {self.size} data "
                             "ranks")
        n = B // self.size
        return slice(self.rank * n, (self.rank + 1) * n)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """[size * rows, ...]: every rank's ``x`` in rank order."""
        import torch.distributed as dist

        x = x.contiguous()
        out = torch.empty((self.size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out

    def boundary(self, state) -> tuple:
        """(finished [B], lengths [B], NFE) of the whole batch, host values;
        the NFE is the longest rank's."""
        local = torch.stack([state.finished.to(torch.int64), state.length.to(torch.int64)], 1)
        if self.size == 1:
            both = local.cpu().numpy()
            return both[:, 0].astype(bool), both[:, 1], state.nfe
        nfe = torch.tensor([[state.nfe, 0]], dtype=torch.int64, device=local.device)
        both = self._gather(torch.cat([local, nfe])).cpu().numpy()
        per = both.reshape(self.size, -1, 2)
        rows = per[:, :-1].reshape(-1, 2)
        return rows[:, 0].astype(bool), rows[:, 1], int(per[:, -1, 0].max())

    def token_rows(self, state, slots: Sequence[int]) -> Dict[int, np.ndarray]:
        """The token rows of global ``slots`` (host copies)."""
        if self.size == 1:
            return {b: state.tokens[b].cpu().numpy().copy() for b in slots}
        every = self._gather(state.tokens).cpu().numpy()
        return {b: every[b].copy() for b in slots}

    def sum(self, t: torch.Tensor) -> np.ndarray:
        if self.size == 1:
            return t.cpu().numpy().copy()
        return self._gather(t[None]).sum(0).cpu().numpy()

    def broadcast(self, obj):
        """Data rank 0's ``obj`` on every rank."""
        if self.size == 1:
            return obj
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=dist.get_global_rank(self.group, 0),
                                   group=self.group)
        return box[0]


def _local_generators(rng, B: int, sl: slice, device):
    """This rank's slots of the per-slot generators one device would spawn
    from ``rng`` (a seed or B generators)."""
    if isinstance(rng, (int, np.integer)):
        return slot_generators(int(rng), B, device)[sl]
    return list(rng)[sl]


class ContinuousBatcher:
    """Run a stream of same-width prompts through B engine slots.

    prompts: [N, P] int (pad shorter prompts and pass prompt_masks).
    ``chunk_steps`` trades refill latency against host round trips: a
    finished slot idles for at most one chunk before it is refilled.
    ``make_gstate(indices) -> GrammarState`` supplies per-prompt grammar
    state; by default the engine's own. ``row_sharding`` spreads the slots
    over the data axis (module docstring): every data rank calls ``run``
    with the same arguments, and the completions come back on each.

    Batch width: on bf16 (or f16) weights on CUDA a request's tokens can
    change with the number of slots, because cuBLAS picks its GEMM kernel,
    and so its summation order, by the row count M (seen at width 5 on an
    H100). Quantized weights keep the tokens at every width (K1/K2 never
    split by M; ``chip_smoke.py``'s ``widths_w4a16`` holds it), and so
    does the CPU.
    """

    def __init__(self, engine, params, *, chunk_steps: int = 128,
                 make_gstate: Optional[Callable[[List[int]], Any]] = None,
                 row_sharding: Any = None):
        self.engine = engine
        self.params = params
        self.chunk_steps = chunk_steps
        self.make_gstate = make_gstate
        self.rows = _DataAxis(row_sharding)
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

        axis = self.rows
        sl = axis.slots(B)  # this rank's slots
        slot_prompt: List[Optional[int]] = list(range(B))  # stream index per slot
        next_idx = B
        done: List[CompletedGeneration] = []
        self.last_refills = []

        def batch_rows(idx_list):
            """This rank's rows of the [B] global ``idx_list``."""
            idx_list = idx_list[sl]
            ids = torch.as_tensor(prompts[idx_list], dtype=torch.int32, device=dev)
            mask = torch.as_tensor(prompt_masks[idx_list], dtype=torch.bool, device=dev)
            neg = (torch.as_tensor(neg_prompts[idx_list], dtype=torch.int32, device=dev)
                   if neg_prompts is not None else None)
            g = self.make_gstate(list(idx_list)) if self.make_gstate else None
            return ids, mask, neg, g

        def gens_for(idx_list):
            return seed_generators([seeds[i] for i in idx_list[sl]], dev)

        ids, mask, neg, g = batch_rows(slot_prompt)
        _, state = eng.generate(
            self.params, gens_for(slot_prompt) if seeds is not None
            else rng if axis.size == 1 else _local_generators(rng, B, sl, dev),
            ids, prompt_mask=mask, neg_prompt=neg, gstate=g,
            max_steps=self.chunk_steps, return_state=True)

        def harvest(state) -> List[int]:
            """Collect finished slots into ``done``; return their indices.
            The [B] flags come first; token rows only when a slot finished
            (most chunk boundaries harvest nothing), copied: the state's
            buffers are reused. Over a data axis the state's NFE becomes
            the longest rank's."""
            finished, lengths, state.nfe = axis.boundary(state)
            hits = [b for b in range(B) if finished[b] and slot_prompt[b] is not None]
            if not hits:
                return []
            rows = axis.token_rows(state, hits)
            for b in hits:
                n = int(lengths[b])
                done.append(CompletedGeneration(
                    prompt_index=slot_prompt[b], tokens=rows[b][:n],
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
                refill_mask = np.zeros((B,), bool)
                refill_mask[refill_slots] = True
                self.last_refills.append(dict(
                    nfe=state.nfe, refilled={b: slot_prompt[b] for b in refill_slots},
                    live=[slot_prompt[b] for b in range(B)
                          if b not in refill_slots and slot_prompt[b] is not None]))
                if refill_mask[sl].any():
                    ids, mask, neg, g = batch_rows(idx_rows)
                    state = eng.refill(
                        self.params, state, ids, refill_mask[sl], prompt_mask=mask,
                        neg_prompt=neg, gstate=g,
                        rng=gens_for(idx_rows) if seeds is not None else None)
                else:  # another rank's refill: one forward of the batch's NFE
                    state.nfe += 1
            _, state = eng.resume(self.params, state, max_steps=self.chunk_steps,
                                  return_state=True)

        self.last_accept_hist = axis.sum(state.accept_hist)
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
    a refill, so its draws are a function of (prompt, seed) alone, whatever
    the arrival order and the co-scheduled load. So are its tokens on
    quantized weights and on the CPU; on bf16 weights on CUDA they can
    change with the batch width, because cuBLAS picks its GEMM kernel by
    the row count M (:class:`ContinuousBatcher`). Idle slots carry a copy of
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

    With ``row_sharding`` (module docstring) every data rank builds the
    batcher; clients ``submit`` on data rank 0 only. Its drive thread
    broadcasts the requests it admits (and its stop) at each chunk
    boundary, and every rank's drive thread admits them into the same
    slots, so only drive threads call collectives. While idle, rank 0 sends
    an empty admission every ``HEARTBEAT_S`` seconds, so that no rank waits
    in a collective for long. A failed batch fails every request and stops
    the batcher (the ranks cannot go on apart).
    """

    HEARTBEAT_S = 1.0

    def __init__(self, engine, params, *, batch: int = 4, chunk_steps: int = 128,
                 prompt_width: int, neg_width: int = 0, embed_dim: int = 0,
                 make_gstate: Optional[Callable[[List[Optional[dict]]], Any]] = None,
                 row_sharding: Any = None):
        self.rows = _DataAxis(row_sharding)
        self.rows.slots(batch)  # the batch must split over the data axis
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
        if self.rows.rank != 0:
            raise ValueError("requests are submitted on data rank 0, whose drive thread "
                             "admits them on every rank")
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
        """This rank's rows of the engine arguments (host numpy or CPU
        tensors) and per-slot seeds; slots outside ``reqs`` get ``fill``'s
        prompt."""
        slots = range(self.B)[self.rows.slots(self.B)]
        seeds = [reqs[b][3] if b in reqs else 0 for b in slots]
        gstate = {}
        if self.make_gstate is not None:
            gstate["gstate"] = self.make_gstate([reqs[b][4] if b in reqs else None
                                                 for b in slots])
        if self.embed_dim:
            pe_rows, ne_rows, mask_rows = [], [], []
            for b in slots:
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
        for b in slots:
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
        axis = self.rows
        sl = axis.slots(B)
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

        def admit() -> tuple:
            """(the requests admitted into the free slots, stop): decided by
            data rank 0 (or the one rank) and sent to the others."""
            if axis.rank == 0:
                with self._lock:
                    if state is None and not self._pending and not self._closed:
                        if axis.size == 1:
                            while not self._pending and not self._closed:
                                self._wake.wait()
                        else:
                            self._wake.wait(self.HEARTBEAT_S)
                    stop = (self._closed and not self._pending
                            and all(o is None for o in occupants))
                    new = [] if stop else take(sum(o is None for o in occupants))
                if axis.size == 1:
                    return new, stop
                sent = axis.broadcast(([r[1:] + (r[0].index,) for r in new], stop))
                return new, sent[1]
            got, stop = axis.broadcast(None)
            # this rank's handles of the admitted requests (resolved here,
            # waited on only at rank 0)
            return [(PendingResult(r[-1]),) + tuple(r[:-1]) for r in got], stop

        while True:
            try:
                if state is not None:
                    self._harvest(state, occupants)
                new, stop = admit()
                if stop:
                    with self._lock:
                        self._closed = True
                    return
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

                if new:
                    reqs = {}
                    for r in new:
                        b = occupants.index(None)
                        occupants[b] = r[0]
                        reqs[b] = r
                    refill_mask = np.zeros((B,), bool)
                    refill_mask[list(reqs)] = True
                    if refill_mask[sl].any():
                        rows = self._rows(reqs, fill)
                        state = eng.refill(self.params, state, refill_mask=refill_mask[sl],
                                           rng=seed_generators(rows["seeds"], dev),
                                           **rows["kw"])
                    else:  # another rank's refill: one forward of the batch's NFE
                        state.nfe += 1
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
                if axis.size > 1:
                    raise  # the data ranks cannot go on apart: _drive fails everything
                # only the occupants reached the failed batch: fail them;
                # queued requests stay queued for a fresh batch
                _log.exception("StreamingBatcher: a batch failed")
                for b in range(B):
                    if occupants[b] is not None:
                        occupants[b]._fail(e)
                        occupants[b] = None
                set_in_flight()
                state = None

    def _harvest(self, state, occupants: List[Optional["PendingResult"]]) -> None:
        """Chunk boundary: resolve the finished occupied slots (over a data
        axis from the gathered flags and rows; the state's NFE becomes the
        longest rank's)."""
        finished, lengths, state.nfe = self.rows.boundary(state)
        hits = [b for b, h in enumerate(occupants) if h is not None and finished[b]]
        if not hits:
            return
        rows = self.rows.token_rows(state, hits)
        for b in hits:
            h = occupants[b]
            n = int(lengths[b])
            done = CompletedGeneration(prompt_index=h.index, tokens=rows[b][:n],
                                       gen_count=n - state.prompt_rows)
            occupants[b] = None
            with self._lock:
                self._completed += 1
                self._tokens_out += done.gen_count
                self._metrics.update(latency_s=time.perf_counter() - h.submitted_at,
                                     gen_tokens=done.gen_count)
            h._resolve(done)
