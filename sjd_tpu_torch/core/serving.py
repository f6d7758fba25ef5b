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

``StreamingBatcher``/``PendingResult``, prompt embeddings and data-parallel
slots (``row_sharding``) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .engine import seeded_generator


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
