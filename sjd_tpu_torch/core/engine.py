"""The SJD engine (sjd_tpu/core/engine.py) in PyTorch: a decode step that
is captured once as a CUDA graph and replayed.

Static shapes throughout, as in the JAX engine: a [B, L_buf] token buffer,
the [S, NL, L_buf, Hkv, D] KV buffer written in place, a [B, W] draft
window. KV "rollback" is free: acceptance only advances each sample's
``length``, and the next window overwrites rejected rows. CFG runs as a
doubled batch ([cond; uncond]) through one forward, with the uncond prompt
either masked down to its last token (``mask_prompt``, Lumina) or a
separate negative prompt (``neg_prompt``).

The step writes its results in place into the state's own tensors, the
counterpart of the JAX engine's donated state, so a decode step is a fixed
sequence of kernels over fixed buffers. The JAX engine runs the whole
generation as one jit-compiled ``while_loop``; here, on CUDA, the first
decode step of a shape runs eagerly (the warm-up: kernel libraries, the
attention kernel's shared-memory limit, cuBLAS handles), then the step is
captured once as a CUDA graph per (shape, params) and replayed for every
further step. The host checks ``finished`` and the NFE cap after each step,
as the ``while_loop``'s condition does. On the CPU, or with
``cuda_graph=False``, the same step runs eagerly. A capture or replay that
fails raises: there is no eager fallback.

The engine owns one state (the KV cache, tokens, lengths, ...) and the
graph captured over it: ``generate``'s prefill writes into it, and the
``EngineState`` it returns aliases it, so a later ``generate`` overwrites
it; a ``generate`` of another shape releases both and allocates anew. Keep
only the returned state, as with the JAX engine's donated buffers:
``res, state = eng.resume(params, state, ...)``; ``resume`` of a state the
engine no longer owns raises. ``GenerateResult`` holds copies and
survives.

Randomness: one ``torch.Generator`` per slot. Each step draws, per slot and
in a fixed order, the fresh draft seeds, the Gumbel noise for the window's
samples, the acceptance uniforms and the Gumbel noise for the residual
resample (``_draws``, on the host side of the replay: the draws are copied
into the graph's input buffers), so a slot's trajectory depends on its own
generator alone, on either path, and ``refill`` can give a slot a new
generator without a recapture.

Tensor parallelism: ``params`` may be one rank's shard of a
tensor-parallel tree (``parallel.sharding.shard_params``' ``LocalParams``,
or a DTensor tree, made local once per params object and kept, as the
graph is). Each rank of the model axis then runs the same loop on the same
slots with its own cache of its KV heads; the forward's logits are
gathered whole on every rank, and the ranks draw from the same per-slot
generators, so every host-side choice is the same on each. At the end of
each ``generate``/``resume`` the ranks' tokens and lengths are compared and
any difference raises. Under a model axis of more than one rank the step
runs eagerly: ``cuda_graph=True`` on CUDA raises (a gloo collective
cannot be captured, and the capture over NCCL is not written), so the
caller passes ``cuda_graph=False``. Data parallelism needs no collective
inside the step: each data rank runs its own engine on its own slots
(``core.serving``'s ``row_sharding``) and replays its own graph.

A prompt enters as token ids or, for LlamaGen's conditioning prefix, as
embeddings (``prompt_embeds``, with zero placeholder ids of the same width
in the token buffer); only the prefill reads them, so the decode step and
its graph are the same either way.

``ar_fast_path=True`` runs the steps where no live slot is inside
``[interval_l, interval_r)`` as width-1 forwards (the JAX engine's
``lax.cond`` between the two step widths). The state keeps its full-width
shapes; on CUDA the width-1 step is a second captured graph over the same
state tensors, in the same memory pool as the first. The step writes
``finished.all()``, ``any_multi`` of the next step and the count of
finished slots into ``flags``, which the host reads in one copy before each
step (the default path reads it too) and replays one graph or the other.
A step of either width draws the full-width random inputs and reads their
first rows, so a slot's generator advances the same way on both. The
flags read also counts the slot-steps spent on finished slots
(``EngineState.finished_slot_steps``).

Tracing (``utils/tracing.py``): while it is on, each call is a span
(``engine.generate``, ``engine.resume``, ``engine.refill``, with its
prefill as ``engine.prefill``) and each decode step records its phases as
children of the call: ``engine.step.wait`` (the flags read, where the host
waits for the card), ``engine.step.draws``, ``engine.step.copy`` (into the
graph's buffers) and ``engine.step.replay``, or ``engine.step.eager`` for
a step run eagerly, and ``engine.capture`` for a capture.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import acceptance as acceptance_lib
from . import drafts as drafts_lib
from . import grammar as grammar_lib
from . import processors as processors_lib
from . import sampling as sampling_lib
from ..utils import compile_watch, tracing

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static decode-loop configuration (sjd_tpu's EngineConfig)."""

    window: int = 16
    interval_l: int = 1
    interval_r: int = 10**9
    scheme: str = "speculative_jacobi"  # | "jacobi"
    init: str = "random"  # | "repeat_horizon"
    max_len: int = 4096  # maximum GENERATED tokens
    buf_len: int = 0  # 0 -> max_len + 2*window + prompt rows
    eos_id: int = -1
    pad_id: int = 0
    nfe_cap: int = 0  # 0 -> max_len
    cfg_mode: str = "none"  # | "mask_prompt" | "neg_prompt"
    grammar_seed: bool = True

    def resolved_buf_len(self, prompt_rows: int = 0) -> int:
        return self.buf_len or (self.max_len + 2 * self.window + prompt_rows)

    def resolved_nfe_cap(self) -> int:
        return self.nfe_cap or self.max_len


class ModelFns(NamedTuple):
    """What the engine needs from a backbone.

    forward(params, ids [S,T], positions [S,T], kv, cache_end [S],
            valid [S, L_buf], logits_tail[, inputs_embeds [S,T,d]])
        -> (logits [S, tail, V] f32, kv)
    init_cache(batch, buf_len) -> KV cache on the model's device
    """

    forward: Callable[..., Any]
    init_cache: Callable[[int, int], Any]
    vocab_size: int
    device: torch.device


@dataclasses.dataclass
class EngineState:
    gens: List[torch.Generator]  # one per slot
    tokens: Tensor  # [B, L_buf] int32
    length: Tensor  # [B] rows occupied (padded prompt + committed)
    n_pad: Tensor  # [S] left-pad / masked rows in the cached prefix
    kv: Any
    valid: Tensor  # [S, kv_buf_len] bool
    carried_tokens: Tensor  # [B, W]
    carried_probs: Tensor  # [B, W, V]
    carried_count: Tensor  # [B]
    last_prob: Tensor  # [B, V]
    gstate: grammar_lib.GrammarState
    finished: Tensor  # [B] bool
    nfe: int  # model forwards
    steps_multi: Tensor  # scalar int32: forwards with window > 1
    prompt_len: Tensor  # [B] real prompt length
    prompt_rows: int  # padded prompt rows in `tokens`
    accept_hist: Tensor  # [W+1] int32: decode steps by accepted length
    # [3] int32 for the next step: every slot finished; a live slot inside
    # [interval_l, interval_r); the finished slots. The step writes them, the
    # host reads them in one copy
    flags: Tensor
    # decode steps x slots, and those of slots that had finished before the
    # step (they wait for the caller's next chunk boundary); host counts
    # from the flags read
    slot_steps: int = 0
    finished_slot_steps: int = 0


# the EngineState tensors with one row per slot (refill selects them per slot)
_B_FIELDS = ("tokens", "length", "carried_tokens", "carried_probs", "carried_count",
             "last_prob", "finished", "prompt_len")


class StepDraws(NamedTuple):
    rand: Tensor  # [B, W-1] int32 fresh draft seeds
    gumbel_tok: Optional[Tensor]  # [B, W, V] noise for the window's samples
    u: Optional[Tensor]  # [B, W-1] acceptance uniforms
    gumbel_res: Optional[Tensor]  # [B, V] noise for the residual resample


class GenerateResult(NamedTuple):
    tokens: Tensor  # [B, L_buf]
    length: Tensor  # [B]
    nfe: int
    steps_multi: Tensor
    gen_count: Tensor  # [B] tokens generated
    accept_hist: Tensor  # [W+1]


@dataclasses.dataclass
class GraphStats:
    """Capture and replay accounting (the counterpart of the JAX package's
    compile accounting, utils/compile_watch.py).

    A kernel wrapper counts a launch when Python calls it, so a capture
    counts the launches it records (which do not run then) and a replay
    counts none. ``executed(counts)`` turns the wrappers' counters into the
    launches that ran: minus the captures' records, plus each replay's."""

    captures: int = 0
    capture_s: float = 0.0  # wall seconds inside captures
    replays: int = 0
    eager_steps: int = 0  # decode steps run eagerly (warm-up, CPU, cuda_graph=False)
    # the same, by step width (the window, and 1 on the AR fast path)
    captures_by_width: Dict[int, int] = dataclasses.field(default_factory=dict)
    replays_by_width: Dict[int, int] = dataclasses.field(default_factory=dict)
    eager_by_width: Dict[int, int] = dataclasses.field(default_factory=dict)
    captured_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    replayed_launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    def executed(self, counts: Dict[str, int]) -> Dict[str, int]:
        return {k: n - self.captured_launches.get(k, 0) + self.replayed_launches.get(k, 0)
                for k, n in counts.items()}


class _Graph(NamedTuple):
    graph: Any  # torch.cuda.CUDAGraph over the engine's state
    params: Any  # the params object captured (kept alive with the graph)
    draws: StepDraws  # the graph's input buffers
    launches: Dict[str, int]  # kernel launches one replay runs


def _model_size(params) -> int:
    """The model axis' ranks of a params tree (1 unless it is one rank's
    shard, ``parallel.sharding.LocalParams``)."""
    return getattr(params, "model_size", 1)


def _add(into: Dict, counts: Dict, times: int = 1) -> None:
    for k, n in counts.items():
        into[k] = into.get(k, 0) + times * n


def seeded_generator(seq: np.random.SeedSequence, device) -> torch.Generator:
    """A generator on ``device`` seeded from a numpy SeedSequence."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return g


def slot_generators(seed: int, batch: int, device) -> List[torch.Generator]:
    """``batch`` independent per-slot generators spawned from one seed."""
    return [seeded_generator(child, device)
            for child in np.random.SeedSequence(seed).spawn(batch)]


def _derived_generator(gen: torch.Generator, salt: int) -> torch.Generator:
    """A generator seeded from ``gen``'s initial seed and ``salt``, leaving
    ``gen`` where it is (jax.random.fold_in's role in refill)."""
    return seeded_generator(np.random.SeedSequence([gen.initial_seed(), int(salt)]),
                            gen.device)


class SJDEngine:
    def __init__(self, model: ModelFns, config: EngineConfig,
                 grammar_spec: grammar_lib.GrammarSpec,
                 sampling_params: processors_lib.SamplingParams,
                 *, cuda_graph: bool = True, ar_fast_path: bool = False):
        """``cuda_graph``: on CUDA, replay a captured graph of the decode
        step (the default) or run every step eagerly (False). The CPU always
        runs eagerly. ``ar_fast_path``: width-1 forwards for the steps where
        no live slot is inside the SJD interval (module docstring); off by
        default, as in the JAX engine."""
        if config.scheme not in ("speculative_jacobi", "jacobi"):
            raise ValueError(f"unknown scheme {config.scheme!r}")
        self.model = model
        self.config = config
        self.spec = grammar_spec
        do_cfg = (sampling_params.do_cfg and config.cfg_mode != "none"
                  and sampling_params.guidance_scale != 1.0)
        self.sampling = dataclasses.replace(sampling_params, do_cfg=do_cfg)
        self.cuda_graph = cuda_graph
        self.ar_fast_path = ar_fast_path
        self.stats = GraphStats()
        self._state: Optional[EngineState] = None  # reused while the shape holds
        self._graphs: Dict[int, _Graph] = {}  # by step width, captured over self._state
        self._warm: set = set()  # the widths whose warm-up step ran on self._state
        self._pool = None  # the graphs' shared memory pool
        self._stream = None  # the side stream of warm-up and capture
        # the last params object given and what the forward computes with
        # (parallel.sharding.local_tree: a DTensor tree made local once)
        self._params_in: Any = None
        self._params_local: Any = None
        self._state_model_size = 1  # the model axis the state's cache was made for
        # batch -> GrammarState, for generate/refill calls that pass no
        # gstate; a family whose grammar needs a pre-armed state (Emu3's
        # grid) installs it, else the default init_state would leave that
        # grammar a no-op
        self.default_gstate: Optional[Callable[[int], grammar_lib.GrammarState]] = None

    @property
    def device(self) -> torch.device:
        return self.model.device

    # -- public API -----------------------------------------------------------

    def generate(
        self,
        params,
        rng: Union[int, Sequence[torch.Generator]],
        prompt: Optional[Tensor] = None,  # [B, P] int (left-padded)
        prompt_mask: Optional[Tensor] = None,  # [B, P] bool
        neg_prompt: Optional[Tensor] = None,  # [B, Pn] for cfg_mode=neg_prompt
        neg_mask: Optional[Tensor] = None,
        gstate: Optional[grammar_lib.GrammarState] = None,
        prompt_embeds: Optional[Tensor] = None,  # [B, P, d] conditioning rows
        neg_prompt_embeds: Optional[Tensor] = None,  # [B, P, d]
        max_steps: Optional[int] = None,
        return_state: bool = False,
    ):
        """``rng`` is a seed (spawned into per-slot generators) or a list of
        B generators on the engine's device, one per slot.

        The prompt is token ids or, LlamaGen's conditioning prefix,
        ``prompt_embeds`` (``prompt`` then None or ids of the same width,
        placeholders in the token buffer); under ``cfg_mode="neg_prompt"``
        CFG the uncond half is ``neg_prompt_embeds`` of the same shape, all
        rows attended. ``prompt_mask`` masks the cond half's rows either way.

        ``max_steps`` bounds the forwards of this call (the prefill counts
        one); with ``return_state`` and :meth:`resume` it chunks one
        generation into several calls with the same result. The returned
        state is the engine's own (module docstring)."""
        params = self._local_params(params)
        prompt, prompt_mask, neg_prompt, neg_mask, gstate, embeds = \
            self._normalize_prompt_inputs(prompt, prompt_mask, neg_prompt, neg_mask, gstate,
                                          prompt_embeds, neg_prompt_embeds)
        gens = self._normalize_rng(rng, prompt.shape[0])
        cap = self.config.resolved_nfe_cap() if max_steps is None else max_steps
        with tracing.span("engine.generate"), torch.no_grad():
            with tracing.span("engine.prefill"):
                state = self._prefill_state(params, gens, prompt, prompt_mask,
                                            neg_prompt, neg_mask, gstate, embeds)
            self._run(params, state, cap)
            self._check_ranks_agree(params, state)
            result = self._result_from_state(state)
        return (result, state) if return_state else result

    def resume(self, params, state: EngineState, max_steps: Optional[int] = None,
               return_state: bool = False):
        """Continue a generation returned with ``return_state=True`` for up
        to ``max_steps`` more forwards. ``state`` is updated in place; keep
        only the returned state, in the ``res, state = eng.resume(params,
        state, ...)`` pattern."""
        params = self._local_params(params)
        cap = state.nfe + (max_steps if max_steps is not None
                           else self.config.resolved_nfe_cap())
        with tracing.span("engine.resume"), torch.no_grad():
            self._run(params, state, cap)
            self._check_ranks_agree(params, state)
            result = self._result_from_state(state)
        return (result, state) if return_state else result

    def refill(
        self,
        params,
        state: EngineState,
        prompt: Optional[Tensor],  # [B, P]: P must match the original prompt rows
        refill_mask,  # [B] bool (host): slots to re-arm with fresh prompts
        prompt_mask: Optional[Tensor] = None,
        neg_prompt: Optional[Tensor] = None,
        neg_mask: Optional[Tensor] = None,
        gstate: Optional[grammar_lib.GrammarState] = None,
        rng: Union[None, int, Sequence[torch.Generator]] = None,
        prompt_embeds: Optional[Tensor] = None,
        neg_prompt_embeds: Optional[Tensor] = None,
    ) -> EngineState:
        """Continuous batching: re-arm the slots of ``refill_mask`` with
        fresh prompts between :meth:`resume` chunks, with one prefill
        forward (NFE rises by 1), while every other slot, its generator
        included, is left bit-exactly as it was.

        The prefill runs into a small cache of 512-row multiples, whose rows
        [0, R) are merged into the state's cache in place; tokens, lengths,
        carried drafts, grammar state and the rest are selected per slot,
        also in place, so a captured graph of the step replays on as
        before. ``prompt`` (or ``prompt_embeds``, with ``prompt`` None, as
        in :meth:`generate`) is padded to the original prompt's width; rows
        outside ``refill_mask`` are ignored. ``rng`` gives the refilled
        slots their generators (a seed or B generators; other rows are
        ignored). With None each refilled slot gets one derived from its old
        generator's initial seed and the NFE, without advancing any
        generator."""
        with tracing.span("engine.refill"):
            params = self._local_params(params)
            self._check_own(state)
            prompt, prompt_mask, neg_prompt, neg_mask, gstate, embeds = \
                self._normalize_prompt_inputs(prompt, prompt_mask, neg_prompt, neg_mask, gstate,
                                              prompt_embeds, neg_prompt_embeds)
            B = prompt.shape[0]
            dev = self.device
            mask = np.asarray(refill_mask.cpu() if isinstance(refill_mask, Tensor)
                              else refill_mask, dtype=bool).reshape(B)
            if rng is None:
                new_gens = [_derived_generator(g, state.nfe) for g in state.gens]
            else:
                new_gens = self._normalize_rng(rng, B)
            # the other slots' prefill noise comes from throwaway generators, so
            # that their own do not advance
            fill_gens = [new_gens[b] if mask[b] else torch.Generator(device=dev)
                         for b in range(B)]
            P_rows = prompt.shape[1]
            if self.config.cfg_mode == "neg_prompt" and self.sampling.do_cfg:
                P_rows = max(P_rows, neg_prompt.shape[1])
            small = min(((P_rows + self.config.window + 512) // 512) * 512, state.valid.shape[1])
            with torch.no_grad():
                with tracing.span("engine.prefill"):
                    fresh = self._prefill_state(params, fill_gens, prompt, prompt_mask,
                                                neg_prompt, neg_mask, gstate, embeds,
                                                kv_buf_rows=small)
                if fresh.tokens.shape != state.tokens.shape:
                    raise ValueError(
                        f"refill prompt rows must reproduce the engine's buffer: got "
                        f"{tuple(fresh.tokens.shape)} vs {tuple(state.tokens.shape)}; pad "
                        f"refill prompts to the original prompt width")
                idx_b = torch.as_tensor(np.flatnonzero(mask), device=dev)
                idx_s = torch.as_tensor(np.flatnonzero(np.tile(mask, self._S_factor)), device=dev)

                def put(dst, src, idx):
                    dst.index_copy_(0, idx, src.index_select(0, idx))

                R = fresh.valid.shape[1]
                # KV leaves are [S, NL, rows, ...]: only rows [0, R) carry the
                # fresh prompt; rows past R are the slot's old history, which
                # its next windows overwrite before they are read
                for dst, src in zip(state.kv, fresh.kv):
                    if dst is not None:
                        put(dst[:, :, :R], src, idx_s)
                put(state.valid[:, :R], fresh.valid, idx_s)
                put(state.n_pad, fresh.n_pad, idx_s)
                for name in _B_FIELDS:
                    put(getattr(state, name), getattr(fresh, name), idx_b)
                for dst, src in zip(state.gstate, fresh.gstate):
                    put(dst, src, idx_b)
            for b in np.flatnonzero(mask):
                state.gens[b] = new_gens[b]
            state.nfe += 1  # the refill prefill forward
            return state

    # -- implementation --------------------------------------------------------

    def _local_params(self, params):
        """What the forward computes with, made once per params object
        (``parallel.sharding.local_tree``); under a model axis of more than
        one rank, a CUDA graph is refused."""
        if params is not self._params_in:
            from ..parallel.sharding import local_tree  # parallel imports core

            local = local_tree(params)
            if _model_size(local) > 1 and self.cuda_graph and self.device.type == "cuda":
                raise ValueError(
                    "tensor-parallel params (a model axis of more than one rank) run the "
                    "decode step eagerly: a gloo collective cannot be captured in a CUDA "
                    "graph and the capture over NCCL is not written; build the engine "
                    "with cuda_graph=False")
            self._params_in, self._params_local = params, local
        return self._params_local

    @staticmethod
    def _check_ranks_agree(params, state: EngineState) -> None:
        """Under a model axis, every rank must hold the same tokens and
        lengths: raise where they drifted apart."""
        axis = getattr(params, "axis", None)
        if axis is not None:
            axis.check_equal(state.length, "lengths")
            axis.check_equal(state.tokens, "tokens")

    @property
    def _S_factor(self) -> int:
        return 2 if self.sampling.do_cfg else 1

    def _tile(self, x: Tensor) -> Tensor:
        return x if self._S_factor == 1 else torch.cat([x, x], dim=0)

    def _force_no_cfg(self, gstate: grammar_lib.GrammarState) -> Tensor:
        """CFG only inside an open image; kind "none" never disables it."""
        if self.spec.kind == "none":
            return torch.zeros_like(gstate.in_image)
        return ~gstate.in_image

    def _normalize_prompt_inputs(self, prompt, prompt_mask, neg_prompt, neg_mask, gstate,
                                 prompt_embeds=None, neg_prompt_embeds=None):
        """Shared by generate() and refill(): tensors on the engine's
        device, default masks and grammar state, the negative prompt, and
        for an embedding prompt its zero placeholder ids and the
        ``(prompt_embeds, neg_prompt_embeds)`` pair (else None)."""
        dev = self.device
        embeds = None
        if prompt_embeds is not None:
            pe = torch.as_tensor(prompt_embeds, device=dev)
            B, P = pe.shape[:2]
            prompt = torch.zeros((B, P), dtype=torch.int32, device=dev) if prompt is None \
                else torch.as_tensor(prompt, dtype=torch.int32, device=dev)
            if tuple(prompt.shape) != (B, P):
                raise ValueError(f"prompt {tuple(prompt.shape)} must match prompt_embeds' "
                                 f"{(B, P)}")
            if self.sampling.do_cfg and self.config.cfg_mode == "neg_prompt":
                if neg_prompt_embeds is None or neg_prompt_embeds.shape != pe.shape:
                    raise ValueError("embedding prompts need neg_prompt_embeds of the same "
                                     "shape")
                # the uncond half: placeholder ids, every row attended
                neg_prompt = torch.zeros((B, P), dtype=torch.int32, device=dev)
                neg_mask = torch.ones((B, P), dtype=torch.bool, device=dev)
            ne = (torch.zeros_like(pe) if neg_prompt_embeds is None
                  else torch.as_tensor(neg_prompt_embeds, device=dev))
            embeds = (pe, ne)
        prompt = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
        if prompt_mask is None:
            prompt_mask = torch.ones(prompt.shape, dtype=torch.bool, device=dev)
        prompt_mask = torch.as_tensor(prompt_mask, dtype=torch.bool, device=dev)
        if gstate is None:
            gstate = (self.default_gstate(prompt.shape[0]) if self.default_gstate is not None
                      else grammar_lib.init_state(prompt.shape[0], device=dev))
        if self.sampling.do_cfg and self.config.cfg_mode == "neg_prompt":
            if neg_prompt is None:
                raise ValueError("cfg_mode=neg_prompt requires neg_prompt")
            neg_prompt = torch.as_tensor(neg_prompt, dtype=torch.int32, device=dev)
            neg_mask = (torch.ones(neg_prompt.shape, dtype=torch.bool, device=dev)
                        if neg_mask is None else
                        torch.as_tensor(neg_mask, dtype=torch.bool, device=dev))
        return prompt, prompt_mask, neg_prompt, neg_mask, gstate, embeds

    def _normalize_rng(self, rng, batch: int) -> List[torch.Generator]:
        if isinstance(rng, (int, np.integer)):
            return slot_generators(int(rng), batch, self.device)
        gens = list(rng)
        if len(gens) != batch:
            raise ValueError(f"need {batch} per-slot generators, got {len(gens)}")
        return gens

    def _result_from_state(self, state: EngineState) -> GenerateResult:
        # copies: the state's tensors are reused by the next call
        return GenerateResult(
            tokens=state.tokens.clone(), length=state.length.clone(), nfe=state.nfe,
            steps_multi=state.steps_multi.clone(),
            gen_count=state.length - state.prompt_rows,
            accept_hist=state.accept_hist.clone())

    def _prefill_state(self, params, gens, prompt, prompt_mask, neg_prompt,
                       neg_mask, gstate0, embeds=None,
                       kv_buf_rows: Optional[int] = None) -> EngineState:
        """The post-prefill state, written into the engine's state if it has
        this shape (else allocated anew). ``embeds`` is the (cond, uncond)
        embedding prompt, which the prefill reads in place of the ids' rows.
        ``kv_buf_rows`` sets the KV buffer's rows instead: refill's small
        cache, a fresh state that the engine does not keep."""
        cfg = self.config
        dev = self.device
        B, P = prompt.shape
        W = cfg.window
        V = self.model.vocab_size
        neg_cfg = cfg.cfg_mode == "neg_prompt" and self.sampling.do_cfg
        P_rows = max(P, neg_prompt.shape[1]) if neg_cfg else P
        L_buf = cfg.resolved_buf_len(P_rows)
        kv_buf = kv_buf_rows if kv_buf_rows is not None else L_buf + W + 1
        align = 512 if kv_buf > 512 else 8
        kv_buf = ((kv_buf + align - 1) // align) * align
        S = B * self._S_factor
        tp_size = _model_size(params)
        static = None
        if kv_buf_rows is None:
            old = self._state
            shapes = ((B, L_buf), (S, kv_buf), tp_size)
            if old is not None and (old.tokens.shape, old.valid.shape,
                                    self._state_model_size) == shapes:
                static = old
            else:
                # another shape: release the old state and its graph before
                # the new cache is allocated
                self._state, self._graphs, self._warm = None, {}, set()

        if neg_cfg:
            Pc = max(P, neg_prompt.shape[1])

            def lpad(ids, mask):
                pad = Pc - ids.shape[1]
                return (F.pad(ids, (pad, 0), value=cfg.pad_id),
                        F.pad(mask, (pad, 0), value=False))

            prompt, prompt_mask = lpad(prompt, prompt_mask)
            neg_ids, neg_m = lpad(neg_prompt, neg_mask)
            prompt_s = torch.cat([prompt, neg_ids], dim=0)
            mask_s = torch.cat([prompt_mask, neg_m], dim=0)
            P = Pc
        elif cfg.cfg_mode == "mask_prompt" and self.sampling.do_cfg:
            # uncond half: the same ids with the prompt masked down to its
            # last real token
            m = prompt_mask.to(torch.int32)
            last_col = torch.cumsum(m, dim=1) == m.sum(1, keepdim=True)
            prompt_s = torch.cat([prompt, prompt], dim=0)
            mask_s = torch.cat([prompt_mask, prompt_mask & last_col], dim=0)
        else:
            prompt_s, mask_s = prompt, prompt_mask

        gstate0 = grammar_lib.update_state(self.spec, gstate0, prompt, prompt_mask)

        if static is not None:
            kv = static.kv
        else:
            kv = (self.model.init_cache(S, kv_buf) if tp_size == 1 else
                  self.model.init_cache(S, kv_buf, model_size=tp_size))
        valid = torch.ones((S, kv_buf), dtype=torch.bool, device=dev)
        valid[:, :P] = mask_s
        n_pad = (~mask_s).sum(1).to(torch.int32)
        positions = torch.clamp_min(torch.cumsum(mask_s.to(torch.int32), dim=1) - 1, 0)
        fwd_kw = {}
        if embeds is not None:
            fwd_kw["inputs_embeds"] = (torch.cat(embeds, dim=0) if self._S_factor == 2
                                       else embeds[0])
        logits, kv = self.model.forward(
            params, prompt_s, positions.to(torch.int32), kv,
            torch.zeros((S,), dtype=torch.int32, device=dev), valid, logits_tail=1, **fwd_kw)
        prompt_len = prompt_mask.to(torch.int32).sum(1)
        probs0 = processors_lib.process_window_logits(
            logits, self.spec, gstate0, self.sampling,
            force_no_cfg=self._force_no_cfg(gstate0),
            pred_pos=prompt_len[:, None], begin_pos=prompt_len)  # [B, 1, V]
        if self.sampling.greedy:
            y0 = torch.argmax(probs0[:, 0, :], dim=-1).to(torch.int32)
            probs0 = sampling_lib.onehot_probs(y0, V)[:, None, :]
        else:
            g = sampling_lib.slot_gumbel(gens, (V,), dev)
            y0 = sampling_lib.sample_from_probs(g, probs0[:, 0, :])

        tokens = torch.zeros((B, L_buf), dtype=torch.int32, device=dev)
        tokens[:, :P] = prompt
        tokens[:, P] = y0
        gstate = grammar_lib.update_state(
            self.spec, gstate0, y0[:, None],
            torch.ones((B,), dtype=torch.int32, device=dev))
        fresh = EngineState(
            gens=list(gens),
            tokens=tokens,
            length=torch.full((B,), P + 1, dtype=torch.int32, device=dev),
            n_pad=n_pad,
            kv=kv,
            valid=valid,
            carried_tokens=torch.zeros((B, W), dtype=torch.int32, device=dev),
            carried_probs=torch.zeros((B, W, V), dtype=torch.float32, device=dev),
            carried_count=torch.zeros((B,), dtype=torch.int32, device=dev),
            last_prob=probs0[:, 0, :].contiguous(),
            gstate=gstate,
            finished=y0 == cfg.eos_id,
            nfe=1,
            steps_multi=torch.zeros((), dtype=torch.int32, device=dev),
            prompt_len=prompt_len,
            prompt_rows=P,
            accept_hist=torch.zeros((W + 1,), dtype=torch.int32, device=dev),
            flags=torch.zeros((3,), dtype=torch.int32, device=dev),
        )
        if kv_buf_rows is not None:
            return fresh
        if static is None:
            self._state, self._state_model_size = fresh, tp_size
            return fresh
        # the engine's state: same tensors, new contents
        for f in dataclasses.fields(EngineState):
            old, new = getattr(static, f.name), getattr(fresh, f.name)
            if isinstance(old, Tensor):
                old.copy_(new)
            elif f.name == "gstate":
                for o, n in zip(old, new):
                    o.copy_(n)
            elif f.name != "kv":  # the forward wrote the cache in place
                setattr(static, f.name, new)
        return static

    def _draws(self, st: EngineState) -> StepDraws:
        """One step's random inputs, drawn slot by slot in a fixed order.
        The one seam for randomness in the decode loop: a test replays
        another generator's draws by overriding it."""
        W, V, dev = self.config.window, self.model.vocab_size, self.device
        greedy = self.sampling.greedy
        speculative = self.config.scheme == "speculative_jacobi"
        lo, hi = drafts_lib.draft_range(self.spec, V)
        return StepDraws(
            rand=sampling_lib.slot_randint(st.gens, lo, hi + 1, (W - 1,), dev),
            gumbel_tok=None if greedy else sampling_lib.slot_gumbel(st.gens, (W, V), dev),
            u=sampling_lib.slot_uniform(st.gens, (W - 1,), dev) if speculative else None,
            gumbel_res=(sampling_lib.slot_gumbel(st.gens, (V,), dev)
                        if speculative and not greedy else None),
        )

    def _draw_buffers(self, batch: int) -> StepDraws:
        """A captured graph's inputs: tensors of the shapes _draws returns."""
        W, V, dev = self.config.window, self.model.vocab_size, self.device
        greedy = self.sampling.greedy
        speculative = self.config.scheme == "speculative_jacobi"
        f32 = dict(dtype=torch.float32, device=dev)
        return StepDraws(
            rand=torch.zeros((batch, W - 1), dtype=torch.int32, device=dev),
            gumbel_tok=None if greedy else torch.zeros((batch, W, V), **f32),
            u=torch.zeros((batch, W - 1), **f32) if speculative else None,
            gumbel_res=torch.zeros((batch, V), **f32) if speculative and not greedy else None,
        )

    def _run(self, params, st: EngineState, cap: int) -> None:
        """Decode steps while a slot is live and the NFE is under ``cap``
        (the JAX while_loop's condition, checked on the host); on the AR
        fast path the same read also picks each step's width, and it counts
        the slot-steps of finished slots."""
        self._check_own(st)
        graph = self.cuda_graph and st.tokens.is_cuda
        W = self.config.window
        B = st.tokens.shape[0]
        fast = self.ar_fast_path and W > 1
        traced = tracing.ON  # read once a call: it changes between calls
        self._write_flags(st)  # a prefill or a refill changed the slots
        while st.nfe < cap:
            t = tracing.now() if traced else None
            done, multi, n_finished = st.flags.tolist()
            if t is not None:
                t = tracing.lap("engine.step.wait", t)
            if done:
                break
            st.slot_steps += B
            st.finished_slot_steps += n_finished
            w = 1 if fast and not multi else W
            if graph:
                self._graph_step(params, st, w, t)
            else:
                self._step(params, st, w)
                if t is not None:
                    tracing.lap("engine.step.eager", t)
                self.stats.eager_steps += 1
                _add(self.stats.eager_by_width, {w: 1})

    def _check_own(self, st: EngineState) -> None:
        if st is not self._state:
            raise ValueError("this state is no longer the engine's own: a later generate() "
                             "replaced it (keep only the returned state)")

    def _step(self, params, st: EngineState, w: int) -> None:
        """One eager decode step of width ``w``."""
        self._step_into(params, st, self._draws(st), w)
        st.nfe += 1

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return self._stream

    def _graph_step(self, params, st: EngineState, w: int, t: Optional[int] = None) -> None:
        """One decode step of width ``w`` on CUDA: the first step of each
        width on a new state eagerly (the warm-up), else a replay of that
        width's graph (captured first if needed). ``t``: where tracing is
        on, the step's phases are recorded from this ``tracing.now()`` on."""
        entry = self._graphs.get(w)
        if entry is None or entry.params is not params:
            if w not in self._warm:
                side, main = self._side_stream(), torch.cuda.current_stream()
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    self._step(params, st, w)
                main.wait_stream(side)
                if t is not None:
                    tracing.lap("engine.step.eager", t)
                self._warm.add(w)
                compile_watch.add(warmup_steps=1)
                self.stats.eager_steps += 1
                _add(self.stats.eager_by_width, {w: 1})
                return
            entry = self._capture(params, st, w)
            if t is not None:
                t = tracing.lap("engine.capture", t)
        draws = self._draws(st)
        if t is not None:
            t = tracing.lap("engine.step.draws", t)
        for buf, new in zip(entry.draws, draws):
            if buf is not None:
                buf.copy_(new)
        if t is not None:
            t = tracing.lap("engine.step.copy", t)
        entry.graph.replay()
        if t is not None:
            tracing.lap("engine.step.replay", t)
        st.nfe += 1
        self.stats.replays += 1
        _add(self.stats.replays_by_width, {w: 1})
        _add(self.stats.replayed_launches, entry.launches)

    def _capture(self, params, st: EngineState, w: int) -> _Graph:
        """Capture one decode step of width ``w`` over ``st``'s tensors as a
        CUDA graph, in the memory pool the engine's graphs share. The
        capture records and does not run: ``st`` is not advanced."""
        from ..ops import launch_counts

        # a new params object: release the graphs captured with the old one
        self._graphs = {k: g for k, g in self._graphs.items() if g.params is params}
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        draws = self._draw_buffers(st.tokens.shape[0])
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._side_stream()):
            self._step_into(params, st, draws, w)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        compile_watch.add(captures=1, capture_s=capture_s)
        self.stats.capture_s += capture_s
        launches = {k: n - before.get(k, 0) for k, n in launch_counts().items()}
        self.stats.captures += 1
        _add(self.stats.captures_by_width, {w: 1})
        _add(self.stats.captured_launches, launches)
        entry = _Graph(graph, params, draws, launches)
        self._graphs[w] = entry
        return entry

    def _in_interval(self, st: EngineState) -> Tensor:
        """[B] bool: the slot's next position is inside [interval_l,
        interval_r) of its generated tokens."""
        cfg = self.config
        real_len = st.length - st.n_pad[:st.tokens.shape[0]]
        return ((real_len >= st.prompt_len + cfg.interval_l)
                & (real_len < st.prompt_len + cfg.interval_r))

    def _write_flags(self, st: EngineState) -> None:
        """``st.flags`` from the state as it is: every slot finished, a live
        slot inside the interval (the next step's width), and the finished
        slots."""
        n_finished = st.finished.sum(dtype=torch.int32)
        any_multi = torch.any(self._in_interval(st) & ~st.finished)
        st.flags.copy_(torch.stack([n_finished == st.finished.shape[0], any_multi, n_finished]))

    def _step_into(self, params, st: EngineState, draws: StepDraws,
                   w: Optional[int] = None) -> None:
        """One decode step over a ``w``-wide window (the configured window by
        default, 1 on the AR fast path), written in place into ``st``'s tensors,
        which keep their full-window shapes (``st.nfe`` is the caller's).
        Nothing here reads a device value on the host, so the step can be
        captured."""
        cfg = self.config
        spec = self.spec
        dev = self.device
        W = cfg.window
        w = W if w is None else w
        V = self.model.vocab_size
        greedy = self.sampling.greedy
        speculative = cfg.scheme == "speculative_jacobi"
        rand, g_tok, u, g_res = draws
        rand = rand[:, :w - 1]
        g_tok = None if g_tok is None else g_tok[:, :w]
        u = None if u is None else u[:, :w - 1]
        B = st.tokens.shape[0]

        real_len = st.length - st.n_pad[:B]
        hi_i = st.prompt_len + cfg.interval_r
        in_interval = self._in_interval(st)
        active_w = torch.where(in_interval, torch.clamp_max(hi_i - real_len, w), 1)
        active_w = active_w.clamp(1, w).to(torch.int32)

        win = drafts_lib.build_window(
            rand, scheme=cfg.init, spec=spec, gstate=st.gstate, tokens=st.tokens,
            length=st.length, last_prob=st.last_prob,
            carried_tokens=st.carried_tokens, carried_probs=st.carried_probs,
            carried_count=st.carried_count, window=w, vocab_size=V,
            grammar_seed=cfg.grammar_seed)

        i = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
        positions = (self._tile(st.length)[:, None] - 1 - st.n_pad[:, None]) + i
        logits, _ = self.model.forward(
            params, self._tile(win.x), positions.to(torch.int32), st.kv,
            self._tile(st.length - 1).to(torch.int32), st.valid, logits_tail=None)

        probs = processors_lib.process_window_logits(
            logits, spec, st.gstate, self.sampling,
            force_no_cfg=self._force_no_cfg(st.gstate),
            pred_pos=real_len[:, None] + i, begin_pos=st.prompt_len)
        if greedy:
            y = torch.argmax(probs, dim=-1).to(torch.int32)
            probs = sampling_lib.onehot_probs(y, V)
        else:
            y = sampling_lib.sample_from_probs(g_tok, probs)

        def resample_fn(residual_logits, reject_row):
            p = processors_lib.process_residual_logits(
                residual_logits, spec, st.gstate, self.sampling, reject_row,
                pred_pos=real_len + reject_row, begin_pos=st.prompt_len)
            if greedy:
                return torch.argmax(p, dim=-1).to(torch.int32)
            return sampling_lib.sample_from_probs(g_res, p)

        if speculative:
            res = acceptance_lib.speculative_accept(
                u, win.x, y, win.p_draft, probs, active_w, resample_fn)
        else:
            res = acceptance_lib.jacobi_accept(win.x, y, probs, active_w)

        n_eff = torch.where(st.finished, 0, res.n).to(torch.int32)
        live = (~st.finished).to(torch.int32)
        hist_inc = (sampling_lib.onehot_probs(n_eff, W + 1).to(torch.int32)
                    * live[:, None]).sum(0)

        # commit: the whole window at each sample's length (slots past n are
        # overwritten by later commits); the finish guard below keeps every
        # write inside the buffer
        cols = st.length.long()[:, None] + torch.arange(w, device=dev)[None, :]
        length = st.length + n_eff
        gstate = grammar_lib.update_state(spec, st.gstate, res.out_tokens, n_eff)
        last_prob = acceptance_lib._gather_rows(res.out_probs, res.n - 1)
        carried_count = torch.where(st.finished, 0, res.carried_count).to(torch.int32)

        committed_live = i < n_eff[:, None]
        hit_eos = torch.any(committed_live & (res.out_tokens == cfg.eos_id), dim=1)
        gen_len = real_len - st.prompt_len
        out_of_room = (gen_len + n_eff >= cfg.max_len) | (length > st.tokens.shape[1] - 2 * W)
        finished = st.finished | hit_eos | out_of_room
        multi = torch.any(active_w > 1).to(torch.int32)

        # every input is read: write the step's results into the state
        st.tokens.scatter_(1, cols, res.out_tokens)
        st.length.copy_(length)
        # a narrow step's carry fills the first w columns, zeros the rest
        st.carried_tokens[:, :w].copy_(res.carried_tokens)
        st.carried_probs[:, :w].copy_(res.carried_probs)
        if w < W:
            st.carried_tokens[:, w:].zero_()
            st.carried_probs[:, w:].zero_()
        st.carried_count.copy_(carried_count)
        st.last_prob.copy_(last_prob)
        for dst, src in zip(st.gstate, gstate):
            dst.copy_(src)
        st.finished.copy_(finished)
        st.steps_multi.add_(multi)
        st.accept_hist.add_(hist_inc)
        self._write_flags(st)
