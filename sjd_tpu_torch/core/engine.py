"""The SJD engine (sjd_tpu/core/engine.py) as a host-driven PyTorch loop.

Static shapes throughout, as in the JAX engine, so that a later change can
capture a step as a CUDA graph: a [B, L_buf] token buffer, the
[S, NL, L_buf, Hkv, D] KV buffer written in place, a [B, W] draft window.
KV "rollback" is free: acceptance only advances each sample's ``length``,
and the next window overwrites rejected rows. CFG runs as a doubled batch
([cond; uncond]) through one forward, with the uncond prompt either masked
down to its last token (``mask_prompt``, Lumina) or a separate negative
prompt (``neg_prompt``).

Randomness: one ``torch.Generator`` per slot. Each step draws, per slot and
in a fixed order, the fresh draft seeds, the Gumbel noise for the window's
samples, the acceptance uniforms and the Gumbel noise for the residual
resample, so a slot's trajectory depends on its own generator alone.

``resume``, ``refill`` and the 1-token AR fast path are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from . import acceptance as acceptance_lib
from . import drafts as drafts_lib
from . import grammar as grammar_lib
from . import processors as processors_lib
from . import sampling as sampling_lib

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
            valid [S, L_buf], logits_tail) -> (logits [S, tail, V] f32, kv)
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


def slot_generators(seed: int, batch: int, device) -> List[torch.Generator]:
    """``batch`` independent per-slot generators spawned from one seed."""
    gens = []
    for child in np.random.SeedSequence(seed).spawn(batch):
        g = torch.Generator(device=device)
        g.manual_seed(int(child.generate_state(1, np.uint64)[0] >> np.uint64(1)))
        gens.append(g)
    return gens


class SJDEngine:
    def __init__(self, model: ModelFns, config: EngineConfig,
                 grammar_spec: grammar_lib.GrammarSpec,
                 sampling_params: processors_lib.SamplingParams):
        if config.scheme not in ("speculative_jacobi", "jacobi"):
            raise ValueError(f"unknown scheme {config.scheme!r}")
        self.model = model
        self.config = config
        self.spec = grammar_spec
        do_cfg = (sampling_params.do_cfg and config.cfg_mode != "none"
                  and sampling_params.guidance_scale != 1.0)
        self.sampling = dataclasses.replace(sampling_params, do_cfg=do_cfg)

    @property
    def device(self) -> torch.device:
        return self.model.device

    # -- public API -----------------------------------------------------------

    def generate(
        self,
        params,
        rng: Union[int, Sequence[torch.Generator]],
        prompt: Tensor,  # [B, P] int (left-padded)
        prompt_mask: Optional[Tensor] = None,  # [B, P] bool
        neg_prompt: Optional[Tensor] = None,  # [B, Pn] for cfg_mode=neg_prompt
        neg_mask: Optional[Tensor] = None,
        gstate: Optional[grammar_lib.GrammarState] = None,
        max_steps: Optional[int] = None,
    ) -> GenerateResult:
        """``rng`` is a seed (spawned into per-slot generators) or a list of
        B generators on the engine's device, one per slot."""
        dev = self.device
        prompt = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
        B = prompt.shape[0]
        if prompt_mask is None:
            prompt_mask = torch.ones(prompt.shape, dtype=torch.bool, device=dev)
        prompt_mask = torch.as_tensor(prompt_mask, dtype=torch.bool, device=dev)
        if gstate is None:
            gstate = grammar_lib.init_state(B, device=dev)
        if self.sampling.do_cfg and self.config.cfg_mode == "neg_prompt":
            if neg_prompt is None:
                raise ValueError("cfg_mode=neg_prompt requires neg_prompt")
            neg_prompt = torch.as_tensor(neg_prompt, dtype=torch.int32, device=dev)
            neg_mask = (torch.ones(neg_prompt.shape, dtype=torch.bool, device=dev)
                        if neg_mask is None else
                        torch.as_tensor(neg_mask, dtype=torch.bool, device=dev))
        if isinstance(rng, (int, np.integer)):
            gens = slot_generators(int(rng), B, dev)
        else:
            gens = list(rng)
            if len(gens) != B:
                raise ValueError(f"need {B} per-slot generators, got {len(gens)}")
        cap = self.config.resolved_nfe_cap() if max_steps is None else max_steps
        with torch.no_grad():
            state = self._prefill_state(params, gens, prompt, prompt_mask,
                                        neg_prompt, neg_mask, gstate)
            while state.nfe < cap and not bool(state.finished.all()):
                state = self._step(params, state)
        return GenerateResult(
            tokens=state.tokens, length=state.length, nfe=state.nfe,
            steps_multi=state.steps_multi,
            gen_count=state.length - state.prompt_rows,
            accept_hist=state.accept_hist)

    # -- implementation --------------------------------------------------------

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

    def _prefill_state(self, params, gens, prompt, prompt_mask, neg_prompt,
                       neg_mask, gstate0) -> EngineState:
        cfg = self.config
        dev = self.device
        B, P = prompt.shape
        W = cfg.window
        V = self.model.vocab_size
        neg_cfg = cfg.cfg_mode == "neg_prompt" and self.sampling.do_cfg
        P_rows = max(P, neg_prompt.shape[1]) if neg_cfg else P
        L_buf = cfg.resolved_buf_len(P_rows)
        kv_buf = L_buf + W + 1
        align = 512 if kv_buf > 512 else 8
        kv_buf = ((kv_buf + align - 1) // align) * align
        S = B * self._S_factor

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

        kv = self.model.init_cache(S, kv_buf)
        valid = torch.ones((S, kv_buf), dtype=torch.bool, device=dev)
        valid[:, :P] = mask_s
        n_pad = (~mask_s).sum(1).to(torch.int32)
        positions = torch.clamp_min(torch.cumsum(mask_s.to(torch.int32), dim=1) - 1, 0)
        logits, kv = self.model.forward(
            params, prompt_s, positions.to(torch.int32), kv,
            torch.zeros((S,), dtype=torch.int32, device=dev), valid, logits_tail=1)
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
        return EngineState(
            gens=gens,
            tokens=tokens,
            length=torch.full((B,), P + 1, dtype=torch.int32, device=dev),
            n_pad=n_pad,
            kv=kv,
            valid=valid,
            carried_tokens=torch.zeros((B, W), dtype=torch.int32, device=dev),
            carried_probs=torch.zeros((B, W, V), dtype=torch.float32, device=dev),
            carried_count=torch.zeros((B,), dtype=torch.int32, device=dev),
            last_prob=probs0[:, 0, :],
            gstate=gstate,
            finished=y0 == cfg.eos_id,
            nfe=1,
            steps_multi=torch.zeros((), dtype=torch.int32, device=dev),
            prompt_len=prompt_len,
            prompt_rows=P,
            accept_hist=torch.zeros((W + 1,), dtype=torch.int32, device=dev),
        )

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

    def _step(self, params, st: EngineState) -> EngineState:
        """One decode step over the configured window."""
        cfg = self.config
        spec = self.spec
        dev = self.device
        B = st.tokens.shape[0]
        W = cfg.window
        V = self.model.vocab_size
        greedy = self.sampling.greedy
        speculative = cfg.scheme == "speculative_jacobi"
        rand, g_tok, u, g_res = self._draws(st)

        real_len = st.length - st.n_pad[:B]
        lo_i = st.prompt_len + cfg.interval_l
        hi_i = st.prompt_len + cfg.interval_r
        in_interval = (real_len >= lo_i) & (real_len < hi_i)
        active_w = torch.where(in_interval, torch.clamp_max(hi_i - real_len, W), 1)
        active_w = active_w.clamp(1, W).to(torch.int32)

        win = drafts_lib.build_window(
            rand, scheme=cfg.init, spec=spec, gstate=st.gstate, tokens=st.tokens,
            length=st.length, last_prob=st.last_prob,
            carried_tokens=st.carried_tokens, carried_probs=st.carried_probs,
            carried_count=st.carried_count, window=W, vocab_size=V,
            grammar_seed=cfg.grammar_seed)

        i = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
        positions = (self._tile(st.length)[:, None] - 1 - st.n_pad[:, None]) + i
        logits, kv = self.model.forward(
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
        hist_inc = (F.one_hot(n_eff.long(), W + 1).to(torch.int32) * live[:, None]).sum(0)

        # commit: write the whole window at each sample's length (slots past
        # n are overwritten by later commits); the finish guard below keeps
        # every write inside the buffer
        cols = st.length.long()[:, None] + torch.arange(W, device=dev)[None, :]
        tokens = st.tokens.scatter(1, cols, res.out_tokens)
        length = st.length + n_eff
        gstate = grammar_lib.update_state(spec, st.gstate, res.out_tokens, n_eff)
        last_prob = acceptance_lib._gather_rows(res.out_probs, res.n - 1)
        carried_count = torch.where(st.finished, 0, res.carried_count).to(torch.int32)

        committed_live = i < n_eff[:, None]
        hit_eos = torch.any(committed_live & (res.out_tokens == cfg.eos_id), dim=1)
        L_buf = st.tokens.shape[1]
        gen_len = real_len - st.prompt_len
        out_of_room = (gen_len + n_eff >= cfg.max_len) | (length > L_buf - 2 * W)
        return dataclasses.replace(
            st,
            tokens=tokens,
            length=length,
            kv=kv,
            carried_tokens=res.carried_tokens,
            carried_probs=res.carried_probs,
            carried_count=carried_count,
            last_prob=last_prob,
            gstate=gstate,
            finished=st.finished | hit_eos | out_of_room,
            nfe=st.nfe + 1,
            steps_multi=st.steps_multi + torch.any(active_w > 1).to(torch.int32),
            accept_hist=st.accept_hist + hist_inc,
        )
