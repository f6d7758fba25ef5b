"""The logits pipeline: CFG mix -> grammar -> top-k (-> top-p) ->
probabilities (sjd_tpu/core/processors.py), and the sequential window
decomposition ``decompose_window_sequential``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import grammar as grammar_lib
from . import sampling

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    guidance_scale: float = 3.0
    do_cfg: bool = True
    image_top_k: int = 2000
    text_top_k: int = 10
    top_p: Optional[float] = None
    temperature: float = 1.0
    greedy: bool = False
    # the JAX package's switch to jax.lax.approx_max_k for the top-k
    # threshold, a TPU workaround; the port's threshold is exact either way
    # (torch.topk), so the field only keeps the two configs alike
    approx_top_k: bool = False


def cfg_mix(logits: Tensor, guidance_scale: float, force_no_cfg: Tensor) -> Tensor:
    """g * (cond - uncond) + uncond over the [cond; uncond] halves, with the
    cond half as it is where force_no_cfg [B] holds."""
    B = logits.shape[0] // 2
    cond, uncond = logits[:B], logits[B:]
    mixed = guidance_scale * (cond - uncond) + uncond
    return torch.where(force_no_cfg[:, None, None], cond, mixed)


def process_window_logits(
    logits: Tensor,  # [S, W, V] f32 (S = 2B with CFG)
    spec: grammar_lib.GrammarSpec,
    gstate: grammar_lib.GrammarState,
    params: SamplingParams,
    *,
    force_no_cfg: Optional[Tensor] = None,
    pred_pos: Optional[Tensor] = None,
    begin_pos: Optional[Tensor] = None,
) -> Tensor:
    """Processed per-token probabilities [B, W, V] (f32, rows sum to 1)."""
    if params.do_cfg and params.guidance_scale != 1.0:
        B = logits.shape[0] // 2
        if force_no_cfg is None:
            force_no_cfg = torch.zeros((B,), dtype=torch.bool, device=logits.device)
        scores = cfg_mix(logits, params.guidance_scale, force_no_cfg)
    elif params.do_cfg:
        scores = logits[: logits.shape[0] // 2]
    else:
        scores = logits
    if params.temperature != 1.0:
        scores = scores / params.temperature
    scores = grammar_lib.apply_grammar(spec, gstate, scores, pred_pos=pred_pos,
                                       begin_pos=begin_pos)
    scores = sampling.top_k_dual(scores, gstate.in_image, params.image_top_k,
                                 params.text_top_k)
    if params.top_p is not None and params.top_p < 1.0:
        scores = sampling.top_p(scores, params.top_p)
    return torch.softmax(scores.float(), dim=-1)


def decompose_window_sequential(
    gumbel: Optional[Tensor],  # [B, W, V] noise for the rows' samples (None: greedy)
    scores: Tensor,  # [B, W, V] f32 window logits
    spec: grammar_lib.GrammarSpec,
    gstate: grammar_lib.GrammarState,
    params: SamplingParams,
    *,
    fix_logits: bool = True,
):
    """The sequential window decomposition (the reference's
    SequenceSegmentDecomposer): row i is processed with the grammar state
    advanced by the tokens SAMPLED at rows < i, then sampled (argmax when
    ``params.greedy``); with ``fix_logits`` its scores become 0 at the
    sampled token and NEG_INF elsewhere. A Python loop over the static W
    (the JAX ``lax.scan``); the noise is an input, as in the engine.
    Returns (scores [B, W, V], tokens [B, W])."""
    B, W, V = scores.shape
    vocab = torch.arange(V, device=scores.device)
    g = gstate
    outs, toks = [], []
    for i in range(W):
        s = scores[:, i]
        if params.temperature != 1.0:
            s = s / params.temperature
        s = grammar_lib.apply_grammar_single(
            spec, g, s, torch.zeros((B,), dtype=torch.int32, device=s.device))
        s = sampling.top_k_dual(s[:, None, :], g.in_image, params.image_top_k,
                                params.text_top_k)[:, 0, :]
        if params.top_p is not None and params.top_p < 1.0:
            s = sampling.top_p(s, params.top_p)
        if params.greedy:
            tok = torch.argmax(s, dim=-1).to(torch.int32)
        else:
            tok = sampling.sample_from_logits(gumbel[:, i], s)
        outs.append(torch.where(tok.long()[:, None] == vocab, 0.0, sampling.NEG_INF)
                    if fix_logits else s)
        toks.append(tok)
        g = grammar_lib.update_state(spec, g, tok[:, None],
                                     torch.ones((B,), dtype=torch.int32, device=s.device))
    return torch.stack(outs, dim=1), torch.stack(toks, dim=1)


def process_residual_logits(
    residual_logits: Tensor,  # [B, V]: log(max(0, p_new - p_draft))
    spec: grammar_lib.GrammarSpec,
    gstate: grammar_lib.GrammarState,
    params: SamplingParams,
    offset_in_window: Tensor,  # [B]
    *,
    pred_pos: Optional[Tensor] = None,
    begin_pos: Optional[Tensor] = None,
) -> Tensor:
    """Grammar + top-k again on the rejection residual, then softmax."""
    scores = grammar_lib.apply_grammar_single(
        spec, gstate, residual_logits, offset_in_window,
        pred_pos=pred_pos, begin_pos=begin_pos)
    scores = sampling.top_k_dual(scores[:, None, :], gstate.in_image,
                                 params.image_top_k, params.text_top_k)[:, 0, :]
    if params.top_p is not None and params.top_p < 1.0:
        scores = sampling.top_p(scores, params.top_p)
    return torch.softmax(scores.float(), dim=-1)
