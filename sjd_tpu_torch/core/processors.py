"""The logits pipeline: CFG mix -> grammar -> top-k -> probabilities
(sjd_tpu/core/processors.py). ``decompose_window_sequential`` and the
top-p filter are not ported yet."""

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

    def __post_init__(self):
        if self.top_p is not None and self.top_p < 1.0:
            raise ValueError("top_p filtering is not ported yet")


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
    return torch.softmax(scores.float(), dim=-1)


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
    return torch.softmax(scores.float(), dim=-1)
