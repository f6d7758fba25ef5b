"""The sequential window decomposer (sjd_tpu/core/decomposer.py): the
reference's SequenceSegmentDecomposer, which its own main path leaves
commented out.

Given a window's [S, W, V] logits, the rows are walked left to right: row
i runs the processors (temperature -> grammar -> top-k -> top-p ->
softmax) with the grammar state advanced by the tokens sampled at rows
< i, then samples its token. So an ``<image_start>`` or a size token
sampled mid-window constrains the later rows of the same window, where
the engine's parallel pipeline conditions every row on the window-start
state. The JAX ``lax.scan`` over the rows is a Python loop over the
static W; the Gumbel noise of the rows is an input, drawn by the caller
from the per-slot generators as the engine's ``_draws`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import grammar as grammar_lib
from . import sampling as sampling_lib
from .processors import SamplingParams, cfg_mix
from .sampling import onehot_probs

Tensor = torch.Tensor


class DecomposeResult(NamedTuple):
    tokens: Tensor  # [B, W] int32: the sequentially sampled window tokens
    fixed_scores: Tensor  # [B, W, V] one-hot probabilities at them
    gstate: grammar_lib.GrammarState  # advanced over the whole window


def _process_row(scores: Tensor, spec: grammar_lib.GrammarSpec,
                 gstate: grammar_lib.GrammarState, params: SamplingParams,
                 pred_pos: Optional[Tensor], begin_pos: Optional[Tensor]) -> Tensor:
    """One row [B, V] through the sub-processor list; CFG is the caller's.
    As in the JAX function, top-p runs whenever it is set."""
    if params.temperature != 1.0:
        scores = scores / params.temperature
    scores = grammar_lib.apply_grammar(
        spec, gstate, scores[:, None, :],
        pred_pos=None if pred_pos is None else pred_pos[:, None], begin_pos=begin_pos)
    scores = sampling_lib.top_k_dual(scores, gstate.in_image, params.image_top_k,
                                     params.text_top_k)[:, 0, :]
    if params.top_p is not None:
        scores = sampling_lib.top_p(scores, params.top_p)
    return torch.softmax(scores.float(), dim=-1)


def sequential_decompose(
    gumbel: Optional[Tensor],  # [B, W, V] noise for the rows' samples (None: greedy)
    logits: Tensor,  # [S, W, V] raw window logits (S = 2B with CFG)
    spec: grammar_lib.GrammarSpec,
    gstate: grammar_lib.GrammarState,
    params: SamplingParams,
    *,
    greedy: bool = False,
    force_no_cfg: Optional[Tensor] = None,  # [B] bool
    pred_pos: Optional[Tensor] = None,  # [B, W]
    begin_pos: Optional[Tensor] = None,  # [B]
) -> DecomposeResult:
    """The CFG mix once (it does not depend on the row), then the rows in
    order with exact in-window grammar conditioning."""
    if params.do_cfg and params.guidance_scale != 1.0:
        B = logits.shape[0] // 2
        if force_no_cfg is None:
            force_no_cfg = torch.zeros((B,), dtype=torch.bool, device=logits.device)
        scores = cfg_mix(logits, params.guidance_scale, force_no_cfg)
    elif params.do_cfg:
        scores = logits[: logits.shape[0] // 2]
    else:
        scores = logits
    B, W, V = scores.shape
    ones = torch.ones((B,), dtype=torch.int32, device=scores.device)
    g = gstate
    toks = []
    for i in range(W):
        probs = _process_row(scores[:, i], spec, g, params,
                             None if pred_pos is None else pred_pos[:, i], begin_pos)
        if greedy:
            tok = torch.argmax(probs, dim=-1).to(torch.int32)
        else:
            tok = sampling_lib.sample_from_probs(gumbel[:, i], probs)
        # the sample joins the conditioning of the next rows
        g = grammar_lib.update_state(spec, g, tok[:, None], ones)
        toks.append(tok)
    tokens = torch.stack(toks, dim=1)
    return DecomposeResult(tokens=tokens, fixed_scores=onehot_probs(tokens, V), gstate=g)
