"""Draft-window construction: carried Jacobi iterates + fresh seeds
(sjd_tpu/core/drafts.py).

Window layout (width W): slot 0 is the last committed token; slots 1..W-1
are drafts, first the carried unaccepted model samples of the previous
step, then fresh seeds. Fresh-seed schemes: ``random`` (uniform over the
image vocab, one-hot draft dist), ``repeat_horizon`` (a slot at grid
column >= 1 copies the token at the previous flattened grid index, clamped
to the last carried or committed one) and ``sample_horizon`` (the same
indexing, but the seed is the argmax of the recorded distribution there:
the reference's top-1-restricted multinomial).

The fresh random seeds ``rand`` are an input: the caller draws them per
slot, in ``draft_range(spec, V)``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import grammar as grammar_lib
from .sampling import onehot_probs

Tensor = torch.Tensor


class Window(NamedTuple):
    x: Tensor  # [B, W] int32 window inputs
    p_draft: Tensor  # [B, W, V] f32 draft distributions


def draft_range(spec: grammar_lib.GrammarSpec, vocab_size: int) -> Tuple[int, int]:
    """Inclusive [lo, hi] of fresh random seeds: the image vocab, or the
    whole vocab when none is declared."""
    lo, hi = spec.image_vocab_start, spec.image_vocab_end
    if hi < lo:
        lo, hi = 0, vocab_size - 1
    return lo, hi


def build_window(
    rand: Tensor,  # [B, W-1] int32 fresh seeds in draft_range
    *,
    scheme: str,
    spec: grammar_lib.GrammarSpec,
    gstate: grammar_lib.GrammarState,
    tokens: Tensor,  # [B, L_max]
    length: Tensor,  # [B]
    last_prob: Tensor,  # [B, V]
    carried_tokens: Tensor,  # [B, W]
    carried_probs: Tensor,  # [B, W, V]
    carried_count: Tensor,  # [B]
    window: int,
    vocab_size: int,
    grammar_seed: bool = True,
) -> Window:
    W, V = window, vocab_size
    last_tok = torch.gather(tokens, 1, (length.long() - 1)[:, None])  # [B, 1]
    if W == 1:
        return Window(x=last_tok.to(torch.int32), p_draft=last_prob[:, None, :])

    d = torch.arange(W - 1, device=tokens.device)[None, :]
    lo, hi = draft_range(spec, V)
    if scheme in ("repeat_horizon", "sample_horizon"):
        cc = carried_count.long()[:, None]
        src = torch.minimum(torch.clamp_min(d - 1, 0), torch.clamp_min(cc - 1, 0))
        have_carried = (cc > 0) & (d >= 1)
        if scheme == "repeat_horizon":
            seed_tok = torch.where(have_carried, torch.gather(carried_tokens, 1, src), last_tok)
        else:
            # the argmax of the recorded distribution, also in the fallback
            # to the last committed token: not the token sampled from it
            carried_seed = torch.argmax(carried_probs, dim=-1)  # [B, W]
            seed_tok = torch.where(have_carried, torch.gather(carried_seed, 1, src),
                                   torch.argmax(last_prob, dim=-1)[:, None])
        o = gstate.img_count[:, None] + d
        w1 = torch.clamp_min(gstate.w_lat[:, None] + 1, 1)
        col = torch.remainder(o + 1, w1)
        use_seed = ((gstate.in_image & gstate.size_known)[:, None] & (col >= 1)
                    & (seed_tok >= lo) & (seed_tok <= hi))
        rand = torch.where(use_seed, seed_tok.to(rand.dtype), rand)
    elif scheme != "random":
        raise ValueError(f"unknown draft init {scheme!r}")
    rand_probs = onehot_probs(rand, V)

    in_carry = d < carried_count[:, None]
    slot_tok = torch.where(in_carry, carried_tokens[:, : W - 1], rand)
    slot_probs = torch.where(in_carry[:, :, None], carried_probs[:, : W - 1, :], rand_probs)

    if grammar_seed and spec.kind != "none":
        o_all = gstate.img_count[:, None] + d
        forced_m, forced_id = grammar_lib.forced_token_at(spec, gstate, o_all)
        override = forced_m & ~in_carry
        slot_tok = torch.where(override, forced_id, slot_tok)
        slot_probs = torch.where(override[:, :, None], onehot_probs(forced_id, V),
                                 slot_probs)

    x = torch.cat([last_tok.to(torch.int32), slot_tok.to(torch.int32)], dim=1)
    p_draft = torch.cat([last_prob[:, None, :], slot_probs], dim=1)
    return Window(x=x, p_draft=p_draft)
