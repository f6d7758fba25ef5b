"""Image-grammar logits constraints as pure functions of position
(sjd_tpu/core/grammar.py), for the ``lumina`` and ``none`` kinds.

The grammar is a function of (token offset within the image span, latent
grid h, latent grid w), so a window's [B, W, V] scores are constrained by a
few broadcast comparisons. A small per-sample ``GrammarState`` is updated
from committed tokens only. The ``emu3`` and ``anole`` kinds are not ported
yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

Tensor = torch.Tensor
NEG_INF = float(torch.finfo(torch.float32).min)
_PORTED_KINDS = ("lumina", "none")


@dataclasses.dataclass(frozen=True)
class GrammarSpec:
    """Static grammar description (sjd_tpu's GrammarSpec; the fields the
    ported kinds read).

    "lumina": <image_start> <h_tok> <w_tok> (w tokens <eol>) x h <image_end>,
    h_lat = (h_tok - size_token_base) * grid_scale, likewise w.
    "none": no grammar."""

    kind: str = "none"
    image_start_id: int = -1
    image_end_id: int = -1
    newline_id: int = -1
    image_vocab_start: int = 0
    image_vocab_end: int = -1  # inclusive
    size_token_base: int = 8804
    grid_scale: int = 2
    header_len: int = 3

    def __post_init__(self):
        if self.kind not in _PORTED_KINDS:
            raise ValueError(f"grammar kind {self.kind!r} is not ported")


class GrammarState(NamedTuple):
    in_image: Tensor  # [B] bool
    size_known: Tensor  # [B] bool
    h_lat: Tensor  # [B] int32
    w_lat: Tensor  # [B] int32
    img_count: Tensor  # [B] int32: committed tokens after the header
    header_seen: Tensor  # [B] int32: size tokens committed so far


def init_state(batch: int, *, device=None, h_lat: Optional[Tensor] = None,
               w_lat: Optional[Tensor] = None, in_image: bool = False) -> GrammarState:
    known = h_lat is not None
    i32 = dict(dtype=torch.int32, device=device)
    return GrammarState(
        in_image=torch.full((batch,), in_image, dtype=torch.bool, device=device),
        size_known=torch.full((batch,), known, dtype=torch.bool, device=device),
        h_lat=h_lat if known else torch.zeros((batch,), **i32),
        w_lat=w_lat if known else torch.zeros((batch,), **i32),
        img_count=torch.zeros((batch,), **i32),
        header_seen=torch.full((batch,), 2 if known else 0, **i32),
    )


def update_state(spec: GrammarSpec, state: GrammarState, committed: Tensor,
                 n_committed: Tensor) -> GrammarState:
    """Advance the state over up to W committed tokens. ``n_committed`` is
    a [B] count of live slots or a [B, W] bool mask (left-padded prompts)."""
    if spec.kind == "none":
        return state
    W = committed.shape[1]
    mask_mode = n_committed.dim() == 2
    st = state
    for j in range(W):
        tok = committed[:, j]
        live = n_committed[:, j] if mask_mode else (j < n_committed)
        is_start = live & (tok == spec.image_start_id)
        is_end = live & (tok == spec.image_end_id)
        in_image = torch.where(is_start, True, st.in_image)
        collecting = live & st.in_image & (st.header_seen < 2) & ~is_end
        grid = ((tok - spec.size_token_base) * spec.grid_scale).to(torch.int32)
        h_lat = torch.where(collecting & (st.header_seen == 0), grid, st.h_lat)
        w_lat = torch.where(collecting & (st.header_seen == 1), grid, st.w_lat)
        header_seen = torch.where(collecting, st.header_seen + 1, st.header_seen)
        size_known = header_seen >= 2
        body = live & st.in_image & st.size_known & ~is_end
        img_count = torch.where(body, st.img_count + 1, st.img_count)
        # closing the image resets the per-image counters
        in_image = torch.where(is_end, False, in_image)
        img_count = torch.where(is_end, 0, img_count)
        header_seen = torch.where(is_end, 0, header_seen)
        size_known = torch.where(is_end, False, size_known)
        st = GrammarState(in_image, size_known, h_lat.to(torch.int32),
                          w_lat.to(torch.int32), img_count.to(torch.int32),
                          header_seen.to(torch.int32))
    return st


def _force_rows(scores: Tensor, force: Tensor, token_id) -> Tensor:
    """Rows where ``force`` holds become one-hot (0 at token_id, NEG_INF
    elsewhere). token_id: int or [B] tensor."""
    V = scores.shape[-1]
    vocab = torch.arange(V, device=scores.device)
    if isinstance(token_id, int):
        onehot = (vocab == token_id)[None, None, :]
    else:
        onehot = vocab[None, None, :] == token_id[:, None, None]
    forced = torch.where(onehot, 0.0, NEG_INF)
    return torch.where(force[:, :, None], forced, scores)


def apply_grammar(spec: GrammarSpec, state: GrammarState, scores: Tensor, *,
                  pred_pos: Optional[Tensor] = None,
                  begin_pos: Optional[Tensor] = None) -> Tensor:
    """Constrain window scores [B, W, V]: row i predicts image offset
    o_i = img_count + i. (pred_pos/begin_pos feed only the anole kind.)"""
    if spec.kind == "none":
        return scores
    B, W, V = scores.shape
    dev = scores.device
    vocab = torch.arange(V, device=dev)
    is_image_tok = (vocab >= spec.image_vocab_start) & (vocab <= spec.image_vocab_end)
    i = torch.arange(W, device=dev, dtype=torch.int32)[None, :]
    o = state.img_count[:, None] + i
    w1 = state.w_lat[:, None] + 1
    active = (state.in_image & state.size_known)[:, None]
    suppressed = torch.where(is_image_tok[None, None, :], scores, NEG_INF)
    scores = torch.where(active[:, :, None], suppressed, scores)
    force_eol = active & (torch.remainder(o + 1, torch.clamp_min(w1, 1)) == 0)
    force_eoi = active & (o == w1 * state.h_lat[:, None])
    scores = _force_rows(scores, force_eol & ~force_eoi, spec.newline_id)
    return _force_rows(scores, force_eoi, spec.image_end_id)


def forced_token_at(spec: GrammarSpec, state: GrammarState,
                    o: Tensor) -> Tuple[Tensor, Tensor]:
    """(forced [B, K] bool, token [B, K] int32) at image offsets o [B, K]:
    the one-hot rows apply_grammar produces (<eol>, <image_end>)."""
    B, K = o.shape
    none_id = torch.zeros((B, K), dtype=torch.int32, device=o.device)
    if spec.kind == "none":
        return torch.zeros((B, K), dtype=torch.bool, device=o.device), none_id
    w1 = torch.clamp_min(state.w_lat[:, None] + 1, 1)
    active = (state.in_image & state.size_known)[:, None]
    end = w1 * state.h_lat[:, None]
    force_eoi = active & (o == end)
    force_eol = active & (torch.remainder(o + 1, w1) == 0) & ~force_eoi
    tok = torch.where(force_eoi, spec.image_end_id,
                      torch.where(force_eol, spec.newline_id, 0))
    return force_eoi | force_eol, tok.to(torch.int32)


def apply_grammar_single(spec: GrammarSpec, state: GrammarState, scores: Tensor,
                         offset_in_window: Tensor, *,
                         pred_pos: Optional[Tensor] = None,
                         begin_pos: Optional[Tensor] = None) -> Tensor:
    """Grammar for one residual-resample row [B, V] at window offset k."""
    if spec.kind == "none":
        return scores
    shifted = state._replace(img_count=state.img_count + offset_in_window)
    return apply_grammar(
        spec, shifted, scores[:, None, :],
        pred_pos=None if pred_pos is None else pred_pos[:, None],
        begin_pos=begin_pos,
    )[:, 0, :]
