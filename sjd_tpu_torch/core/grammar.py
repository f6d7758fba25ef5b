"""Image-grammar logits constraints as pure functions of position
(sjd_tpu/core/grammar.py): the ``lumina``, ``emu3``, ``anole`` and ``none``
kinds.

The grammar is a function of (token offset within the image span, latent
grid h, latent grid w), so a window's [B, W, V] scores are constrained by a
few broadcast comparisons. A small per-sample ``GrammarState`` is updated
from committed tokens only. Everything here is tensor-only, with no host
read and no Python branch on a device value, so that the decode step that
calls it can be captured as a CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

Tensor = torch.Tensor
NEG_INF = float(torch.finfo(torch.float32).min)
_KINDS = ("lumina", "emu3", "anole", "none")
_ANOLE_MODES = ("image-only", "text-only", "interleaved", "unrestricted")


@dataclasses.dataclass(frozen=True)
class GrammarSpec:
    """Static grammar description (sjd_tpu's GrammarSpec).

    "lumina": <image_start> <h_tok> <w_tok> (w tokens <eol>) x h <image_end>,
    h_lat = (h_tok - size_token_base) * grid_scale, likewise w.
    "emu3": the grid is known from the prompt; offsets count from the
    <|image token|> marker (``img_token_id``): rows of w tokens and <eol>,
    then <eof> <image_end> <eos>, then <pad>, each at its exact offset.
    "anole": a fixed ``image_seq_length``-token image after <boi>, then
    <eoi>, constrained per ``mode``.
    "none": no grammar."""

    kind: str = "none"
    image_start_id: int = -1
    image_end_id: int = -1
    newline_id: int = -1
    image_vocab_start: int = 0
    image_vocab_end: int = -1  # inclusive
    # lumina
    size_token_base: int = 8804
    grid_scale: int = 2
    header_len: int = 3
    # emu3
    eof_id: int = -1
    eos_id: int = -1
    pad_id: int = -1
    img_token_id: int = -1  # the marker that arms in_image; -1: no arming
    # anole
    image_seq_length: int = 1024
    mode: str = "image-only"  # | "text-only" | "interleaved" | "unrestricted"
    # no <boi> at generated offsets >= this (no room left for an image); -1: off
    boi_suppress_from: int = -1
    suppress_eos_at_begin: bool = False  # eos may not be the first generated token

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown grammar kind {self.kind!r}")
        if self.kind == "anole" and self.mode not in _ANOLE_MODES:
            raise ValueError(f"unknown anole mode {self.mode!r}")


class GrammarState(NamedTuple):
    in_image: Tensor  # [B] bool
    size_known: Tensor  # [B] bool
    h_lat: Tensor  # [B] int32
    w_lat: Tensor  # [B] int32
    img_count: Tensor  # [B] int32: committed tokens after the header
    header_seen: Tensor  # [B] int32: size tokens committed so far


def init_state(batch: int, *, device=None, h_lat: Optional[Tensor] = None,
               w_lat: Optional[Tensor] = None, in_image: bool = False) -> GrammarState:
    """A fresh state; Emu3 passes its grid dims up front."""
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
        if spec.kind == "emu3":
            # positional for the whole generation: the count runs through
            # <image_end> and never resets. Only tokens after the marker
            # count (st.in_image is the value before this token), so the
            # prompt and the marker itself add nothing.
            img_count = torch.where(live & st.in_image, st.img_count + 1, st.img_count)
            in_image = torch.where(live & (tok == spec.img_token_id), True, st.in_image)
            st = st._replace(in_image=in_image, img_count=img_count.to(torch.int32))
            continue
        is_start = live & (tok == spec.image_start_id)
        is_end = live & (tok == spec.image_end_id)
        in_image = torch.where(is_start, True, st.in_image)
        h_lat, w_lat = st.h_lat, st.w_lat
        header_seen, size_known = st.header_seen, st.size_known
        if spec.kind == "lumina":
            # the two grid-size tokens after <image_start>
            collecting = live & st.in_image & (st.header_seen < 2) & ~is_end
            grid = ((tok - spec.size_token_base) * spec.grid_scale).to(torch.int32)
            h_lat = torch.where(collecting & (st.header_seen == 0), grid, st.h_lat)
            w_lat = torch.where(collecting & (st.header_seen == 1), grid, st.w_lat)
            header_seen = torch.where(collecting, st.header_seen + 1, st.header_seen)
            size_known = header_seen >= 2
            body = live & st.in_image & st.size_known & ~is_end
        else:  # anole: no header
            body = live & st.in_image & ~is_end
        img_count = torch.where(body, st.img_count + 1, st.img_count)
        # closing the image resets the per-image counters
        in_image = torch.where(is_end, False, in_image)
        img_count = torch.where(is_end, 0, img_count)
        if spec.kind == "lumina":
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


def _emu3_forces(spec: GrammarSpec, state: GrammarState, o: Tensor):
    """Emu3's forced rows at image offsets o [B, K] (1-based p = o + 1 from
    the marker): <eol> where p % (w+1) == 0, even past the grid (the
    reference checks it first); <eof>, <image_end>, <eos> at the grid end
    + 1, 2, 3; <pad> beyond. In apply_grammar's order."""
    active = (state.in_image & state.size_known)[:, None]
    w1 = torch.clamp_min(state.w_lat[:, None] + 1, 1)
    end = (state.w_lat[:, None] + 1) * state.h_lat[:, None]
    p = o + 1
    eol = active & (torch.remainder(p, w1) == 0)
    return active, (
        (eol, spec.newline_id),
        (active & (p == end + 1), spec.eof_id),
        (active & (p == end + 2), spec.image_end_id),
        (active & (p == end + 3), spec.eos_id),
        (active & (p > end + 3) & ~eol, spec.pad_id),
    )


def apply_grammar(spec: GrammarSpec, state: GrammarState, scores: Tensor, *,
                  pred_pos: Optional[Tensor] = None,
                  begin_pos: Optional[Tensor] = None) -> Tensor:
    """Constrain window scores [B, W, V]: row i predicts image offset
    o_i = img_count + i. ``pred_pos`` [B, W] (the real position each row
    predicts) and ``begin_pos`` [B] (the first generated position) feed the
    anole kind's position-range constraints; None skips them."""
    if spec.kind == "none":
        return scores
    B, W, V = scores.shape
    dev = scores.device
    vocab = torch.arange(V, device=dev)
    is_image_tok = (vocab >= spec.image_vocab_start) & (vocab <= spec.image_vocab_end)
    i = torch.arange(W, device=dev, dtype=torch.int32)[None, :]
    o = state.img_count[:, None] + i
    suppressed = torch.where(is_image_tok[None, None, :], scores, NEG_INF)

    if spec.kind == "lumina":
        w1 = state.w_lat[:, None] + 1
        active = (state.in_image & state.size_known)[:, None]
        scores = torch.where(active[:, :, None], suppressed, scores)
        force_eol = active & (torch.remainder(o + 1, torch.clamp_min(w1, 1)) == 0)
        force_eoi = active & (o == w1 * state.h_lat[:, None])
        scores = _force_rows(scores, force_eol & ~force_eoi, spec.newline_id)
        return _force_rows(scores, force_eoi, spec.image_end_id)

    if spec.kind == "emu3":
        active, forces = _emu3_forces(spec, state, o)
        any_forced = torch.zeros_like(active)
        for force, _ in forces:
            any_forced = any_forced | force
        scores = torch.where((active & ~any_forced)[:, :, None], suppressed, scores)
        for force, tok in forces:
            scores = _force_rows(scores, force, tok)
        return scores

    # anole: the multimodal_generation_mode stacks, both Allow* processors
    # exclusive (image tokens only inside the image window, <eoi> only at
    # its end); rows follow the state at the window's start
    if spec.mode == "unrestricted":
        return scores
    is_boi = vocab == spec.image_start_id
    is_eoi = vocab == spec.image_end_id
    if spec.mode == "text-only":
        banned = is_image_tok | is_boi | is_eoi
        return torch.where(banned[None, None, :], NEG_INF, scores)
    active = state.in_image[:, None]
    L = spec.image_seq_length
    in_win = active & (o < L)
    at_eoi = active & (o == L)
    outside = ~(in_win | at_eoi)
    scores = torch.where(in_win[:, :, None], suppressed, scores)
    # the closing row keeps <eoi>'s own score and masks the rest
    scores = torch.where(at_eoi[:, :, None] & ~is_eoi[None, None, :], NEG_INF, scores)
    scores = torch.where(outside[:, :, None] & (is_image_tok | is_eoi)[None, None, :],
                         NEG_INF, scores)
    # no <boi> without room for a whole image: a generated-token offset
    if spec.boi_suppress_from >= 0 and pred_pos is not None and begin_pos is not None:
        no_room = (pred_pos - begin_pos[:, None]) >= spec.boi_suppress_from
        scores = torch.where(no_room[:, :, None] & is_boi[None, None, :], NEG_INF, scores)
    if spec.mode == "image-only":
        allowed = is_image_tok | is_boi | is_eoi | (vocab == spec.eos_id)
        scores = torch.where(allowed[None, None, :], scores, NEG_INF)
        if spec.suppress_eos_at_begin and pred_pos is not None and begin_pos is not None:
            at_begin = pred_pos == begin_pos[:, None]
            scores = torch.where(at_begin[:, :, None] & (vocab == spec.eos_id)[None, None, :],
                                 NEG_INF, scores)
    return scores


def forced_token_at(spec: GrammarSpec, state: GrammarState,
                    o: Tensor) -> Tuple[Tensor, Tensor]:
    """(forced [B, K] bool, token [B, K] int32) at image offsets o [B, K]:
    exactly the one-hot rows apply_grammar produces (where several forces
    meet, the last one apply_grammar applies wins)."""
    B, K = o.shape
    none_id = torch.zeros((B, K), dtype=torch.int32, device=o.device)
    no = torch.zeros((B, K), dtype=torch.bool, device=o.device)
    if spec.kind == "none":
        return no, none_id
    if spec.kind == "anole":
        if spec.mode in ("text-only", "unrestricted"):
            return no, none_id
        forced = state.in_image[:, None] & (o == spec.image_seq_length)
        return forced, torch.where(forced, spec.image_end_id, 0).to(torch.int32)
    if spec.kind == "emu3":
        _, forces = _emu3_forces(spec, state, o)
        forced, tok = no, none_id
        for force, tid in forces:
            forced = forced | force
            tok = torch.where(force, tid, tok)
        return forced, tok.to(torch.int32)
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
