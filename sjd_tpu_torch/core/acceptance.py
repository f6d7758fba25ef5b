"""Vectorized speculative acceptance and the deterministic Jacobi matcher
(sjd_tpu/core/acceptance.py).

  accept_i = u_i < min(1, p_new(x_i) / p_draft(x_i))   for i = 1..W-1
  n        = 1 + sum(cumprod(accept))                  (first rejection)
  residual ~ processors(log max(0, p_new - p_draft)) at the rejection point

The uniforms ``u`` are an input, drawn by the caller from each slot's
generator; the residual resample is the caller's ``resample_fn``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

Tensor = torch.Tensor
NEG_INF = float(torch.finfo(torch.float32).min)


class AcceptResult(NamedTuple):
    n: Tensor  # [B] int32: tokens committed this step (>= 1)
    out_tokens: Tensor  # [B, W] int32: committed at slots [0, n)
    out_probs: Tensor  # [B, W, V] f32: their recorded dists
    carried_tokens: Tensor  # [B, W] int32: next window's draft seeds
    carried_probs: Tensor  # [B, W, V] f32
    carried_count: Tensor  # [B] int32


def _gather_rows(t: Tensor, idx: Tensor) -> Tensor:
    """t: [B, W, ...], idx: [B] -> [B, ...] (clamped)."""
    idx = idx.long().clamp(0, t.shape[1] - 1)
    idx = idx.reshape(-1, *([1] * (t.dim() - 1))).expand(-1, 1, *t.shape[2:])
    return torch.gather(t, 1, idx).squeeze(1)


def _shift_carry(y: Tensor, n: Tensor) -> Tensor:
    """carried[k] = y[n + k] (clamped); y: [B, W, ...]."""
    W = y.shape[1]
    k = torch.arange(W, device=y.device)[None, :]
    idx = (n.long()[:, None] + k).clamp(0, W - 1)
    idx = idx.reshape(*idx.shape, *([1] * (y.dim() - 2))).expand(*idx.shape, *y.shape[2:])
    return torch.gather(y, 1, idx)


def speculative_accept(
    u: Tensor,  # [B, W-1] uniforms in [0, 1)
    x: Tensor,  # [B, W] window inputs (x_0 = last committed)
    y: Tensor,  # [B, W] model samples
    p_draft: Tensor,  # [B, W, V]
    p_new: Tensor,  # [B, W, V]
    active_w: Tensor,  # [B] live window width
    resample_fn: Callable[[Tensor, Tensor], Tensor],
    # resample_fn(residual_logits [B, V], reject_row [B]) -> tokens [B]
) -> AcceptResult:
    B, W, V = p_new.shape
    xi = x[:, 1:].long()
    p_adv_at_x = torch.gather(p_new[:, :-1, :], 2, xi[:, :, None])[..., 0]
    p_drf_at_x = torch.gather(p_draft[:, 1:, :], 2, xi[:, :, None])[..., 0]
    ratio = p_adv_at_x / torch.clamp_min(p_drf_at_x, 1e-20)
    i = torch.arange(1, W, device=x.device)[None, :]
    accept = (u < torch.clamp_max(ratio, 1.0)) & (i < active_w[:, None])

    run = torch.cumprod(accept.to(torch.int32), dim=1)
    n = torch.minimum(1 + run.sum(1), active_w.long())
    full = n >= active_w

    adv_row = _gather_rows(p_new, n - 1)
    drf_row = _gather_rows(p_draft, torch.clamp_max(n, W - 1))
    residual = torch.clamp_min(adv_row - drf_row, 0.0)
    res_logits = torch.where(residual > 0, torch.log(torch.clamp_min(residual, 1e-38)),
                             NEG_INF)
    degenerate = torch.all(residual <= 0, dim=-1, keepdim=True)
    adv_logits = torch.where(adv_row > 0, torch.log(torch.clamp_min(adv_row, 1e-38)),
                             NEG_INF)
    res_logits = torch.where(degenerate, adv_logits, res_logits)
    resampled = resample_fn(res_logits, n - 1)

    j = torch.arange(W, device=x.device)[None, :]
    y_last = _gather_rows(y, active_w - 1)
    last_tok = torch.where(full, y_last, resampled)
    x_next = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    nm1 = (n - 1)[:, None]
    out_tokens = torch.where(j < nm1, x_next,
                             torch.where(j == nm1, last_tok[:, None], 0)).to(torch.int32)
    p_draft_next = torch.cat([p_draft[:, 1:], p_draft[:, -1:]], dim=1)
    out_probs = torch.where((j < nm1)[:, :, None], p_draft_next,
                            torch.where((j == nm1)[:, :, None], p_new, 0.0))
    return AcceptResult(
        n=n.to(torch.int32),
        out_tokens=out_tokens,
        out_probs=out_probs,
        carried_tokens=_shift_carry(y, n).to(torch.int32),
        carried_probs=_shift_carry(p_new, n),
        carried_count=torch.clamp_min(active_w - n, 0).to(torch.int32),
    )


def jacobi_accept(x: Tensor, y: Tensor, p_new: Tensor, active_w: Tensor) -> AcceptResult:
    """Longest prefix with x_i == y_{i-1}; commits y_0..y_{n-1}."""
    B, W, V = p_new.shape
    i = torch.arange(1, W, device=x.device)[None, :]
    match = (x[:, 1:] == y[:, :-1]) & (i < active_w[:, None])
    run = torch.cumprod(match.to(torch.int32), dim=1)
    n = torch.minimum(1 + run.sum(1), active_w.long())
    j = torch.arange(W, device=x.device)[None, :]
    return AcceptResult(
        n=n.to(torch.int32),
        out_tokens=torch.where(j < n[:, None], y, 0).to(torch.int32),
        out_probs=torch.where((j < n[:, None])[:, :, None], p_new, 0.0),
        carried_tokens=_shift_carry(y, n).to(torch.int32),
        carried_probs=_shift_carry(p_new, n),
        carried_count=torch.clamp_min(active_w - n, 0).to(torch.int32),
    )
