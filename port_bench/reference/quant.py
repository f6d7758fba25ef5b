"""Frozen copy of the quantizers whose results the port computes from the
shared weights: weights per output row (int4 codes in [-8, 7], int8 in
[-127, 127]) and KV rows per (row, head) in int8. Scales are
max(amax * fl32(1/q), 1e-8) in float32, codes round half to even, and the
scale is kept in bf16, so the dequantized value is code * bf16(scale)."""

from __future__ import annotations

import torch

INV127 = (torch.tensor(1.0) / torch.tensor(127.0)).item()
INV7 = (torch.tensor(1.0) / torch.tensor(7.0)).item()


def dequant_rows(w: torch.Tensor, bits: int) -> torch.Tensor:
    """w [N, K] -> the float32 weight that per-row ``bits`` quantization
    leaves: code * bf16(scale)."""
    wf = w.float()
    inv, lo, hi = (INV7, -8, 7) if bits == 4 else (INV127, -127, 127)
    s = torch.clamp_min(wf.abs().amax(-1) * inv, 1e-8)
    q = torch.clamp(torch.round(wf / s[:, None]), lo, hi)
    return q * s.to(torch.bfloat16).float()[:, None]


def kv_int8(x: torch.Tensor) -> torch.Tensor:
    """x [..., D] float32 -> code * bf16(scale), per row of the last axis."""
    s = torch.clamp_min(x.abs().amax(-1) * INV127, 1e-8)
    q = torch.clamp(torch.round(x / s[..., None]), -127, 127)
    return q * s.to(torch.bfloat16).float()[..., None]
