"""Model operations of one whole forward, from shapes: every row the
forward takes (both CFG halves, every draft row, the prompt's padding),
the products at 2 M N K, the head over the rows it computes, attention
over the live fill (4 T H D rows per sample and layer; a prefill's causal
half, 2 H D P^2)."""

from __future__ import annotations

from .shapes import projections


def decode_flops(m: dict, S: int, T: int, fills) -> float:
    M = S * T
    prod = 2.0 * M * sum(n * k for n, k in projections(m)) * m["NL"]
    head = 2.0 * M * m["V"] * m["d"]
    attn = 4.0 * T * m["H"] * m["D"] * float(sum(fills)) * m["NL"]
    return prod + head + attn


def prefill_flops(m: dict, S: int, P: int, head_rows: int) -> float:
    M = S * P
    prod = 2.0 * M * sum(n * k for n, k in projections(m)) * m["NL"]
    head = 2.0 * head_rows * m["V"] * m["d"]
    attn = 2.0 * m["H"] * m["D"] * P * P * S * m["NL"]
    return prod + head + attn
