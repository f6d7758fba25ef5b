"""Decode attention (``csrc/decode_attention.cu``: the split kernel and
its merge), one call per layer over every sample of the window.

Per sample: the live fill's KV rows read once (K and V, with their scales
in an int8 cache), the window's queries in and outputs out in bf16;
operations 4 T H D rows (scores and the weighted sum)."""

from __future__ import annotations

from .peaks import bound_s


def layer_call(m: dict, T: int, fills) -> tuple:
    """(operations, bytes) of one layer's call; ``fills``: rows read per
    sample (the live fill, the window's own rows included)."""
    H, Hkv, D = m["H"], m["Hkv"], m["D"]
    rows = float(sum(fills))
    S = len(fills)
    nbytes = 2 * rows * Hkv * (D * m["kv_bytes"] + m["kv_scale_bytes"]) + 2.0 * S * T * H * D * 2
    return 4.0 * T * H * D * rows, nbytes


def forward_bound(m: dict, T: int, fills) -> float:
    """Seconds: the bound of one forward's NL calls."""
    return m["NL"] * bound_s(*layer_call(m, T, fills))
