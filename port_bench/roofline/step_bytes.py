"""Bytes one whole forward has to move through HBM, from shapes: each
counted once, as it crosses between the card's memory and its chip.

- every K1 launch (:mod:`.k1`): the packed weight and its bf16 row scales,
  the bf16 activations in and the outputs out; the int8 head over the rows
  it computes;
- the bf16 embedding rows gathered, one per row of the forward;
- a decode forward's attention in every layer (:mod:`.attention`): the live
  fill's K and V rows with their scales, the queries and the outputs;
- a prefill's K and V rows with their scales, written once into the cache
  in every layer.
"""

from __future__ import annotations

from .attention import layer_call
from .k1 import forward_launches, launch


def weight_bytes(m: dict) -> float:
    """The packed weights and scales of every product and the head: what a
    forward streams whatever its rows."""
    return sum(launch(0, N, K, bits)[1] for _, N, K, bits in forward_launches(m, 0, 0))


def _launches_and_rows(m: dict, rows: int, head_rows: int) -> float:
    """Every K1 launch at ``rows`` rows (the head at ``head_rows``), and the
    embedding rows gathered."""
    launches = forward_launches(m, rows, head_rows)
    return sum(launch(*x)[1] for x in launches) + 2.0 * rows * m["d"]


def decode_bytes(m: dict, S: int, T: int, fills) -> float:
    """One decode forward of ``S`` samples of ``T`` rows; ``fills``: rows
    read per sample (the live fill, the window's own rows included)."""
    return _launches_and_rows(m, S * T, S * T) + m["NL"] * layer_call(m, T, fills)[1]


def prefill_bytes(m: dict, S: int, P: int, head_rows: int) -> float:
    """One prefill of ``S`` samples of ``P`` rows, the head over
    ``head_rows``."""
    kv = 2.0 * S * P * m["Hkv"] * (m["D"] * m["kv_bytes"] + m["kv_scale_bytes"])
    return _launches_and_rows(m, S * P, head_rows) + m["NL"] * kv
