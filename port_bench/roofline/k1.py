"""K1 (``csrc/quant_linear.cu``, ``quant_linear_kernel``): one launch per
quantized product, int4 projections and the int8 head at W4A16.

Operations 2 M N K; bytes the packed weight (N K bits / 8), its bf16 row
scales (2 N), the bf16 activations in (2 M K) and the bf16 outputs out
(2 M N), each counted once."""

from __future__ import annotations

from .peaks import bound_s
from .shapes import projections


def launch(M: int, N: int, K: int, bits: int) -> tuple:
    """(operations, bytes) of one launch."""
    return 2.0 * M * N * K, N * K * bits / 8 + 2.0 * N + 2.0 * M * K + 2.0 * M * N


def forward_launches(m: dict, rows: int, head_rows: int) -> list:
    """(M, N, K, bits) of every K1 launch of one forward: the layers'
    int4 products at ``rows`` rows and the int8 head at ``head_rows``."""
    per_layer = [(rows, n, k, 4) for n, k in projections(m)]
    return per_layer * m["NL"] + [(head_rows, m["V"], m["d"], 8)]


def bound(launches: list) -> float:
    """Seconds: the sum of each launch's bound."""
    return sum(bound_s(*launch(*x)) for x in launches)
