"""Hand-written Hopper kernels (sources in sjd_tpu_torch/csrc) with their
plain PyTorch versions."""

from __future__ import annotations

from typing import Dict


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's launch counter, by kernel name."""
    from .decode_attention import decode_attention
    from .fused_epilogue import fused_epilogue_into_cache
    from .quant_linear import quant_linear_a8, quant_linear_a16

    return {"fused_epilogue": fused_epilogue_into_cache.launches,
            "decode_attention": decode_attention.launches,
            "quant_linear_a16": quant_linear_a16.launches,
            "quant_linear_a8": quant_linear_a8.launches}
