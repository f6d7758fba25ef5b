"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W): bf16 tensor cores and HBM3. Shares are stated against
these, with the card's name and power limit printed beside each run."""

BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_S)
