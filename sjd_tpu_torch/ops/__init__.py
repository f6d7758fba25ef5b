"""Hand-written Hopper kernels (sources in sjd_tpu_torch/csrc) with their
plain PyTorch versions."""
