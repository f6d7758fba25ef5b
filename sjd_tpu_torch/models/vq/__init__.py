"""Taming VQGAN decoder (sjd_tpu/models/vq)."""

from .taming import CHAMELEON_VQ, VQConfig, decode, init_vq_params

__all__ = ["CHAMELEON_VQ", "VQConfig", "decode", "init_vq_params"]
