"""Taming VQGAN, encoder and decoder, and its checkpoint port
(sjd_tpu/models/vq)."""

from .port import port_vqgan
from .taming import (
    CHAMELEON_VQ, VQConfig, codebook_encode, decode, encode, encode_latents, init_vq_params)

__all__ = ["CHAMELEON_VQ", "VQConfig", "codebook_encode", "decode", "encode",
           "encode_latents", "init_vq_params", "port_vqgan"]
