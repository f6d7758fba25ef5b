"""Taming VQGAN (encoder and decoder) and Emu3VisionVQ, with their
checkpoint ports (sjd_tpu/models/vq)."""

from .emu3_port import init_emu3_vq_params, port_emu3_vq, synth_emu3_vq_state_dict
from .emu3_vq import EMU3_VQ, Emu3VQConfig
from .port import port_vqgan
from .taming import (
    CHAMELEON_VQ, LLAMAGEN_VQ8, LLAMAGEN_VQ16, VQConfig, codebook_encode, decode, encode,
    encode_latents, init_vq_params)

__all__ = ["CHAMELEON_VQ", "EMU3_VQ", "LLAMAGEN_VQ8", "LLAMAGEN_VQ16", "Emu3VQConfig", "VQConfig", "codebook_encode", "decode",
           "encode", "encode_latents", "init_emu3_vq_params", "init_vq_params",
           "port_emu3_vq", "port_vqgan", "synth_emu3_vq_state_dict"]
