"""Taming VQGAN (encoder and decoder) and Emu3VisionVQ, with their
checkpoint ports, and the VQGAN trainer's discriminators and LPIPS
(sjd_tpu/models/vq)."""

from .discriminator import PatchGANConfig, init_patchgan_params, patchgan_logits
from .emu3_port import init_emu3_vq_params, port_emu3_vq, synth_emu3_vq_state_dict
from .emu3_vq import EMU3_VQ, Emu3VQConfig
from .lpips import init_lpips_params, lpips, port_lpips
from .port import port_vqgan
from .taming import (
    CHAMELEON_VQ, LLAMAGEN_VQ8, LLAMAGEN_VQ16, VQConfig, codebook_encode, codebook_lookup,
    decode, decode_latents, encode, encode_latents, init_vq_params)

__all__ = ["CHAMELEON_VQ", "EMU3_VQ", "LLAMAGEN_VQ8", "LLAMAGEN_VQ16", "Emu3VQConfig",
           "PatchGANConfig", "VQConfig", "codebook_encode", "codebook_lookup", "decode",
           "decode_latents", "encode", "encode_latents", "init_emu3_vq_params",
           "init_lpips_params", "init_patchgan_params", "init_vq_params", "lpips",
           "patchgan_logits", "port_emu3_vq", "port_lpips", "port_vqgan",
           "synth_emu3_vq_state_dict"]
