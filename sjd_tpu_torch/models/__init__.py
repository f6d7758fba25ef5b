"""Decoder, Chameleon/Lumina family and the VQ decoder (sjd_tpu/models)."""

from .adapter import decoder_model_fns
from .transformer import DecoderConfig, KVCache, forward, init_kv_cache, init_params

__all__ = ["decoder_model_fns", "DecoderConfig", "KVCache", "forward",
           "init_kv_cache", "init_params"]
