"""Bind a decoder config into the engine's ModelFns interface
(sjd_tpu/models/adapter.py)."""

from __future__ import annotations

from typing import Optional

from .. import resolve_device
from ..core.engine import ModelFns
from . import transformer


def decoder_model_fns(cfg: transformer.DecoderConfig, *,
                      max_positions: Optional[int] = None, device=None) -> ModelFns:
    """ModelFns for the decoder on ``device``, with a precomputed RoPE table."""
    dev = resolve_device(device)
    rope = transformer.make_rope_table(cfg, max_positions, device=dev)

    def forward(params, ids, positions, kv, cache_end, valid, logits_tail=None,
                inputs_embeds=None):
        out = transformer.forward(params, cfg, ids, positions, kv, cache_end,
                                  valid, rope, logits_tail=logits_tail,
                                  inputs_embeds=inputs_embeds)
        return out.logits, out.kv

    def init_cache(batch: int, buf_len: int, model_size: int = 1):
        return transformer.init_kv_cache(cfg, batch, buf_len, device=dev,
                                         model_size=model_size)

    return ModelFns(forward=forward, init_cache=init_cache,
                    vocab_size=cfg.vocab_size, device=dev)
