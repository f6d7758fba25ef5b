"""Anole model family (sjd_tpu/models/anole.py): the Chameleon-7B backbone
with HF Chameleon's image grammar, a fixed ``image_seq_length`` = 1024-token
image after <boi>, <eoi> forced at the next offset and no per-row <eol>.

multimodal_generation_mode:
  "text-only"    - every image token and <boi>/<eoi> suppressed;
  "image-only"   - text suppressed: <boi>, 1024 image tokens, <eoi>, eos;
  "interleaved"  - no suppression outside images ("interleaved-text-image");
  "unrestricted" - no grammar at all.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import resolve_device
from ..core.engine import EngineConfig, SJDEngine
from ..core.grammar import GrammarSpec
from ..core.processors import SamplingParams
from .adapter import decoder_model_fns
from .chameleon import chameleon_config
from .transformer import DecoderConfig

BOI_ID = 8197
EOI_ID = 8196
IMAGE_VOCAB_START = 4
IMAGE_VOCAB_END = 8195
IMAGE_SEQ_LENGTH = 1024  # 32 x 32 latents
EOS_ID = 2
MODES = ("image-only", "text-only", "interleaved", "unrestricted")


def normalize_mode(mode: str) -> str:
    """The canonical mode name ("interleaved-text-image" -> "interleaved")."""
    mode = {"interleaved-text-image": "interleaved"}.get(mode, mode)
    if mode not in MODES:
        raise ValueError(f"unknown multimodal_generation_mode {mode!r}")
    return mode


def anole_grammar(mode: str = "image-only", *, max_len: int = 0,
                  image_seq_length: int = IMAGE_SEQ_LENGTH) -> GrammarSpec:
    mode = normalize_mode(mode)
    return GrammarSpec(
        kind="anole", image_start_id=BOI_ID, image_end_id=EOI_ID,
        image_vocab_start=IMAGE_VOCAB_START, image_vocab_end=IMAGE_VOCAB_END,
        image_seq_length=image_seq_length, eos_id=EOS_ID, mode=mode,
        # no <boi> from max_len - image_seq_length - 1 generated tokens on
        boi_suppress_from=(max_len - image_seq_length - 1
                           if max_len and mode in ("image-only", "interleaved") else -1),
        suppress_eos_at_begin=(mode == "image-only"),
    )


ANOLE_GRAMMAR = anole_grammar("image-only")


def anole_engine(
    *,
    window: int = 16,
    guidance_scale: float = 7.0,
    image_top_k: int = 2000,
    text_top_k: int = 10,
    top_p: Optional[float] = None,
    scheme: str = "speculative_jacobi",
    init: str = "random",
    max_len: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    greedy: bool = False,
    multimodal_generation_mode: str = "image-only",
    kv_quant: bool = False,  # True: the int8 KV cache (the JAX factory has none)
    act_quant: str = "bf16",
    model_cfg: Optional[DecoderConfig] = None,  # overrides the 7B config
    image_seq_length: int = IMAGE_SEQ_LENGTH,
    cuda_graph: bool = True,
    device=None,
) -> SJDEngine:
    dev = resolve_device(device)
    cfg = model_cfg if model_cfg is not None else chameleon_config("7B", dtype)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    if act_quant != "bf16":
        cfg = dataclasses.replace(cfg, act_quant=act_quant)
    if not max_len:
        max_len = image_seq_length + 128
    model = decoder_model_fns(
        cfg, max_positions=max(cfg.max_position_embeddings, max_len + window + 8), device=dev)
    econfig = EngineConfig(
        window=window, interval_l=1, interval_r=image_seq_length + 1, scheme=scheme,
        init=init, max_len=max_len, eos_id=EOS_ID, pad_id=0, cfg_mode="mask_prompt",
    )
    sampling = SamplingParams(
        guidance_scale=guidance_scale, do_cfg=True, image_top_k=image_top_k,
        text_top_k=text_top_k, top_p=top_p, greedy=greedy,
    )
    engine = SJDEngine(model, econfig,
                       anole_grammar(multimodal_generation_mode, max_len=max_len,
                                     image_seq_length=image_seq_length),
                       sampling, cuda_graph=cuda_graph)
    engine.model_cfg = cfg
    engine.image_seq_length = image_seq_length
    return engine
