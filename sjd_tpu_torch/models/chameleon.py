"""Chameleon / Lumina-mGPT model family (sjd_tpu/models/chameleon.py).

7B = 32 layers, 32 heads, d=4096, ff=11008, vocab 65536, per-head qk
LayerNorm, RoPE theta 1e4; 34B = 48 layers, 64 query heads over 8 KV heads,
d=8192, ff=22016, swin-norm. FlexAR token layout: <image_start>(8197)
<size h>(8804 + h/32) <size w>(8804 + w/32), then rows of image tokens
[4..8195] each followed by <new_line>(8803), then <image_end>(8196).
Engine parameters: window 16, CFG by prompt masking, image_top_k 2000,
text_top_k 10, jacobi_interval_r = (ts/16)^2 + ts/16 - 10.
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
from .transformer import DecoderConfig

IMAGE_START_ID = 8197  # <racm3:break>
IMAGE_END_ID = 8196  # <eoss>
NEW_LINE_ID = 8803  # <reserved08799>
IMAGE_VOCAB_START = 4
IMAGE_VOCAB_END = 8195
SIZE_TOKEN_BASE = 8804
EOS_ID = 8710  # <reserved08706>

LUMINA_GRAMMAR = GrammarSpec(
    kind="lumina",
    image_start_id=IMAGE_START_ID,
    image_end_id=IMAGE_END_ID,
    newline_id=NEW_LINE_ID,
    image_vocab_start=IMAGE_VOCAB_START,
    image_vocab_end=IMAGE_VOCAB_END,
    size_token_base=SIZE_TOKEN_BASE,
    grid_scale=2,
    header_len=3,
)


def chameleon_config(size: str = "7B", dtype: torch.dtype = torch.bfloat16) -> DecoderConfig:
    if size == "7B":
        return DecoderConfig(
            vocab_size=65536, hidden_size=4096, intermediate_size=11008,
            num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
            rope_theta=10000.0, qk_norm=True, swin_norm=False, norm_eps=1e-5,
            dtype=dtype, max_position_embeddings=4096 + 2048,
        )
    if size == "34B":
        # Chameleon-30B/34B: 48 layers, 64 query heads over 8 KV heads (GQA),
        # d 8192, ff 22016, norms after the attention and MLP (swin-norm)
        return DecoderConfig(
            vocab_size=65536, hidden_size=8192, intermediate_size=22016,
            num_layers=48, num_heads=64, num_kv_heads=8, head_dim=128,
            rope_theta=10000.0, qk_norm=True, swin_norm=True, norm_eps=1e-5,
            dtype=dtype, max_position_embeddings=4096 + 2048,
        )
    raise ValueError(f"unknown chameleon size {size!r}")


def jacobi_interval_r(target_size: int) -> int:
    """(ts/16)^2 + ts/16 - 10 (model_wrappers/model_loader.py:44)."""
    g = target_size // 16
    return g * g + g - 10


def lumina_engine(
    *,
    size: str = "7B",
    target_size: int = 768,
    window: int = 16,
    guidance_scale: float = 3.0,
    image_top_k: int = 2000,
    text_top_k: int = 10,
    top_p: Optional[float] = None,
    scheme: str = "speculative_jacobi",
    init: str = "random",
    max_len: int = 0,
    temperature: float = 1.0,
    dtype: torch.dtype = torch.bfloat16,
    greedy: bool = False,
    kv_quant: bool = True,
    act_quant: str = "bf16",  # "int8": W4A8/W8A8 on quantized weights
    model_cfg: Optional[DecoderConfig] = None,  # overrides the size registry;
    # must keep the FlexAR vocab layout
    cuda_graph: bool = True,  # SJDEngine's: replay a captured step on CUDA
    ar_fast_path: bool = False,  # SJDEngine's: width-1 steps outside the interval
    device=None,
) -> SJDEngine:
    dev = resolve_device(device)
    cfg = model_cfg if model_cfg is not None else chameleon_config(size, dtype)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    if act_quant != "bf16":
        cfg = dataclasses.replace(cfg, act_quant=act_quant)
    grid = target_size // 16
    if not max_len:
        max_len = grid * (grid + 1) + 64
    model = decoder_model_fns(
        cfg, max_positions=max(cfg.max_position_embeddings, max_len + window + 8),
        device=dev)
    econfig = EngineConfig(
        window=window, interval_l=1, interval_r=jacobi_interval_r(target_size),
        scheme=scheme, init=init, max_len=max_len, eos_id=EOS_ID, pad_id=0,
        cfg_mode="mask_prompt",
    )
    sampling = SamplingParams(
        guidance_scale=guidance_scale, do_cfg=True, image_top_k=image_top_k,
        text_top_k=text_top_k, temperature=temperature, top_p=top_p, greedy=greedy,
    )
    engine = SJDEngine(model, econfig, LUMINA_GRAMMAR, sampling, cuda_graph=cuda_graph,
                       ar_fast_path=ar_fast_path)
    engine.model_cfg = cfg
    return engine
