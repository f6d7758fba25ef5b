"""Emu3-Gen model family (sjd_tpu/models/emu3.py).

8B = 32 layers, 32 query heads over 8 KV heads of 128 (GQA group 4), d
4096, ff 14336, vocab 184622, no qk-norm, RoPE theta 1e6, 9216 positions.
Prompt: bos + text + <|image start|> + "{H}*{W}" + <|image token|>; the
model then emits rows of w visual tokens each closed by <|extra_200|>
(eol), then eof, <|image end|>, eos, pad: every one forced at its offset
from the <|image token|> marker. The visual tokens are the vocab's last
32768 ids. At 720px the grid is 90 x 90: about 8.2k generated tokens.
CFG takes a separate negative prompt (``cfg_mode="neg_prompt"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import resolve_device
from ..core.engine import EngineConfig, SJDEngine
from ..core.grammar import GrammarSpec, init_state
from ..core.processors import SamplingParams
from .adapter import decoder_model_fns
from .transformer import DecoderConfig

VOCAB_SIZE = 184622
CODEBOOK_SIZE = 32768
PAD_ID = 151643
EOL_ID = 151846  # <|extra_200|>
EOF_ID = 151847  # <|extra_201|>
BOS_ID = 151849
EOS_ID = 151850
IMG_ID = 151851  # <|image token|>
BOI_ID = 151852  # <|image start|>
EOI_ID = 151853  # <|image end|>
VISUAL_START = VOCAB_SIZE - CODEBOOK_SIZE  # 151854
VISUAL_END = VOCAB_SIZE - 1  # 184621

EMU3_GRAMMAR = GrammarSpec(
    kind="emu3", image_start_id=BOI_ID, img_token_id=IMG_ID, image_end_id=EOI_ID,
    newline_id=EOL_ID, eof_id=EOF_ID, eos_id=EOS_ID, pad_id=PAD_ID,
    image_vocab_start=VISUAL_START, image_vocab_end=VISUAL_END,
)


def emu3_config(dtype: torch.dtype = torch.bfloat16) -> DecoderConfig:
    return DecoderConfig(
        vocab_size=VOCAB_SIZE, hidden_size=4096, intermediate_size=14336, num_layers=32,
        num_heads=32, num_kv_heads=8, head_dim=128, rope_theta=1_000_000.0, qk_norm=False,
        norm_eps=1e-5, dtype=dtype, max_position_embeddings=9216,
    )


def emu3_grammar_state(batch: int, h: int, w: int, *, armed: bool = False, device=None):
    """The grid is known from the prompt. The engine's prompt scan arms
    in_image at the prompt's trailing <|image token|>, so img_count counts
    generated tokens only; ``armed=True`` only for ids that lack the
    marker."""
    dev = resolve_device(device)
    return init_state(batch, device=dev,
                      h_lat=torch.full((batch,), h, dtype=torch.int32, device=dev),
                      w_lat=torch.full((batch,), w, dtype=torch.int32, device=dev),
                      in_image=armed)


def emu3_engine(
    *,
    h: int = 90,
    w: int = 90,
    window: int = 16,
    guidance_scale: float = 3.0,
    image_top_k: int = 2048,
    text_top_k: int = 10,
    top_p: Optional[float] = None,
    scheme: str = "speculative_jacobi",
    init: str = "random",
    max_len: int = 0,
    temperature: float = 1.0,
    dtype: torch.dtype = torch.bfloat16,
    greedy: bool = False,
    kv_quant: bool = False,  # True: the int8 KV cache (the JAX factory has none)
    act_quant: str = "bf16",
    model_cfg: Optional[DecoderConfig] = None,  # overrides the 8B config; must
    # keep the Emu3 vocab layout
    cuda_graph: bool = True,
    device=None,
) -> SJDEngine:
    dev = resolve_device(device)
    if not max_len:
        max_len = h * (w + 1) + 128
    cfg = model_cfg if model_cfg is not None else emu3_config(dtype)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    if act_quant != "bf16":
        cfg = dataclasses.replace(cfg, act_quant=act_quant)
    # max_len counts generated tokens; the rope table covers the prompt too
    model = decoder_model_fns(
        cfg, max_positions=max(cfg.max_position_embeddings, max_len + window + 8), device=dev)
    econfig = EngineConfig(
        window=window, interval_l=1, interval_r=h * (w + 1) - 1, scheme=scheme, init=init,
        max_len=max_len, eos_id=EOS_ID, pad_id=PAD_ID, cfg_mode="neg_prompt",
    )
    sampling = SamplingParams(
        guidance_scale=guidance_scale, do_cfg=True, image_top_k=image_top_k,
        text_top_k=text_top_k, temperature=temperature, top_p=top_p, greedy=greedy,
    )
    engine = SJDEngine(model, econfig, EMU3_GRAMMAR, sampling, cuda_graph=cuda_graph)
    engine.model_cfg = cfg
    # generate() with no gstate gets the (h, w) grid: the positional grammar
    # is a no-op on a plain init_state
    engine.default_gstate = lambda batch: emu3_grammar_state(batch, h, w, device=dev)
    return engine
