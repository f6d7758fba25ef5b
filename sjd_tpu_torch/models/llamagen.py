"""LlamaGen (gpt-fast style) model family (sjd_tpu/models/llamagen.py).

GPT-B 111M .. GPT-7B, vocab 16384 (the VQ-16 codebook), 2-D grid RoPE, a
SwiGLU MLP with hidden = 8d/3 rounded up to a multiple of 256, MHA. The
condition is a prefix of embedding rows: one class row (c2i, the
LabelEmbedder table) or 120 caption rows (t2i, T5 features through the
CaptionEmbedder's GELU MLP). It enters the engine as ``prompt_embeds``;
CFG runs ``cfg_mode="neg_prompt"`` with the unconditional embedding (the
table's last row, or the learned uncond caption) as the negative prompt.
Generation is fixed-length: ``latent_size ** 2`` image tokens, no grammar.

Both kernels take every published size's heads: 64 (GPT-B, GPT-L,
GPT-XL, GPT-XXL, GPT-XXXL, GPT-1B), 100 (GPT-3B) and 128 (GPT-7B).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..core.engine import EngineConfig, SJDEngine
from ..core.grammar import GrammarSpec
from ..core.processors import SamplingParams
from .adapter import decoder_model_fns
from .transformer import DecoderConfig, check_kernel_head_dim

Tensor = torch.Tensor
VOCAB_SIZE = 16384

# GPT sizes (LlamaGen's registry)
SIZES = {
    "GPT-B": dict(n_layer=12, n_head=12, dim=768),
    "GPT-L": dict(n_layer=24, n_head=16, dim=1024),
    "GPT-XL": dict(n_layer=36, n_head=20, dim=1280),
    "GPT-XXL": dict(n_layer=48, n_head=24, dim=1536),
    "GPT-XXXL": dict(n_layer=48, n_head=40, dim=2560),
    "GPT-1B": dict(n_layer=22, n_head=32, dim=2048),
    "GPT-3B": dict(n_layer=24, n_head=32, dim=3200),
    "GPT-7B": dict(n_layer=32, n_head=32, dim=4096),
}


def _ffn_hidden(dim: int, multiple_of: int = 256) -> int:
    hidden = int(2 * (4 * dim) / 3)
    return ((hidden + multiple_of - 1) // multiple_of) * multiple_of


def llamagen_config(name: str = "GPT-B", *, block_size: int = 256, cls_token_num: int = 1,
                    dtype: torch.dtype = torch.bfloat16) -> DecoderConfig:
    s = SIZES[name]
    grid = math.isqrt(block_size)
    if grid * grid != block_size:
        raise ValueError("block_size must be a square grid")
    return DecoderConfig(
        vocab_size=VOCAB_SIZE, hidden_size=s["dim"], intermediate_size=_ffn_hidden(s["dim"]),
        num_layers=s["n_layer"], num_heads=s["n_head"], num_kv_heads=s["n_head"],
        head_dim=s["dim"] // s["n_head"], rope_theta=10000.0, rope_style="2d",
        rope_2d_cls_len=cls_token_num, rope_2d_grid_side=grid, qk_norm=False, norm_eps=1e-5,
        dtype=dtype, max_position_embeddings=cls_token_num + block_size + 64,
    )


# no text, no row ends: every generated token is an image token
LLAMAGEN_GRAMMAR = GrammarSpec(kind="none", image_vocab_start=0,
                               image_vocab_end=VOCAB_SIZE - 1)


def init_cond_params(rng: Union[int, torch.Generator], cfg: DecoderConfig, *,
                     num_classes: int = 1000, caption_dim: int = 2048,
                     model_type: str = "c2i", device=None) -> dict:
    """Random conditioning-embedder parameters with the JAX package's tree,
    shapes and scales, f32, from a ``torch.Generator`` (a seed makes one on
    ``device``): c2i ``{"kind", "label_table" [num_classes + 1, d]}`` (the
    last row is CFG's unconditional class), t2i ``{"kind", "fc1" [caption_dim,
    d], "fc2" [d, d], "uncond_embedding" [cls_len, caption_dim]}``."""
    dev = resolve_device(device)
    if isinstance(rng, torch.Generator):
        gen = rng
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(rng))
    d = cfg.hidden_size

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)

    if model_type == "c2i":
        return {"kind": "c2i", "label_table": normal(num_classes + 1, d) * 0.02}
    return {"kind": "t2i", "fc1": normal(caption_dim, d) * 0.02, "fc2": normal(d, d) * 0.02,
            "uncond_embedding": normal(cfg.rope_2d_cls_len, caption_dim)
            / math.sqrt(caption_dim)}


def embed_class(cond: dict, labels: Tensor, dtype: torch.dtype) -> Tensor:
    """[B] class ids -> the [B, 1, d] conditioning prefix."""
    table = cond["label_table"]
    return table[torch.as_tensor(labels, device=table.device).long()][:, None, :].to(dtype)


def embed_uncond_class(cond: dict, batch: int, dtype: torch.dtype) -> Tensor:
    table = cond["label_table"]
    return table[-1][None, None, :].expand(batch, 1, table.shape[1]).to(dtype)


def embed_caption(cond: dict, t5_feats: Tensor, dtype: torch.dtype) -> Tensor:
    """[B, P, caption_dim] T5 features -> [B, P, d]: fc1, tanh GELU, fc2 in
    f32 (the CaptionEmbedder's projection)."""
    h = torch.as_tensor(t5_feats, device=cond["fc1"].device).float() @ cond["fc1"]
    h = F.gelu(h, approximate="tanh")
    return (h @ cond["fc2"]).to(dtype)


def embed_uncond_caption(cond: dict, batch: int, dtype: torch.dtype) -> Tensor:
    u = cond["uncond_embedding"]
    return embed_caption(cond, u[None].expand(batch, *u.shape), dtype)


def llamagen_engine(
    *,
    name: str = "GPT-B",
    latent_size: int = 16,  # 256px / VQ-16
    cls_token_num: int = 1,
    window: int = 16,
    guidance_scale: float = 7.5,
    image_top_k: int = 1000,
    scheme: str = "speculative_jacobi",
    init: str = "random",
    temperature: float = 1.0,
    top_p: Optional[float] = None,
    dtype: torch.dtype = torch.bfloat16,
    greedy: bool = False,
    act_quant: str = "bf16",
    model_cfg: Optional[DecoderConfig] = None,  # overrides the GPT size; its
    # rope_2d_grid_side must be latent_size and rope_2d_cls_len cls_token_num
    cuda_graph: bool = True,
    device=None,
) -> SJDEngine:
    dev = resolve_device(device)
    block = latent_size * latent_size
    cfg = (model_cfg if model_cfg is not None else
           llamagen_config(name, block_size=block, cls_token_num=cls_token_num, dtype=dtype))
    if act_quant != "bf16":
        cfg = dataclasses.replace(cfg, act_quant=act_quant)
    check_kernel_head_dim(cfg, dev)
    # max_len counts generated tokens only: the image block
    max_len = block
    model = decoder_model_fns(
        cfg, max_positions=max(cfg.max_position_embeddings, max_len + window + 8), device=dev)
    econfig = EngineConfig(
        window=window, interval_l=1, interval_r=block - window - 2, scheme=scheme, init=init,
        max_len=max_len, eos_id=-1, pad_id=0, cfg_mode="neg_prompt",
    )
    sampling = SamplingParams(
        guidance_scale=guidance_scale, do_cfg=guidance_scale != 1.0, image_top_k=image_top_k,
        text_top_k=image_top_k, temperature=temperature, top_p=top_p, greedy=greedy,
    )
    engine = SJDEngine(model, econfig, LLAMAGEN_GRAMMAR, sampling, cuda_graph=cuda_graph)
    engine.model_cfg = cfg
    return engine
