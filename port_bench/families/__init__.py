"""The port's system under test, built from a configuration and a mix.

``build(cfg, mix, device)`` makes the weights (:mod:`port_bench.weights`),
hands them to the port's own quantizer leaf by leaf, and builds the port's
engine for the configuration's family (``families/<family>.py``: its engine
settings, grammar state and image decode). Every import of the port happens
inside these functions."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import weights
from ..traffic.generator import grid, max_prompt_len, neg_prompt


@dataclasses.dataclass
class System:
    engine: Any  # sjd_tpu_torch.core.engine.SJDEngine
    params: Any
    model_cfg: Any  # sjd_tpu_torch.models.transformer.DecoderConfig
    grid: tuple  # (h, w)
    prompt_width: int
    neg_width: int
    make_gstate: Optional[Callable]  # batcher seam (per-slot metas -> GrammarState)
    gstate: Optional[Callable]  # batch -> GrammarState for generate, or None
    decode_image: Optional[Callable]  # (prompt, gen) -> uint8 [H, W, 3]


def model_config(cfg: dict, act_quant: str = "bf16"):
    """The port's DecoderConfig of a configuration file."""
    from sjd_tpu_torch.models.transformer import DecoderConfig

    srv = cfg["serving"]
    return DecoderConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"], num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
        rope_theta=cfg["rope_theta"], qk_norm=bool(cfg.get("qk_layernorm", False)),
        qk_norm_eps=srv.get("qk_norm_eps", 1e-5), swin_norm=bool(cfg.get("swin_norm", False)),
        kv_quant=srv["kv_cache"] == "int8", act_quant=act_quant,
        norm_eps=cfg["rms_norm_eps"], dtype=torch.bfloat16,
        max_position_embeddings=srv["rope_positions"])


def program_params(cfg: dict, seed: int, device) -> dict:
    """The seed's weights as the port holds them at W4A16: each bf16 leaf
    quantized by ``transformer.quantize_leaf`` as soon as it is drawn (packed
    int4 projections, the int8 head, the bf16 embedding), stacked by layer."""
    from sjd_tpu_torch.models.transformer import quantize_leaf

    if cfg["serving"]["weights"] != "w4a16":
        raise ValueError(f"weights {cfg['serving']['weights']!r}: only w4a16 is built")
    n, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    per_layer: dict = {}
    params: dict = {}
    for name, layer, w in weights.decoder_leaves(cfg, seed, device):
        q = quantize_leaf(name, w, bits=4, head_bits=8)
        del w
        if layer < 0:
            params[name] = q
        else:
            per_layer.setdefault(name, []).append(q)
    layers = {name: {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
              for name, parts in per_layer.items()}
    per_layer.clear()
    bf = dict(dtype=torch.bfloat16, device=device)
    layers["attn_norm"] = torch.ones((n, d), **bf)
    layers["mlp_norm"] = torch.ones((n, d), **bf)
    if cfg.get("qk_layernorm"):
        H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        D = d // H
        for name, heads in (("q", H), ("k", Hkv)):
            layers[f"{name}_norm_scale"] = torch.ones((n, heads, D), **bf)
            layers[f"{name}_norm_bias"] = torch.zeros((n, heads, D), **bf)
    params["layers"] = layers
    params["final_norm"] = torch.ones((d,), **bf)
    return params


def build(cfg: dict, mix: dict, device, *, act_quant: str = "bf16", params=None) -> System:
    from sjd_tpu_torch.core.engine import SJDEngine
    from sjd_tpu_torch.core.grammar import GrammarSpec
    from sjd_tpu_torch.core.processors import SamplingParams
    from sjd_tpu_torch.models.adapter import decoder_model_fns

    fam = importlib.import_module(f"{__name__}.{cfg['serving']['family']}")
    mcfg = model_config(cfg, act_quant)
    h, w = grid(cfg, mix)
    econf = fam.engine_config(cfg, mix, h, w)
    model = decoder_model_fns(
        mcfg, device=device,
        max_positions=max(mcfg.max_position_embeddings, econf.max_len + econf.window + 8))
    sampling = SamplingParams(guidance_scale=mix["guidance_scale"], do_cfg=True,
                              image_top_k=mix["image_top_k"], text_top_k=mix["text_top_k"])
    eng = SJDEngine(model, econf, GrammarSpec(**cfg["serving"]["grammar"]), sampling)
    eng.model_cfg = mcfg
    gstate = fam.gstate_fn(cfg, h, w, device)
    if gstate is not None:
        eng.default_gstate = gstate
    if params is None:
        params = program_params(cfg, weights.seed_of(cfg), device)
    neg = neg_prompt(cfg, mix)
    decode = fam.image_decoder(cfg, mix, device) if mix.get("decode_images") else None
    return System(engine=eng, params=params, model_cfg=mcfg, grid=(h, w),
                  prompt_width=max_prompt_len(cfg, mix),
                  neg_width=0 if neg is None else len(neg),
                  make_gstate=(None if gstate is None else (lambda metas: gstate(len(metas)))),
                  gstate=gstate, decode_image=decode)


def left_pad(rows, width: int, pad_id: int = 0):
    """Prompts -> (ids [B, width] int32, mask [B, width] bool), left-padded."""
    ids = np.full((len(rows), width), pad_id, np.int32)
    mask = np.zeros((len(rows), width), bool)
    for b, r in enumerate(rows):
        ids[b, width - len(r):] = r
        mask[b, width - len(r):] = True
    return ids, mask
