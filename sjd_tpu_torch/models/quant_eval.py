"""Quantization fidelity: per-layer output error and end-logits KL
(sjd_tpu/models/quant_eval.py).

For each weight variant of :func:`compare_quant_variants`, against the
unquantized forward on the same tokens:

  * per-layer relative output MSE ||h_q - h_ref||^2 / ||h_ref||^2 on the
    residual stream after each decoder layer, and
  * KL(p_ref || p_q) of the end logits, averaged over positions, and the
    share of positions whose argmax survives quantization.

The acceptance test of the SJD engine reads exactly these logits, so the KL
is the proxy for NFE and quality drift. The forward is the cache-free
causal one of ``layer_outputs`` (the JAX package's ``forward_train`` layer
body), with the quantized products of ``transformer.linear_multi``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .transformer import (
    DecoderConfig, _attend, apply_rope, embed_lookup, head_layer_norm, layer_params, linear,
    linear_multi, make_rope_table, quantize_weights, rms_norm)

Tensor = torch.Tensor


def layer_outputs(params, cfg: DecoderConfig, ids: Tensor, positions: Optional[Tensor] = None,
                  rope_table: Optional[Tensor] = None):
    """Cache-free causal forward: (per-layer residual stream [NL, B, T, D]
    f32, logits [B, T, V] f32). The attention is the plain ``_attend`` under
    a causal mask."""
    B, T = ids.shape
    dev = ids.device
    if positions is None:
        positions = torch.arange(T, device=dev)[None].expand(B, T)
    if rope_table is None:
        rope_table = make_rope_table(cfg, T + 1, device=dev)
    aq = cfg.act_quant
    h = embed_lookup(params, ids, cfg.dtype)
    rope = rope_table[positions.long()]
    cos, sin = rope[:, :, 0], rope[:, :, 1]
    i = torch.arange(T, device=dev)
    mask = (i[:, None] >= i[None, :])[None].expand(B, T, T)
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def attn_block(x, p):
        qp, kp, vp = linear_multi(x, (p["wq"], p["wk"], p["wv"]), aq)
        q, k, v = qp.reshape(B, T, H, D), kp.reshape(B, T, Hkv, D), vp.reshape(B, T, Hkv, D)
        if cfg.qk_norm:
            q = head_layer_norm(q, p["q_norm_scale"], p["q_norm_bias"], cfg.qk_norm_eps)
            k = head_layer_norm(k, p["k_norm_scale"], p["k_norm_bias"], cfg.qk_norm_eps)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        return linear(_attend(q, k, v, mask).reshape(B, T, cfg.q_dim), p["wo"], aq)

    def mlp_block(x, p):
        g, u = linear_multi(x, (p["w_gate"], p["w_up"]), aq)
        return linear(F.silu(g.float()).to(u.dtype) * u, p["w_down"], aq)

    per_layer = []
    for li in range(cfg.num_layers):
        p = layer_params(params["layers"], li)
        if cfg.swin_norm:
            h1 = h + rms_norm(attn_block(h, p), p["attn_norm"], cfg.norm_eps)
            h = h1 + rms_norm(mlp_block(h1, p), p["mlp_norm"], cfg.norm_eps)
        else:
            h1 = h + attn_block(rms_norm(h, p["attn_norm"], cfg.norm_eps), p)
            h = h1 + mlp_block(rms_norm(h1, p["mlp_norm"], cfg.norm_eps), p)
        per_layer.append(h.float())
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if cfg.tie_word_embeddings:
        logits = torch.einsum("btd,vd->btv", h.float(), params["embed"].float())
    else:
        logits = linear(h, params["lm_head"], aq)
    return torch.stack(per_layer), logits.float()


def fidelity_metrics(params_ref, params_q, cfg: DecoderConfig, ids: Tensor) -> Dict[str, Tensor]:
    """{"rel_mse": [NL], "kl": scalar, "top1_agree": scalar} of ``params_q``
    against ``params_ref`` on the same tokens."""
    with torch.no_grad():
        h_ref, logits_ref = layer_outputs(params_ref, cfg, ids)
        h_q, logits_q = layer_outputs(params_q, cfg, ids)
    num = ((h_q - h_ref) ** 2).sum(dim=(1, 2, 3))
    den = torch.clamp_min((h_ref ** 2).sum(dim=(1, 2, 3)), 1e-20)
    logp_ref = torch.log_softmax(logits_ref, -1)
    logp_q = torch.log_softmax(logits_q, -1)
    kl = (logp_ref.exp() * (logp_ref - logp_q)).sum(-1).mean()
    top1 = (logits_ref.argmax(-1) == logits_q.argmax(-1)).float().mean()
    return {"rel_mse": num / den, "kl": kl, "top1_agree": top1}


DEFAULT_VARIANTS = {
    "int8": dict(bits=8),
    "int4_equil": dict(bits=4, head_bits=8, equilibrate=True),
    "int4_raw": dict(bits=4, head_bits=8, equilibrate=False),
    "int4_a8": dict(bits=4, head_bits=8, equilibrate=True, act_quant="int8"),
}


def compare_quant_variants(params_ref, cfg: DecoderConfig, ids: Tensor, *,
                           variants: Optional[Dict[str, dict]] = None
                           ) -> Dict[str, Dict[str, Any]]:
    """Quantize ``params_ref`` under each named variant (``quantize_weights``
    keywords; an ``act_quant`` key overrides the config's) and report its
    fidelity as Python floats: int8 (W8A16), int4_equil (the equilibrated
    int4 the flagship serves), int4_raw (the ablation the fold is judged
    against) and int4_a8 (W4A8) by default."""
    out: Dict[str, Dict[str, Any]] = {}
    for name, kw in (variants or DEFAULT_VARIANTS).items():
        kw = dict(kw)
        act = kw.pop("act_quant", None)
        # act_quant only changes quantized products: the reference forward
        # is the same under either config
        cfg_v = cfg if act is None else dataclasses.replace(cfg, act_quant=act)
        pq = quantize_weights(params_ref, config=cfg_v, **kw)
        m = fidelity_metrics(params_ref, pq, cfg_v, ids)
        rel = [float(v) for v in m["rel_mse"]]
        out[name] = {"kl": float(m["kl"]), "top1_agree": float(m["top1_agree"]),
                     "rel_mse_per_layer": rel, "rel_mse_last": rel[-1]}
    return out
