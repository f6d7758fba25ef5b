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

from .transformer import DecoderConfig, _forward_train, make_rope_table, quantize_weights

Tensor = torch.Tensor


def layer_outputs(params, cfg: DecoderConfig, ids: Tensor, positions: Optional[Tensor] = None,
                  rope_table: Optional[Tensor] = None):
    """Cache-free causal forward: (per-layer residual stream [NL, B, T, D]
    f32, logits [B, T, V] f32), through ``transformer.forward_train``'s
    layer body (the plain ``_attend`` under a causal mask)."""
    B, T = ids.shape
    dev = ids.device
    if positions is None:
        positions = torch.arange(T, device=dev)[None].expand(B, T)
    if rope_table is None:
        rope_table = make_rope_table(cfg, T + 1, device=dev)
    per_layer: list = []
    logits = _forward_train(params, cfg, ids, positions, None, rope_table, False, per_layer)
    return torch.stack(per_layer), logits


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
