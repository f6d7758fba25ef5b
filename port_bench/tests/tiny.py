"""Tiny configurations of both families for the CPU tests: the real
vocabularies' special ids (so the grammars and prompts are the real ones),
two narrow layers, a small taming decoder; and a tiny Chameleon-34B shape
(swin-norm, 8 query heads over 1 KV head) from the 7B's file."""

from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def config(name: str) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg.update(hidden_size=64, intermediate_size=128, num_attention_heads=2,
               num_key_value_heads=2 if cfg["num_key_value_heads"] == cfg["num_attention_heads"]
               else 1, num_hidden_layers=2)
    if cfg["serving"]["family"] == "lumina":
        cfg["vocab_size"] = 9000
        cfg["serving"]["text_ids"] = [8830, 8990]
        cfg["serving"]["vq"].update(ch=32, ch_mult=[1, 2], num_res_blocks=1, z_channels=32,
                                    embed_dim=8)
    else:
        cfg["serving"]["neg_text_len"] = 6
    return cfg


def shaped_34b(cfg: dict) -> dict:
    """A tiny configuration in Chameleon-34B's shape (Lumina-mGPT-34B):
    norms after the attention and the MLP (swin-norm), GQA group 8, heads
    of 16, qk-norm and the int8 cache as the 7B's."""
    return dict(cfg, hidden_size=128, intermediate_size=256, num_attention_heads=8,
                num_key_value_heads=1, swin_norm=True)


def mix(name: str, **over) -> dict:
    m = json.loads((HERE / "traffic" / "mixes" / f"{name}.json").read_text())
    m = copy.deepcopy(m)
    m.update(image_px=64 if m["image_px"] != 720 else 32, prompt_len=[4, 8], window=4, pool=3,
             image_top_k=50, text_top_k=5)
    if m["entry"] == "batcher":
        m.update(batch=2, chunk_steps=4, outstanding=4, trace_every=2, trace_repeat=2)
    else:
        m.update(chunk_steps=4, trace_every=2, trace_repeat=2)
    m["check_min_tokens"] = 21 if m["image_px"] == 64 else 4
    m.update(over)
    return m


def spec(cell: str, cfg_name: str, mix_name: str, limits=None, shape=None, **over) -> dict:
    """``shape``: None, or "34b" for :func:`shaped_34b`."""
    from port_bench.run import load_spec

    s = load_spec(cell)
    s["cfg"] = shaped_34b(config(cfg_name)) if shape == "34b" else config(cfg_name)
    s["mix"] = mix(mix_name, **over)
    s["cellfile"] = {"limits": limits or {"mean_gap": 1e-3, "vq_mean_abs": 1.0,
                                          "vq_max_abs": 255}}
    return s
