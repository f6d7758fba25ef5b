"""The model's shapes as the roofline functions need them."""

from __future__ import annotations


def model_dims(cfg: dict) -> dict:
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    D = d // H
    Hkv = cfg["num_key_value_heads"]
    return {"d": d, "ff": cfg["intermediate_size"], "H": H, "Hkv": Hkv, "D": D,
            "NL": cfg["num_hidden_layers"], "V": cfg["vocab_size"],
            "q_dim": H * D, "kv_dim": Hkv * D,
            "kv_bytes": 1 if cfg["serving"]["kv_cache"] == "int8" else 2,
            "kv_scale_bytes": 2 if cfg["serving"]["kv_cache"] == "int8" else 0}


def projections(m: dict) -> list:
    """(N, K) of each per-layer product, torch's [out, in] layout."""
    d, ff = m["d"], m["ff"]
    return [(m["q_dim"], d), (m["kv_dim"], d), (m["kv_dim"], d), (d, m["q_dim"]),
            (ff, d), (ff, d), (d, ff)]
