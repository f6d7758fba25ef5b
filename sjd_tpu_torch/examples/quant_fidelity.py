"""Quantization-fidelity report (examples/quant_fidelity.py): per-layer
output MSE and end-logits KL of int8 / int4-equilibrated / int4-raw / W4A8
against the bf16 forward.

With checkpoints:   --ckpt-dir <dir> evaluates the real weights, read by
                    ``utils/port.py``.
Without (default):  Chameleon-7B's widths (4096/11008/65536) at --layers
                    layers (default 8), with --outlier-cols dominant input
                    columns per projection scaled by --outlier-scale: plain
                    random weights have no outliers, and the equilibration
                    fold would be a no-op on them.

Prints one JSON object with the JAX script's keys (int8 <= int4_equil <
int4_raw in KL is what tests/test_quant_fidelity.py asserts).

    python -m sjd_tpu_torch.examples.quant_fidelity [--layers 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from .. import resolve_device
from ..models.chameleon import chameleon_config
from ..models.quant_eval import compare_quant_variants
from ..models.transformer import init_params

PROJECTIONS = ("wq", "wk", "wv", "w_gate", "w_up", "w_down", "wo")


def fidelity_ids(vocab_size: int, tokens: int, device=None) -> torch.Tensor:
    """The [1, tokens] prompt the report runs (seed 7; the JAX script draws
    its ids from jax.random instead)."""
    ids = np.random.RandomState(7).randint(0, vocab_size, (1, tokens))
    return torch.as_tensor(ids, dtype=torch.long, device=device)


def outlier_params(cfg, seed: int, outlier_scale: float, outlier_cols: int, device):
    """Random bf16 weights (seed ``seed``) whose projections have
    ``outlier_cols`` input columns scaled by ``outlier_scale``, the columns
    chosen by ``RandomState(seed + 1)`` in the JAX script's order."""
    rs = np.random.RandomState(seed + 1)
    dims = {"wq": cfg.hidden_size, "wk": cfg.hidden_size, "wv": cfg.hidden_size,
            "w_gate": cfg.hidden_size, "w_up": cfg.hidden_size,
            "w_down": cfg.intermediate_size, "wo": cfg.q_dim}
    cols = {k: rs.choice(dims[k], outlier_cols, replace=False) for k in PROJECTIONS}

    def scale(name, w):
        if name in cols:
            c = torch.as_tensor(cols[name], device=w.device)
            w[..., c] = (w[..., c].float() * outlier_scale).to(w.dtype)
        return w

    return init_params(seed, cfg, device=device, leaf_fn=scale)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--outlier-scale", type=float, default=20.0)
    ap.add_argument("--outlier-cols", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = chameleon_config("7B", torch.bfloat16)
    if args.ckpt_dir:
        from ..utils.port import load_sharded_state, port_hf_llama_like

        params = port_hf_llama_like(load_sharded_state(args.ckpt_dir), cfg, device=dev)
        mode = "checkpoint"
    else:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
        params = outlier_params(cfg, args.seed, args.outlier_scale, args.outlier_cols, dev)
        mode = f"synthetic-outliers x{args.outlier_scale}"

    res = compare_quant_variants(params, cfg, fidelity_ids(cfg.vocab_size, args.tokens, dev))
    print(json.dumps({
        "mode": mode,
        "config": f"{cfg.hidden_size}d/{cfg.intermediate_size}ff/"
                  f"{cfg.vocab_size}V x {cfg.num_layers}L",
        "variants": {
            k: {"kl": round(v["kl"], 6),
                "top1_agree": round(v["top1_agree"], 4),
                "rel_mse_last_layer": round(v["rel_mse_last"], 6),
                "rel_mse_per_layer": [round(x, 6) for x in v["rel_mse_per_layer"]]}
            for k, v in res.items()
        },
    }))


if __name__ == "__main__":
    main()
