"""Seeded random weights, made by the benchmark and handed to both sides.

Every weight is a pure function of ``(seed, name, layer)``: a generator on
the target device is seeded from those three, and the values are drawn in
float32 in row blocks and rounded to the type they are served in (bf16 for
the decoder, float32 for the VQ decoder). The program receives them through
:func:`decoder_leaves` and quantizes them with its own quantizer; the plain
reference draws the same leaves again, one layer at a time, and works out
what the program derived from them itself. Nothing here imports the port.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

# rows drawn per call: bounds the float32 temporary of the largest leaf (the
# 184622-row Emu3 head) to 16384 x d floats
_ROW_BLOCK = 16384


def seed_of(cfg: dict) -> int:
    """The configuration's weights: one checkpoint, whatever the run's seed
    (SJD's acceptance follows the weights, so weights drawn per run would
    change the work from run to run)."""
    return int(cfg["serving"]["weights_seed"])


def _generator(seed: int, name: str, layer: int, device) -> torch.Generator:
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             zlib.crc32(name.encode()), int(layer) + 1]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(state >> np.uint64(1)))
    return g


def normal(seed: int, name: str, layer: int, shape: Tuple[int, ...], scale: float,
           dtype: torch.dtype, device) -> torch.Tensor:
    """N(0, scale^2) of ``shape``, drawn in float32 row blocks and rounded
    to ``dtype``."""
    g = _generator(seed, name, layer, device)
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(shape[0], -1)
    for r in range(0, shape[0], _ROW_BLOCK):
        block = flat[r:r + _ROW_BLOCK]
        block.copy_(torch.randn(block.shape, generator=g, dtype=torch.float32,
                                device=device).mul_(scale))
    return out


def uniform(seed: int, name: str, layer: int, shape: Tuple[int, ...], bound: float,
            dtype: torch.dtype, device) -> torch.Tensor:
    """U(-bound, bound) of ``shape`` in ``dtype``."""
    g = _generator(seed, name, layer, device)
    u = torch.rand(shape, generator=g, dtype=torch.float32, device=device)
    return (u * (2 * bound) - bound).to(dtype)


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------


def decoder_shapes(cfg: dict) -> Dict[str, Tuple[Tuple[int, int], int]]:
    """Per-layer projection -> ((out, in), fan_in), in torch's layout."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    q_dim = cfg["num_attention_heads"] * hd
    kv_dim = cfg["num_key_value_heads"] * hd
    return {
        "wq": ((q_dim, d), d), "wk": ((kv_dim, d), d), "wv": ((kv_dim, d), d),
        "wo": ((d, q_dim), q_dim), "w_gate": ((ff, d), d), "w_up": ((ff, d), d),
        "w_down": ((d, ff), ff),
    }


def layer_weight(cfg: dict, seed: int, name: str, layer: int, device) -> torch.Tensor:
    """One layer's bf16 projection ``name``: N(0, 1 / fan_in), the port's
    random-weight convention (``transformer.init_params``)."""
    (shape, fan_in) = decoder_shapes(cfg)[name]
    return normal(seed, name, layer, shape, 1.0 / math.sqrt(fan_in), torch.bfloat16, device)


def table_weight(cfg: dict, seed: int, name: str, device) -> torch.Tensor:
    """The bf16 ``embed`` or ``lm_head`` table [vocab, d]."""
    d = cfg["hidden_size"]
    return normal(seed, name, 0, (cfg["vocab_size"], d), 1.0 / math.sqrt(d),
                  torch.bfloat16, device)


def decoder_leaves(cfg: dict, seed: int, device) -> Iterator[Tuple[str, int, torch.Tensor]]:
    """(name, layer, bf16 weight) for every random leaf, layer by layer, then
    the two tables (layer -1). Norm scales are ones and qk-norm biases
    zeros, as in the port's random init; they are not drawn."""
    for layer in range(cfg["num_hidden_layers"]):
        for name in decoder_shapes(cfg):
            yield name, layer, layer_weight(cfg, seed, name, layer, device)
    for name in ("embed", "lm_head"):
        yield name, -1, table_weight(cfg, seed, name, device)


# ---------------------------------------------------------------------------
# the taming VQ decoder (the half that turns codes into pixels)
# ---------------------------------------------------------------------------


def taming_decoder_tree(vq: dict, seed: int, device) -> dict:
    """The decode half of a taming VQGAN in the port's tree layout (OIHW
    convolutions), float32: convolutions U(-1/sqrt(fan_in), +), biases 0,
    norms 1, the codebook U(-1/n_embed, +), as the port's random init."""
    ch, mult, nres = vq["ch"], tuple(vq["ch_mult"]), vq["num_res_blocks"]
    count = [0]

    def conv(k, cin, cout):
        count[0] += 1
        return uniform(seed, "vq_conv", count[0], (cout, cin, k, k),
                       1.0 / math.sqrt(k * k * cin), torch.float32, device)

    def zeros(c):
        return torch.zeros((c,), dtype=torch.float32, device=device)

    def ones(c):
        return torch.ones((c,), dtype=torch.float32, device=device)

    def res(cin, cout):
        p = {"norm1_scale": ones(cin), "norm1_bias": zeros(cin),
             "conv1_w": conv(3, cin, cout), "conv1_b": zeros(cout),
             "norm2_scale": ones(cout), "norm2_bias": zeros(cout),
             "conv2_w": conv(3, cout, cout), "conv2_b": zeros(cout)}
        if cin != cout:
            p["nin_w"] = conv(1, cin, cout)
            p["nin_b"] = zeros(cout)
        return p

    def attn(c):
        p = {"norm_scale": ones(c), "norm_bias": zeros(c)}
        for name in ("q", "k", "v", "proj"):
            p[f"{name}_w"] = conv(1, c, c)
            p[f"{name}_b"] = zeros(c)
        return p

    n_res = len(mult)
    top = ch * mult[-1]
    up = []
    block_in = top
    for i in reversed(range(n_res)):
        cout = ch * mult[i]
        level = {"res": [res(block_in if j == 0 else cout, cout) for j in range(nres + 1)]}
        if i == n_res - 1:  # attention at the lowest resolution only
            level["attn"] = [attn(cout) for _ in range(nres + 1)]
        if i != 0:
            level["upsample"] = {"conv_w": conv(3, cout, cout), "conv_b": zeros(cout)}
        up.append(level)
        block_in = cout
    decoder = {
        "conv_in_w": conv(3, vq["z_channels"], top), "conv_in_b": zeros(top),
        "mid_block1": res(top, top), "mid_attn": attn(top), "mid_block2": res(top, top),
        "up": up,
        "norm_out_scale": ones(block_in), "norm_out_bias": zeros(block_in),
        "conv_out_w": conv(3, block_in, vq["out_ch"]), "conv_out_b": zeros(vq["out_ch"]),
    }
    return {
        "decoder": decoder,
        "codebook": uniform(seed, "vq_codebook", 0, (vq["n_embed"], vq["embed_dim"]),
                            1.0 / vq["n_embed"], torch.float32, device),
        "post_quant_conv_w": conv(1, vq["embed_dim"], vq["z_channels"]),
        "post_quant_conv_b": zeros(vq["z_channels"]),
    }
