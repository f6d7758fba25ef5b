"""Taming / HF-Chameleon / LlamaGen VQGAN checkpoints -> the port's VQ tree
(sjd_tpu/models/vq/port.py), encoder and decoder.

Name styles:
  "taming"   - Chameleon's vendored VQGAN and HF ChameleonVQVAE:
               encoder.down.{i}.block.{j}.*, decoder.up.{i}.block.{j}.*,
               mid.block_1/attn_1/block_2, quantize.embedding.weight.
               taming's decoder.up is indexed by resolution level (0 = the
               highest) while the tree stores levels lowest first.
  "llamagen" - encoder.conv_blocks.{i}.res.{j}.*, .attn.{j}, mid.{0,1,2};
               decoder.conv_blocks already lowest first.

Convolution weights stay OIHW (torch's layout, the port's too); the
codebook is f32, everything else ``cfg.dtype``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from ... import resolve_device
from ...utils.port import as_tensor
from .taming import VQConfig


def port_vqgan(sd: Mapping[str, Any], cfg: VQConfig, *, style: str = "taming",
               device=None) -> Dict:
    dev = resolve_device(device)
    dt = cfg.dtype
    n = cfg.num_resolutions

    def t(name, dtype=dt):
        return as_tensor(sd[name]).to(device=dev, dtype=dtype)

    def conv(name):
        return t(f"{name}.weight"), t(f"{name}.bias")

    def res(base) -> Dict:
        p = {"norm1_scale": t(f"{base}.norm1.weight"), "norm1_bias": t(f"{base}.norm1.bias")}
        p["conv1_w"], p["conv1_b"] = conv(f"{base}.conv1")
        p["norm2_scale"], p["norm2_bias"] = t(f"{base}.norm2.weight"), t(f"{base}.norm2.bias")
        p["conv2_w"], p["conv2_b"] = conv(f"{base}.conv2")
        for short in ("nin_shortcut", "conv_shortcut"):
            if f"{base}.{short}.weight" in sd:
                p["nin_w"], p["nin_b"] = conv(f"{base}.{short}")
        return p

    def attn(base) -> Dict:
        p = {"norm_scale": t(f"{base}.norm.weight"), "norm_bias": t(f"{base}.norm.bias")}
        for ours, theirs in (("q", "q"), ("k", "k"), ("v", "v"), ("proj", "proj_out")):
            p[f"{ours}_w"], p[f"{ours}_b"] = conv(f"{base}.{theirs}")
        return p

    if style == "taming":
        enc_level = lambda i: f"encoder.down.{i}"  # noqa: E731
        res_name = "block"
        dec_level = lambda idx: f"decoder.up.{n - 1 - idx}"  # noqa: E731
        mid = {"b1": "block_1", "attn": "attn_1", "b2": "block_2"}
    elif style == "llamagen":
        enc_level = lambda i: f"encoder.conv_blocks.{i}"  # noqa: E731
        res_name = "res"
        dec_level = lambda idx: f"decoder.conv_blocks.{idx}"  # noqa: E731
        mid = {"b1": "0", "attn": "1", "b2": "2"}
    else:
        raise ValueError(f"unknown style {style!r}")

    def levels(level_name, blocks, resample):
        out = []
        for i in range(n):
            base = level_name(i)
            level: Dict = {"res": [res(f"{base}.{res_name}.{j}") for j in range(blocks)]}
            if f"{base}.attn.0.q.weight" in sd:
                level["attn"] = [attn(f"{base}.attn.{j}") for j in range(blocks)]
            if f"{base}.{resample}.conv.weight" in sd:
                w, b = conv(f"{base}.{resample}.conv")
                level[resample] = {"conv_w": w, "conv_b": b}
            out.append(level)
        return out

    def trunk(part) -> Dict:
        p = {}
        p["conv_in_w"], p["conv_in_b"] = conv(f"{part}.conv_in")
        p["mid_block1"] = res(f"{part}.mid.{mid['b1']}")
        p["mid_attn"] = attn(f"{part}.mid.{mid['attn']}")
        p["mid_block2"] = res(f"{part}.mid.{mid['b2']}")
        p["norm_out_scale"] = t(f"{part}.norm_out.weight")
        p["norm_out_bias"] = t(f"{part}.norm_out.bias")
        p["conv_out_w"], p["conv_out_b"] = conv(f"{part}.conv_out")
        return p

    params: Dict = {"codebook": t("quantize.embedding.weight", torch.float32)}
    for name in ("quant_conv", "post_quant_conv"):
        if f"{name}.weight" in sd:
            params[f"{name}_w"], params[f"{name}_b"] = conv(name)
    if "encoder.conv_in.weight" in sd:
        params["encoder"] = dict(trunk("encoder"), down=levels(
            enc_level, cfg.num_res_blocks, "downsample"))
    if "decoder.conv_in.weight" in sd:
        params["decoder"] = dict(trunk("decoder"), up=levels(
            dec_level, cfg.num_res_blocks + 1, "upsample"))
    return params
