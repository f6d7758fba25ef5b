"""Emu3VisionVQ torch checkpoints -> the port's Emu3 VQ tree
(sjd_tpu/models/vq/emu3_port.py), and random parameters with the same
structure.

Convolution weights stay in torch's layouts (OIHW, OIDHW); the codebook is
f32 and everything else ``cfg.dtype``. The reference's ``decoder.up`` is
indexed by resolution level (up[n-1] the lowest); the tree stores the
levels lowest first.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ... import resolve_device
from ...utils.port import as_tensor
from .emu3_vq import Emu3VQConfig


def port_emu3_vq(sd: Mapping[str, Any], cfg: Emu3VQConfig, *, device=None) -> Dict:
    dev = resolve_device(device)
    dt = cfg.dtype
    n = cfg.num_resolutions

    def t(name, dtype=dt):
        return as_tensor(sd[name]).to(device=dev, dtype=dtype)

    def conv(name):
        return t(f"{name}.weight"), t(f"{name}.bias")

    def gn(name):
        return {"norm_scale": t(f"{name}.weight"), "norm_bias": t(f"{name}.bias")}

    def bn(name):
        return {"scale": t(f"{name}.weight"), "bias": t(f"{name}.bias"),
                "mean": t(f"{name}.running_mean"), "var": t(f"{name}.running_var")}

    def maybe_spatial(name):
        if f"{name}.conv_y.weight" not in sd:
            return gn(name)
        p = {"norm_scale": t(f"{name}.norm_layer.weight"),
             "norm_bias": t(f"{name}.norm_layer.bias")}
        p["conv_y_w"], p["conv_y_b"] = conv(f"{name}.conv_y")
        p["conv_b_w"], p["conv_b_b"] = conv(f"{name}.conv_b")
        return p

    def res2d(base):
        p = {"norm1": maybe_spatial(f"{base}.norm1"), "norm2": maybe_spatial(f"{base}.norm2")}
        p["conv1_w"], p["conv1_b"] = conv(f"{base}.conv1")
        p["conv2_w"], p["conv2_b"] = conv(f"{base}.conv2")
        if f"{base}.nin_shortcut.weight" in sd:
            p["nin_w"], p["nin_b"] = conv(f"{base}.nin_shortcut")
        return p

    def attn2d(base):
        p = {"norm": maybe_spatial(f"{base}.norm")}
        for ours, theirs in (("q", "q"), ("k", "k"), ("v", "v"), ("proj", "proj_out")):
            p[f"{ours}_w"], p[f"{ours}_b"] = conv(f"{base}.{theirs}")
        return p

    def tres(base):
        p = {"norm1": bn(f"{base}.norm1"), "norm2": bn(f"{base}.norm2")}
        p["conv1_w"], p["conv1_b"] = conv(f"{base}.conv1.conv")
        p["conv2_w"], p["conv2_b"] = conv(f"{base}.conv2.conv")
        if f"{base}.nin_shortcut.weight" in sd:
            p["nin_w"], p["nin_b"] = conv(f"{base}.nin_shortcut")
        return p

    def time_convs(prefix):
        out, i = [], 0
        while f"{prefix}.time_conv.{i}.conv.conv.weight" in sd:
            w, b = conv(f"{prefix}.time_conv.{i}.conv.conv")
            out.append({"conv_w": w, "conv_b": b})
            i += 1
        return out

    down = []
    for i in range(n):
        level: Dict = {"res": [res2d(f"encoder.down.{i}.block.{j}")
                               for j in range(cfg.num_res_blocks)]}
        if f"encoder.down.{i}.attn.0.q.weight" in sd:
            level["attn"] = [attn2d(f"encoder.down.{i}.attn.{j}")
                             for j in range(cfg.num_res_blocks)]
        if f"encoder.down.{i}.downsample.conv.weight" in sd:
            w, b = conv(f"encoder.down.{i}.downsample.conv")
            level["downsample"] = {"conv_w": w, "conv_b": b}
        down.append(level)
    encoder = {"down": down, "mid_block1": res2d("encoder.mid.block_1"),
               "mid_attn": attn2d("encoder.mid.attn_1"),
               "mid_block2": res2d("encoder.mid.block_2"),
               "norm_out_scale": t("encoder.norm_out.weight"),
               "norm_out_bias": t("encoder.norm_out.bias"),
               "time_conv": time_convs("encoder"),
               "time_res_stack": [tres(f"encoder.time_res_stack.{j}")
                                  for j in range(cfg.num_res_blocks)]}
    encoder["conv_in_w"], encoder["conv_in_b"] = conv("encoder.conv_in")
    encoder["conv_out_w"], encoder["conv_out_b"] = conv("encoder.conv_out")

    up = []
    for idx in range(n):
        lvl = n - 1 - idx
        level = {"res": [res2d(f"decoder.up.{lvl}.block.{j}")
                         for j in range(cfg.num_res_blocks + 1)]}
        if f"decoder.up.{lvl}.attn.0.q.weight" in sd:
            level["attn"] = [attn2d(f"decoder.up.{lvl}.attn.{j}")
                             for j in range(cfg.num_res_blocks + 1)]
        if f"decoder.up.{lvl}.upsample.conv.weight" in sd:
            w, b = conv(f"decoder.up.{lvl}.upsample.conv")
            level["upsample"] = {"conv_w": w, "conv_b": b}
        up.append(level)
    decoder = {"time_res_stack": [tres(f"decoder.time_res_stack.{j}")
                                  for j in range(cfg.num_res_blocks)],
               "time_conv": time_convs("decoder"),
               "mid_block1": res2d("decoder.mid.block_1"),
               "mid_attn": attn2d("decoder.mid.attn_1"),
               "mid_block2": res2d("decoder.mid.block_2"),
               "up": up, "norm_out": maybe_spatial("decoder.norm_out")}
    decoder["conv_in_w"], decoder["conv_in_b"] = conv("decoder.conv_in")
    decoder["conv_out_w"], decoder["conv_out_b"] = conv("decoder.conv_out")

    out = {"encoder": encoder, "decoder": decoder,
           "codebook": t("quantize.embedding.weight", dtype=torch.float32)}
    out["quant_conv_w"], out["quant_conv_b"] = conv("quant_conv.conv")
    out["post_quant_conv_w"], out["post_quant_conv_b"] = conv("post_quant_conv.conv")
    return out


def init_emu3_vq_params(seed: int, cfg: Emu3VQConfig, *, device=None) -> Dict:
    """Random parameters with the checkpoint's structure: the synthetic
    state dict of :func:`synth_emu3_vq_state_dict` through
    :func:`port_emu3_vq` (the JAX package's values for the same seed)."""
    return port_emu3_vq(synth_emu3_vq_state_dict(seed, cfg), cfg, device=device)


def synth_emu3_vq_state_dict(seed: int, cfg: Emu3VQConfig) -> Dict[str, np.ndarray]:
    """A synthetic torch-layout Emu3VisionVQ state dict (numpy, f32) built by
    the reference module's construction rules, from ``np.random.RandomState
    (seed)`` in the JAX package's order, so its values are the JAX
    package's: convolutions N(0, 0.05^2) with zero biases, unit norms, the
    codebook N(0, 0.05^2)."""
    rs = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}

    def conv2d(name, co, ci, k):
        sd[f"{name}.weight"] = rs.randn(co, ci, k, k).astype(np.float32) * 0.05
        sd[f"{name}.bias"] = np.zeros(co, np.float32)

    def conv3d(name, co, ci, kt, kh, kw):
        sd[f"{name}.weight"] = rs.randn(co, ci, kt, kh, kw).astype(np.float32) * 0.05
        sd[f"{name}.bias"] = np.zeros(co, np.float32)

    def gn(name, c):
        sd[f"{name}.weight"] = np.ones(c, np.float32)
        sd[f"{name}.bias"] = np.zeros(c, np.float32)

    def bn(name, c):
        gn(name, c)
        sd[f"{name}.running_mean"] = np.zeros(c, np.float32)
        sd[f"{name}.running_var"] = np.ones(c, np.float32)

    def spatial(name, f, zq):
        gn(f"{name}.norm_layer", f)
        conv2d(f"{name}.conv_y", f, zq, 1)
        conv2d(f"{name}.conv_b", f, zq, 1)

    def res2d(base, ci, co, zq=None):
        if zq is None:
            gn(f"{base}.norm1", ci)
            gn(f"{base}.norm2", co)
        else:
            spatial(f"{base}.norm1", ci, zq)
            spatial(f"{base}.norm2", co, zq)
        conv2d(f"{base}.conv1", co, ci, 3)
        conv2d(f"{base}.conv2", co, co, 3)
        if ci != co:
            conv2d(f"{base}.nin_shortcut", co, ci, 1)

    def attn2d(base, c, zq=None):
        if zq is None:
            gn(f"{base}.norm", c)
        else:
            spatial(f"{base}.norm", c, zq)
        for nm in ("q", "k", "v", "proj_out"):
            conv2d(f"{base}.{nm}", c, c, 1)

    def tres(base, ci, co):
        bn(f"{base}.norm1", ci)
        bn(f"{base}.norm2", co)
        conv3d(f"{base}.conv1.conv", co, ci, 3, 3, 3)
        conv3d(f"{base}.conv2.conv", co, co, 3, 3, 3)
        if ci != co:
            conv3d(f"{base}.nin_shortcut", co, ci, 1, 1, 1)

    ch, z, zq = cfg.ch, cfg.z_channels, cfg.embed_dim
    n, nrb = cfg.num_resolutions, cfg.num_res_blocks
    in_mult = (1,) + tuple(cfg.ch_mult)
    t_blocks = int(math.log2(cfg.temporal_downsample_factor))

    conv2d("encoder.conv_in", ch, 3, 3)
    for i in range(n):
        block_in, block_out = ch * in_mult[i], ch * cfg.ch_mult[i]
        for j in range(nrb):
            res2d(f"encoder.down.{i}.block.{j}", block_in if j == 0 else block_out, block_out)
            if i in cfg.attn_levels:
                attn2d(f"encoder.down.{i}.attn.{j}", block_out)
        if i != n - 1:
            conv2d(f"encoder.down.{i}.downsample.conv", block_out, block_out, 3)
    mid = ch * cfg.ch_mult[-1]
    res2d("encoder.mid.block_1", mid, mid)
    attn2d("encoder.mid.attn_1", mid)
    res2d("encoder.mid.block_2", mid, mid)
    gn("encoder.norm_out", mid)
    conv2d("encoder.conv_out", z, mid, 3)
    for i in range(t_blocks):
        conv3d(f"encoder.time_conv.{i}.conv.conv", z, z, 4, 3, 3)
    for j in range(nrb):
        tres(f"encoder.time_res_stack.{j}", z, z)

    for j in range(nrb):
        tres(f"decoder.time_res_stack.{j}", z, z)
    for i in range(t_blocks):
        conv3d(f"decoder.time_conv.{i}.conv.conv", z, z, 3, 3, 3)
    conv2d("decoder.conv_in", mid, z, 3)
    res2d("decoder.mid.block_1", mid, mid, zq)
    attn2d("decoder.mid.attn_1", mid, zq)
    res2d("decoder.mid.block_2", mid, mid, zq)
    block_in = mid
    for lvl in reversed(range(n)):
        block_out = ch * cfg.ch_mult[lvl]
        for j in range(nrb + 1):
            res2d(f"decoder.up.{lvl}.block.{j}", block_in if j == 0 else block_out,
                  block_out, zq)
            if lvl in cfg.attn_levels:
                attn2d(f"decoder.up.{lvl}.attn.{j}", block_out, zq)
        block_in = block_out
        if lvl != 0:
            conv2d(f"decoder.up.{lvl}.upsample.conv", block_in, block_in, 3)
    spatial("decoder.norm_out", block_in, zq)
    conv2d("decoder.conv_out", 3, block_in, 3)

    sd["quantize.embedding.weight"] = rs.randn(cfg.codebook_size, zq).astype(np.float32) * 0.05
    conv3d("quant_conv.conv", zq, z, 3, 1, 1)
    conv3d("post_quant_conv.conv", z, zq, 3, 1, 1)
    return sd
