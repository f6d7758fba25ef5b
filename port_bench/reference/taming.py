"""The taming VQGAN's decode half in float32 (NCHW): codes -> latents ->
post-quant convolution -> conv_in -> mid (res, attention, res) -> up levels
(res blocks, attention at the lowest resolution, nearest upsampling and a
convolution) -> GroupNorm, swish, conv_out -> pixels in [-1, 1] -> uint8
by ``(clip(x, -1, 1) + 1) * 127.5`` truncated, as an image file would be
written."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _conv(x, w, b, stride=1):
    return F.conv2d(x, w, b, stride=stride, padding=w.shape[-1] // 2)


def _gn(x, scale, bias, groups=32, eps=1e-6):
    return F.group_norm(x, groups, scale, bias, eps)


def _swish(x):
    return x * torch.sigmoid(x)


def _res(p, x):
    h = _conv(_swish(_gn(x, p["norm1_scale"], p["norm1_bias"])), p["conv1_w"], p["conv1_b"])
    h = _conv(_swish(_gn(h, p["norm2_scale"], p["norm2_bias"])), p["conv2_w"], p["conv2_b"])
    if "nin_w" in p:
        x = _conv(x, p["nin_w"], p["nin_b"])
    return x + h


def _attn(p, x):
    B, C, H, W = x.shape
    h = _gn(x, p["norm_scale"], p["norm_bias"])
    q, k, v = (_conv(h, p[f"{n}_w"], p[f"{n}_b"]).flatten(2).transpose(1, 2)
               for n in ("q", "k", "v"))
    probs = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(C), dim=-1)
    out = (probs @ v).transpose(1, 2).reshape(B, C, H, W)
    return x + _conv(out, p["proj_w"], p["proj_b"])


def decode(tree: dict, codes: torch.Tensor) -> torch.Tensor:
    """codes [B, h, w] (codebook ids) -> pixels [B, 3, 16h, 16w]."""
    z = tree["codebook"][codes.long()].permute(0, 3, 1, 2)
    z = _conv(z, tree["post_quant_conv_w"], tree["post_quant_conv_b"])
    d = tree["decoder"]
    h = _conv(z, d["conv_in_w"], d["conv_in_b"])
    h = _res(d["mid_block1"], h)
    h = _attn(d["mid_attn"], h)
    h = _res(d["mid_block2"], h)
    for level in d["up"]:
        for j, rp in enumerate(level["res"]):
            h = _res(rp, h)
            if "attn" in level:
                h = _attn(level["attn"][j], h)
        if "upsample" in level:
            h = F.interpolate(h, scale_factor=2.0, mode="nearest")
            h = _conv(h, level["upsample"]["conv_w"], level["upsample"]["conv_b"])
    h = _swish(_gn(h, d["norm_out_scale"], d["norm_out_bias"]))
    return _conv(h, d["conv_out_w"], d["conv_out_b"])


def to_uint8(pixels: torch.Tensor) -> np.ndarray:
    """[3, H, W] in [-1, 1] -> uint8 [H, W, 3]."""
    arr = pixels.permute(1, 2, 0).float().cpu().numpy()
    return ((np.clip(arr, -1, 1) + 1) * 127.5).astype(np.uint8)
