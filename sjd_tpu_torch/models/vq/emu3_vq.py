"""Emu3VisionVQ, the spatio-temporal VQ-VAE of Emu3 (sjd_tpu/models/vq/emu3_vq.py).

  * causal 3-D convolutions: t padded (2, 0), h and w by (ceil, floor) of
    k - stride;
  * temporal residual stacks with frozen BatchNorm statistics;
  * a 2-D decoder whose GroupNorms are modulated by the nearest-resized
    quantized latent (SpatialNorm);
  * codebook 32768 x 4, spatial factor 8, temporal factor 4: a still image
    is repeated over time on encode, and decode returns frame 0.

Parameters keep the JAX package's tree and names; convolution weights are
torch's layouts (OIHW, OIDHW), activations run NCHW / NCTHW inside, and the
public :func:`decode` and :func:`encode` keep the JAX layout ([B, H, W, 3]
pixels in [-1, 1]). The convolutions are ``F.conv2d`` / ``F.conv3d``, as the
JAX package leaves them to XLA.

The 2-D halves treat every frame on its own (per-frame GroupNorm,
convolution and attention), so :func:`decode` runs its 2-D decoder on frame
0 only and :func:`encode` runs its 2-D encoder once per image, where the
reference runs all four frames (four copies of the image on encode): the
frames it leaves out are not in the output.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .taming import conv2d, downsample, group_norm, swish, upsample

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Emu3VQConfig:
    codebook_size: int = 32768
    embed_dim: int = 4
    z_channels: int = 4
    in_channels: int = 3
    out_channels: int = 3
    temporal_downsample_factor: int = 4
    ch: int = 256
    ch_mult: Tuple[int, ...] = (1, 2, 2, 4)
    num_res_blocks: int = 2
    attn_levels: Tuple[int, ...] = (3,)  # level indices with attention
    dtype: torch.dtype = torch.float32

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)

    @property
    def spatial_factor(self) -> int:
        return 2 ** (self.num_resolutions - 1)


EMU3_VQ = Emu3VQConfig()


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def causal_conv3d(x: Tensor, w: Tensor, b: Tensor, *, stride=(1, 1, 1)) -> Tensor:
    """x [B, C, T, H, W]; w [co, ci, kt, kh, kw]; t padded (2, 0), h and w
    by (ceil, floor) of (k - stride)."""
    kh, kw = w.shape[3:]
    _, sh, sw = stride
    ph, pw = kh - sh, kw - sw
    x = F.pad(x, (pw // 2 + pw % 2, pw // 2, ph // 2 + ph % 2, ph // 2, 2, 0))
    return F.conv3d(x, w, b, stride=stride)


def batch_norm(x: Tensor, p: Dict, eps: float = 1e-5) -> Tensor:
    """Frozen-statistics BatchNorm over the channel axis (1)."""
    def c(t):
        return t.float().reshape(1, -1, *([1] * (x.dim() - 2)))
    inv = torch.rsqrt(c(p["var"]) + eps)
    return ((x.float() - c(p["mean"])) * inv * c(p["scale"]) + c(p["bias"])).to(x.dtype)


def spatial_norm(x: Tensor, zq: Tensor, p: Dict, eps: float = 1e-6) -> Tensor:
    """GroupNorm(x) * conv_y(zq') + conv_b(zq'), zq' = zq [B, C, h0, w0]
    nearest-resized to x's [H, W]."""
    H, W = x.shape[2:]
    h0, w0 = zq.shape[2:]
    ridx = (torch.arange(H, device=x.device) * h0) // H
    cidx = (torch.arange(W, device=x.device) * w0) // W
    zq_r = zq[:, :, ridx][:, :, :, cidx]
    xn = group_norm(x, p["norm_scale"], p["norm_bias"], eps=eps)
    return xn * conv2d(zq_r, p["conv_y_w"], p["conv_y_b"]) + conv2d(
        zq_r, p["conv_b_w"], p["conv_b_b"])


def _norm(x: Tensor, zq, p: Dict) -> Tensor:
    if "conv_y_w" in p:
        return spatial_norm(x, zq, p)
    return group_norm(x, p["norm_scale"], p["norm_bias"])


def res_block_2d(p: Dict, x: Tensor, zq=None) -> Tensor:
    h = conv2d(swish(_norm(x, zq, p["norm1"])), p["conv1_w"], p["conv1_b"])
    h = conv2d(swish(_norm(h, zq, p["norm2"])), p["conv2_w"], p["conv2_b"])
    if "nin_w" in p:
        x = conv2d(x, p["nin_w"], p["nin_b"])
    return x + h


def attn_block_2d(p: Dict, x: Tensor, zq=None) -> Tensor:
    B, C, H, W = x.shape
    nx = _norm(x, zq, p["norm"])

    def tokens(t):  # [B, C, H, W] -> [B, H*W, C]
        return t.permute(0, 2, 3, 1).reshape(B, H * W, C)

    q = tokens(conv2d(nx, p["q_w"], p["q_b"]))
    k = tokens(conv2d(nx, p["k_w"], p["k_b"]))
    v = tokens(conv2d(nx, p["v_w"], p["v_b"]))
    score = torch.softmax(torch.einsum("bqc,bkc->bqk", q.float(), k.float())
                          / math.sqrt(C), dim=-1)
    out = torch.einsum("bqk,bkc->bqc", score.to(v.dtype), v)
    out = out.reshape(B, H, W, C).permute(0, 3, 1, 2)
    return x + conv2d(out, p["proj_w"], p["proj_b"])


def temporal_res_block(p: Dict, x: Tensor) -> Tensor:
    """x [B, C, T, H, W]: BatchNorm, swish, causal conv, twice, plus the
    shortcut."""
    h = causal_conv3d(swish(batch_norm(x, p["norm1"])), p["conv1_w"], p["conv1_b"])
    h = causal_conv3d(swish(batch_norm(h, p["norm2"])), p["conv2_w"], p["conv2_b"])
    if "nin_w" in p:
        x = F.conv3d(x, p["nin_w"], p["nin_b"])
    return x + h


def temporal_upsample(p: Dict, x: Tensor) -> Tensor:
    """Nearest x2 over T, then a causal (3, 3, 3) convolution."""
    return causal_conv3d(x.repeat_interleave(2, dim=2), p["conv_w"], p["conv_b"])


def temporal_downsample(p: Dict, x: Tensor) -> Tensor:
    return causal_conv3d(x, p["conv_w"], p["conv_b"], stride=(2, 1, 1))


# ---------------------------------------------------------------------------
# decode / encode
# ---------------------------------------------------------------------------


def decode(params: Dict, cfg: Emu3VQConfig, ids: Tensor) -> Tensor:
    """Codebook ids [B, h, w] -> pixels [B, 8h, 8w, 3], frame 0 of the
    decoded clip."""
    B, h, w = ids.shape
    dt = params["decoder"]["conv_in_w"].dtype
    quant = params["codebook"][ids.long()].to(dt).permute(0, 3, 1, 2)[:, :, None]
    quant2 = causal_conv3d(quant, params["post_quant_conv_w"], params["post_quant_conv_b"])
    d = params["decoder"]
    # the temporal stack runs on z and zq stacked along the batch
    z_zq = torch.cat([quant2, quant], dim=0)
    for p in d["time_res_stack"]:
        z_zq = temporal_res_block(p, z_zq)
    for p in d["time_conv"]:
        z_zq = swish(temporal_upsample(p, z_zq))
    hzq, zq = z_zq[:B, :, 0], z_zq[B:, :, 0]  # frame 0
    x = conv2d(hzq, d["conv_in_w"], d["conv_in_b"])
    x = res_block_2d(d["mid_block1"], x, zq)
    x = attn_block_2d(d["mid_attn"], x, zq)
    x = res_block_2d(d["mid_block2"], x, zq)
    for level in d["up"]:  # lowest resolution first
        for j in range(cfg.num_res_blocks + 1):
            x = res_block_2d(level["res"][j], x, zq)
            if level.get("attn"):
                x = attn_block_2d(level["attn"][j], x, zq)
        if "upsample" in level:
            x = upsample(level["upsample"], x)
    x = spatial_norm(x, zq, d["norm_out"])
    x = conv2d(swish(x), d["conv_out_w"], d["conv_out_b"])
    return x.permute(0, 2, 3, 1)


def encode(params: Dict, cfg: Emu3VQConfig, pixels: Tensor) -> Tensor:
    """Pixels [B, H, W, 3] in [-1, 1] -> codebook ids [B, H/8, W/8] (frame 0;
    the still image is repeated temporal_downsample_factor times). The
    nearest entry in f32 by |z|^2 - 2 z.c + |c|^2, the first on a tie."""
    e = params["encoder"]
    x = pixels.to(e["conv_in_w"].dtype).permute(0, 3, 1, 2)
    hh = conv2d(x, e["conv_in_w"], e["conv_in_b"])
    for level in e["down"]:
        for j in range(cfg.num_res_blocks):
            hh = res_block_2d(level["res"][j], hh)
            if level.get("attn"):
                hh = attn_block_2d(level["attn"][j], hh)
        if "downsample" in level:
            hh = downsample(level["downsample"], hh)
    hh = res_block_2d(e["mid_block1"], hh)
    hh = attn_block_2d(e["mid_attn"], hh)
    hh = res_block_2d(e["mid_block2"], hh)
    hh = group_norm(hh, e["norm_out_scale"], e["norm_out_bias"])
    hh = conv2d(swish(hh), e["conv_out_w"], e["conv_out_b"])
    # every frame of the repeated clip is the same image
    hh = hh[:, :, None].expand(-1, -1, cfg.temporal_downsample_factor, -1, -1).contiguous()
    for p in e["time_conv"]:
        hh = swish(temporal_downsample(p, hh))
    for p in e["time_res_stack"]:
        hh = temporal_res_block(p, hh)
    z = causal_conv3d(hh, params["quant_conv_w"], params["quant_conv_b"])[:, :, 0]
    B, C, hs, ws = z.shape
    flat = z.permute(0, 2, 3, 1).reshape(-1, C).float()
    cb = params["codebook"].float()
    dist = (flat.pow(2).sum(1, keepdim=True) - 2 * flat @ cb.T + cb.pow(2).sum(1)[None])
    return torch.argmin(dist, dim=1).reshape(B, hs, ws).to(torch.int32)
