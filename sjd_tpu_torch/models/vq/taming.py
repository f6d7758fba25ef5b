"""Taming-style VQGAN (sjd_tpu/models/vq/taming.py): the decoder (token
ids -> pixels) and the encoder (pixels -> token ids, for image-conditioned
prompts).

Parameters keep the JAX package's tree and names; convolution weights are
OIHW here (HWIO there; ``convert.vq_params_from_jax`` transposes them, and
torch checkpoints are OIHW already). Activations run NCHW inside; the
public :func:`encode` and :func:`decode` keep the JAX layout ([B, H, W, 3]
pixels in [-1, 1]). The convolutions are ``F.conv2d``, as the JAX package
leaves them to XLA: neither half has a kernel of its own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple, Union

import torch
import torch.nn.functional as F

from ... import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class VQConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    resolution: int = 512
    attn_resolutions: Tuple[int, ...] = ()
    z_channels: int = 256
    embed_dim: int = 256
    n_embed: int = 8192
    in_channels: int = 3
    out_ch: int = 3
    l2_norm_codebook: bool = False
    dtype: torch.dtype = torch.float32

    @property
    def num_resolutions(self) -> int:
        return len(self.ch_mult)

    @property
    def downsample_factor(self) -> int:
        return 2 ** (self.num_resolutions - 1)

    def has_attn(self, i_level: int) -> bool:
        if not self.attn_resolutions:
            return i_level == self.num_resolutions - 1
        return (self.resolution // (2**i_level)) in self.attn_resolutions


CHAMELEON_VQ = VQConfig(n_embed=8192, embed_dim=256)
# LlamaGen's VQ-16 and VQ-8: 16384 codes of 8 dims, L2-normalised
LLAMAGEN_VQ16 = VQConfig(n_embed=16384, embed_dim=8, l2_norm_codebook=True)
LLAMAGEN_VQ8 = VQConfig(ch_mult=(1, 2, 2, 4), n_embed=16384, embed_dim=8,
                        l2_norm_codebook=True)


# ---------------------------------------------------------------------------
# primitives (NCHW)
# ---------------------------------------------------------------------------


def conv2d(x: Tensor, w: Tensor, b: Tensor, *, stride: int = 1) -> Tensor:
    """'SAME' convolution for odd kernels, w in OIHW."""
    return F.conv2d(x, w, b, stride=stride, padding=w.shape[-1] // 2)


def group_norm(x: Tensor, scale: Tensor, bias: Tensor, groups: int = 32,
               eps: float = 1e-6) -> Tensor:
    B, C, H, W = x.shape
    xf = x.float().reshape(B, groups, C // groups, H, W)
    mean = xf.mean(dim=(2, 3, 4), keepdim=True)
    var = xf.var(dim=(2, 3, 4), unbiased=False, keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, C, H, W)
    return (xf * scale.float()[None, :, None, None]
            + bias.float()[None, :, None, None]).to(x.dtype)


def swish(x: Tensor) -> Tensor:
    return x * torch.sigmoid(x.float()).to(x.dtype)


def resnet_block(p: Dict, x: Tensor) -> Tensor:
    h = group_norm(x, p["norm1_scale"], p["norm1_bias"])
    h = conv2d(swish(h), p["conv1_w"], p["conv1_b"])
    h = group_norm(h, p["norm2_scale"], p["norm2_bias"])
    h = conv2d(swish(h), p["conv2_w"], p["conv2_b"])
    if "nin_w" in p:
        x = conv2d(x, p["nin_w"], p["nin_b"])
    return x + h


def attn_block(p: Dict, x: Tensor) -> Tensor:
    B, C, H, W = x.shape
    h = group_norm(x, p["norm_scale"], p["norm_bias"])

    def tokens(t):  # [B, C, H, W] -> [B, H*W, C]
        return t.permute(0, 2, 3, 1).reshape(B, H * W, C)

    q = tokens(conv2d(h, p["q_w"], p["q_b"]))
    k = tokens(conv2d(h, p["k_w"], p["k_b"]))
    v = tokens(conv2d(h, p["v_w"], p["v_b"]))
    scores = torch.einsum("bqc,bkc->bqk", q.float(), k.float())
    probs = torch.softmax(scores / math.sqrt(C), dim=-1)
    out = torch.einsum("bqk,bkc->bqc", probs.to(v.dtype), v)
    out = out.reshape(B, H, W, C).permute(0, 3, 1, 2)
    return x + conv2d(out, p["proj_w"], p["proj_b"])


def downsample(p: Dict, x: Tensor) -> Tensor:
    """Asymmetric (0, 1, 0, 1) pad, then a stride-2 unpadded convolution."""
    return F.conv2d(F.pad(x, (0, 1, 0, 1)), p["conv_w"], p["conv_b"], stride=2)


def upsample(p: Dict, x: Tensor) -> Tensor:
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return conv2d(x, p["conv_w"], p["conv_b"])


def codebook_lookup(cfg: VQConfig, codebook: Tensor, ids: Tensor,
                    grid_hw: Tuple[int, int]) -> Tensor:
    """Codebook ids [B, h*w] (already translated from LM ids) -> latents
    [B, h, w, embed_dim]. Out-of-range ids raise (torch indexing checks)."""
    cb = codebook
    if cfg.l2_norm_codebook:
        cb = cb / cb.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    h, w = grid_hw
    return cb[ids.long()].reshape(ids.shape[0], h, w, cfg.embed_dim)


def codebook_encode(cfg: VQConfig, codebook: Tensor, z: Tensor) -> Tensor:
    """Nearest codebook entry of each latent of z [B, h, w, embed_dim], in
    f32: ids [B, h*w] (int32), the first index on a tie. Distances are
    |z|^2 - 2 z.c + |c|^2, as the JAX package computes them."""
    cb = codebook.float()
    zf = z.float()
    if cfg.l2_norm_codebook:
        cb = cb / cb.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        zf = zf / zf.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    flat = zf.reshape(-1, cfg.embed_dim)
    d = ((flat ** 2).sum(1, keepdim=True) - 2 * flat @ cb.t()
         + (cb ** 2).sum(1)[None, :])
    return torch.argmin(d, dim=1).to(torch.int32).reshape(z.shape[0], -1)


def encode_latents(params: Dict, cfg: VQConfig, pixels: Tensor) -> Tensor:
    """pixels [B, H, W, 3] (in [-1, 1]) -> pre-quantization latents
    [B, H/f, W/f, embed_dim]."""
    e = params["encoder"]
    h = conv2d(pixels.to(cfg.dtype).permute(0, 3, 1, 2), e["conv_in_w"], e["conv_in_b"])
    for level in e["down"]:
        for j in range(cfg.num_res_blocks):
            h = resnet_block(level["res"][j], h)
            if level.get("attn"):
                h = attn_block(level["attn"][j], h)
        if "downsample" in level:
            h = downsample(level["downsample"], h)
    h = resnet_block(e["mid_block1"], h)
    h = attn_block(e["mid_attn"], h)
    h = resnet_block(e["mid_block2"], h)
    h = group_norm(h, e["norm_out_scale"], e["norm_out_bias"])
    h = conv2d(swish(h), e["conv_out_w"], e["conv_out_b"])
    z = conv2d(h, params["quant_conv_w"], params["quant_conv_b"])
    return z.permute(0, 2, 3, 1)


def encode(params: Dict, cfg: VQConfig, pixels: Tensor) -> Tensor:
    """pixels [B, H, W, 3] (in [-1, 1]) -> codebook ids [B, (H/f)*(W/f)]."""
    return codebook_encode(cfg, params["codebook"], encode_latents(params, cfg, pixels))


def decode_latents(params: Dict, cfg: VQConfig, z: Tensor) -> Tensor:
    """Latents [B, h, w, embed_dim] -> pixels [B, h*f, w*f, 3] in [-1, 1]
    (the VQ trainer decodes its straight-through latents here)."""
    z = z.to(cfg.dtype).permute(0, 3, 1, 2)
    z = conv2d(z, params["post_quant_conv_w"], params["post_quant_conv_b"])
    d = params["decoder"]
    h = conv2d(z, d["conv_in_w"], d["conv_in_b"])
    h = resnet_block(d["mid_block1"], h)
    h = attn_block(d["mid_attn"], h)
    h = resnet_block(d["mid_block2"], h)
    for level in d["up"]:  # lowest resolution first
        for j in range(cfg.num_res_blocks + 1):
            h = resnet_block(level["res"][j], h)
            if level.get("attn"):
                h = attn_block(level["attn"][j], h)
        if "upsample" in level:
            h = upsample(level["upsample"], h)
    h = group_norm(h, d["norm_out_scale"], d["norm_out_bias"])
    h = conv2d(swish(h), d["conv_out_w"], d["conv_out_b"])
    return h.permute(0, 2, 3, 1)


def decode(params: Dict, cfg: VQConfig, ids: Tensor,
           grid_hw: Tuple[int, int]) -> Tensor:
    """Token ids [B, h*w] -> pixels [B, h*f, w*f, 3] in [-1, 1]."""
    return decode_latents(params, cfg, codebook_lookup(cfg, params["codebook"], ids, grid_hw))


# ---------------------------------------------------------------------------
# init (random weights)
# ---------------------------------------------------------------------------


def init_vq_params(rng: Union[int, torch.Generator], cfg: VQConfig, *,
                   device=None) -> Dict:
    """Random parameters with the JAX package's tree, shapes and scales
    (conv weights U(-1/sqrt(fan_in), +)), OIHW, from a ``torch.Generator``:
    the decoder half first, then the encoder half."""
    dev = resolve_device(device)
    if isinstance(rng, torch.Generator):
        gen = rng
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(rng))
    dt = cfg.dtype

    def uniform(shape, bound, dtype=dt):
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=dev)
        return (u * (2 * bound) - bound).to(dtype)

    def conv(k, cin, cout):
        return uniform((cout, cin, k, k), 1.0 / math.sqrt(k * k * cin))

    def zeros(c):
        return torch.zeros((c,), dtype=dt, device=dev)

    def ones(c):
        return torch.ones((c,), dtype=dt, device=dev)

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

    top = cfg.ch * cfg.ch_mult[-1]
    up = []
    block_in = top
    for i in reversed(range(cfg.num_resolutions)):
        cout = cfg.ch * cfg.ch_mult[i]
        level: Dict = {"res": [res(block_in if j == 0 else cout, cout)
                               for j in range(cfg.num_res_blocks + 1)]}
        if cfg.has_attn(i):
            level["attn"] = [attn(cout) for _ in range(cfg.num_res_blocks + 1)]
        if i != 0:
            level["upsample"] = {"conv_w": conv(3, cout, cout), "conv_b": zeros(cout)}
        up.append(level)
        block_in = cout
    decoder = {
        "conv_in_w": conv(3, cfg.z_channels, top), "conv_in_b": zeros(top),
        "mid_block1": res(top, top), "mid_attn": attn(top), "mid_block2": res(top, top),
        "up": up,
        "norm_out_scale": ones(block_in), "norm_out_bias": zeros(block_in),
        "conv_out_w": conv(3, block_in, cfg.out_ch), "conv_out_b": zeros(cfg.out_ch),
    }
    params = {
        "decoder": decoder,
        "codebook": uniform((cfg.n_embed, cfg.embed_dim), 1.0 / cfg.n_embed,
                            torch.float32),
        "post_quant_conv_w": conv(1, cfg.embed_dim, cfg.z_channels),
        "post_quant_conv_b": zeros(cfg.z_channels),
    }
    # the encoder half, drawn after the decoder half
    down = []
    in_mult = (1,) + tuple(cfg.ch_mult)
    for i in range(cfg.num_resolutions):
        cin, cout = cfg.ch * in_mult[i], cfg.ch * cfg.ch_mult[i]
        level = {"res": [res(cin if j == 0 else cout, cout)
                         for j in range(cfg.num_res_blocks)]}
        if cfg.has_attn(i):
            level["attn"] = [attn(cout) for _ in range(cfg.num_res_blocks)]
        if i != cfg.num_resolutions - 1:
            level["downsample"] = {"conv_w": conv(3, cout, cout), "conv_b": zeros(cout)}
        down.append(level)
    params["encoder"] = {
        "conv_in_w": conv(3, cfg.in_channels, cfg.ch), "conv_in_b": zeros(cfg.ch),
        "down": down,
        "mid_block1": res(top, top), "mid_attn": attn(top), "mid_block2": res(top, top),
        "norm_out_scale": ones(top), "norm_out_bias": zeros(top),
        "conv_out_w": conv(3, top, cfg.z_channels), "conv_out_b": zeros(cfg.z_channels),
    }
    params["quant_conv_w"] = conv(1, cfg.z_channels, cfg.embed_dim)
    params["quant_conv_b"] = zeros(cfg.embed_dim)
    return params
