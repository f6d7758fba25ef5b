"""PatchGAN discriminator for VQGAN adversarial training
(sjd_tpu/models/vq/discriminator.py; the Pix2Pix/taming NLayerDiscriminator).

4x4 convolutions with padding 1, stride 2 in every block but the last;
batch norm on the batch's own statistics (biased variance, no running
state: the discriminator only runs inside the training step) and
LeakyReLU(0.2); a 1-channel logit map head. Weights are drawn as the
reference's ``_init_weights``: conv N(0, 0.02), BN gamma N(1, 0.02), beta 0.
Convolution weights are OIHW; the public function keeps the JAX layout
(NHWC pixels in, an NHWC patch map out).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Union

import torch
import torch.nn.functional as F

from ... import resolve_device
from .lpips import _generator

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PatchGANConfig:
    input_nc: int = 3
    ndf: int = 64
    n_layers: int = 3


def init_patchgan_params(rng: Union[int, torch.Generator] = 0,
                         cfg: PatchGANConfig = PatchGANConfig(), *, device=None) -> Dict:
    dev = resolve_device(device)
    gen = _generator(rng, dev)

    def conv(cin, cout):
        return torch.randn((cout, cin, 4, 4), generator=gen, device=dev) * 0.02

    params: Dict = {"conv0_w": conv(cfg.input_nc, cfg.ndf),
                    "conv0_b": torch.zeros((cfg.ndf,), device=dev)}
    blocks: List[Dict] = []
    nf_mult = 1
    for n in range(1, cfg.n_layers + 1):  # stride-2 blocks, then one stride-1
        nf_prev, nf_mult = nf_mult, min(2 ** n, 8)
        cout = cfg.ndf * nf_mult
        blocks.append({
            # no conv bias: batch norm's beta makes it redundant
            "w": conv(cfg.ndf * nf_prev, cout),
            "gamma": 1.0 + torch.randn((cout,), generator=gen, device=dev) * 0.02,
            "beta": torch.zeros((cout,), device=dev),
        })
    params["blocks"] = blocks
    params["final_w"] = conv(cfg.ndf * nf_mult, 1)
    params["final_b"] = torch.zeros((1,), device=dev)
    return params


def patch_hw(side: int, n_blocks: int) -> int:
    """The patch map's side for an input side: each 4x4 padding-1
    convolution maps s to (s - 2) // stride + 1."""
    s = (side - 2) // 2 + 1
    for i in range(n_blocks):
        s = (s - 2) // (2 if i < n_blocks - 1 else 1) + 1
    return s - 1


def patchgan_logits(params: Dict, pixels: Tensor,
                    cfg: PatchGANConfig = PatchGANConfig()) -> Tensor:
    """pixels [B, H, W, C] in [-1, 1] -> patch logit map [B, h, w, 1]. A stack
    too deep for the image (an empty map, whose mean would be NaN even
    through the ``disc_start`` gate) raises."""
    n_blocks = len(params["blocks"])
    if min(patch_hw(pixels.shape[1], n_blocks), patch_hw(pixels.shape[2], n_blocks)) <= 0:
        raise ValueError(f"PatchGAN patch map is empty for input {tuple(pixels.shape)} at "
                         f"n_layers={n_blocks}; reduce n_layers or use a larger image")
    x = pixels.float().permute(0, 3, 1, 2)
    x = F.leaky_relu(F.conv2d(x, params["conv0_w"], params["conv0_b"], stride=2, padding=1), 0.2)
    for i, blk in enumerate(params["blocks"]):
        x = F.conv2d(x, blk["w"], stride=2 if i < n_blocks - 1 else 1, padding=1)
        x = F.batch_norm(x, None, None, blk["gamma"], blk["beta"], training=True, eps=1e-5)
        x = F.leaky_relu(x, 0.2)
    out = F.conv2d(x, params["final_w"], params["final_b"], padding=1)
    return out.permute(0, 2, 3, 1)
