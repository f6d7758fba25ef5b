"""StyleGAN2-style discriminator, the reference's second GAN option
(sjd_tpu/models/vq/discriminator_stylegan.py).

A 3x3 stem at full resolution; residual blocks halving the grid from
``image_size`` to 4x4 (residual path: a 1x1 stride-2 convolution; main
path: two 3x3 convolutions, the blur, a 3x3 stride-2 convolution; the sum
scaled by 1/sqrt(2)); a 3x3 final convolution and a 2-layer MLP on the
flattened 4x4 map, one logit per image. The blur is kornia's ``filter2d``
with the normalized [1, 2, 1] outer product and reflect padding, as a
depthwise convolution. Convolution weights are OIHW, linear weights
[out, in]; activations are NCHW, so the flatten needs no transpose.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Union

import torch
import torch.nn.functional as F

from ... import resolve_device
from .lpips import _generator

Tensor = torch.Tensor

_CHANNELS = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128,
             256: 64, 512: 32, 1024: 16}


@dataclasses.dataclass(frozen=True)
class StyleGANDiscConfig:
    input_nc: int = 3
    image_size: int = 256
    channel_multiplier: int = 1

    def channels(self, res: int) -> int:
        c = _CHANNELS[res]
        return c * self.channel_multiplier if res >= 64 else c


def init_stylegan_disc_params(rng: Union[int, torch.Generator] = 0,
                              cfg: StyleGANDiscConfig = StyleGANDiscConfig(), *,
                              device=None) -> Dict:
    """torch's default init: U(+-1/sqrt(fan_in)) weights, zero biases."""
    dev = resolve_device(device)
    gen = _generator(rng, dev)

    def uniform(shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        return torch.rand(shape, generator=gen, device=dev) * (2 * bound) - bound

    def conv(cin, cout, k):
        return {"w": uniform((cout, cin, k, k), cin * k * k),
                "b": torch.zeros((cout,), device=dev)}

    log_size = int(math.log2(cfg.image_size))
    cin = cfg.channels(cfg.image_size)
    params: Dict = {"stem": conv(cfg.input_nc, cin, 3), "blocks": []}
    for i in range(log_size, 2, -1):
        cout = cfg.channels(2 ** (i - 1))
        params["blocks"].append({"res": conv(cin, cout, 1), "net1": conv(cin, cout, 3),
                                 "net2": conv(cout, cout, 3), "down": conv(cout, cout, 3)})
        cin = cout
    c4 = cfg.channels(4)
    params["final_conv"] = conv(cin, c4, 3)
    params["fc1"] = {"w": uniform((c4, c4 * 16), c4 * 16), "b": torch.zeros((c4,), device=dev)}
    params["fc2"] = {"w": uniform((1, c4), c4), "b": torch.zeros((1,), device=dev)}
    return params


def _conv(x: Tensor, p: Dict, stride: int = 1) -> Tensor:
    """torch padding: 1 for the 3x3 convolutions, none for the 1x1."""
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=p["w"].shape[-1] // 2)


def _blur(x: Tensor) -> Tensor:
    """The normalized [1, 2, 1] outer product, depthwise, reflect padding."""
    f = torch.tensor([1.0, 2.0, 1.0], device=x.device)
    k = (f[:, None] * f[None, :]) / 16.0
    C = x.shape[1]
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), k.expand(C, 1, 3, 3), groups=C)


def stylegan_disc_logits(params: Dict, pixels: Tensor,
                         cfg: StyleGANDiscConfig = StyleGANDiscConfig()) -> Tensor:
    """pixels [B, image_size, image_size, C] in [-1, 1] -> logits [B, 1]."""
    x = F.leaky_relu(_conv(pixels.float().permute(0, 3, 1, 2), params["stem"]), 0.2)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for blk in params["blocks"]:
        res = _conv(x, blk["res"], stride=2)
        h = F.leaky_relu(_conv(x, blk["net1"]), 0.2)
        h = F.leaky_relu(_conv(h, blk["net2"]), 0.2)
        h = _conv(_blur(h), blk["down"], stride=2)
        x = (h + res) * inv_sqrt2
    x = F.leaky_relu(_conv(x, params["final_conv"]), 0.2).flatten(1)  # NCHW order
    x = F.leaky_relu(F.linear(x, params["fc1"]["w"], params["fc1"]["b"]), 0.2)
    return F.linear(x, params["fc2"]["w"], params["fc2"]["b"])
