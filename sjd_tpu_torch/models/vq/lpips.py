"""LPIPS perceptual distance (VGG16 variant) for VQGAN training
(sjd_tpu/models/vq/lpips.py).

Inputs in [-1, 1] pass the fixed scaling layer and the five VGG16 feature
slices (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3); each slice's
channel-normalized feature difference is squared, weighted by a learned 1x1
"lin" layer, averaged over space, and the five are summed.

Weights:
  * the five lin vectors ship in the published taming ``vgg.pth``
    (:func:`port_lpips_lins`);
  * the VGG16 backbone comes from a torchvision ``vgg16`` state_dict
    (:func:`port_vgg16_features`).
Both are torch state dicts, so the convolution weights stay OIHW.
:func:`init_lpips_params` draws both at random: the loss is then an
untrained-feature distance (the shape of the training signal, not the
calibrated metric). The parameters are constants of the trainer: they get
no gradient. Activations run NCHW inside; :func:`lpips` and
:func:`vgg16_slices` keep the JAX layout (NHWC).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ... import resolve_device

Tensor = torch.Tensor

# VGG16 `features` conv plan: channels per conv, a 2x2 max pool before each
# slice but the first
VGG16_PLAN: List[List[int]] = [
    [64, 64],             # slice1 -> relu1_2
    [128, 128],           # slice2 -> relu2_2
    [256, 256, 256],      # slice3 -> relu3_3
    [512, 512, 512],      # slice4 -> relu4_3
    [512, 512, 512],      # slice5 -> relu5_3
]
# torchvision features indices of the 13 convs
_TV_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _generator(rng: Union[int, torch.Generator], dev: torch.device) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng))
    return gen


def init_lpips_params(rng: Union[int, torch.Generator] = 0, *, device=None) -> Dict:
    """Random VGG16 convolutions (N(0, 1) / sqrt(9 cin), OIHW, zero bias) and
    uniform lins (1 / C), from a seed or a ``torch.Generator``."""
    dev = resolve_device(device)
    gen = _generator(rng, dev)
    convs, cin = [], 3
    for slice_plan in VGG16_PLAN:
        for cout in slice_plan:
            w = torch.randn((cout, cin, 3, 3), generator=gen, device=dev) / math.sqrt(9 * cin)
            convs.append({"w": w, "b": torch.zeros((cout,), device=dev)})
            cin = cout
    lins = [torch.full((p[-1],), 1.0 / p[-1], device=dev) for p in VGG16_PLAN]
    return {"convs": convs, "lins": lins, "calibrated": False}


def _f32(x, dev) -> Tensor:
    t = x if isinstance(x, Tensor) else torch.from_numpy(np.asarray(x, np.float32))
    return t.to(device=dev, dtype=torch.float32)


def port_vgg16_features(state: Mapping[str, Any], *, device=None) -> List[Dict]:
    """torchvision vgg16 state_dict (``features.N.*`` keys, bare or in the
    whole model's dict) -> the 13 conv ``{w OIHW, b}`` dicts."""
    dev = resolve_device(device)
    return [{"w": _f32(state[f"features.{i}.weight"], dev),
             "b": _f32(state[f"features.{i}.bias"], dev)} for i in _TV_CONV_IDX]


def port_lpips_lins(state: Mapping[str, Any], *, device=None) -> List[Tensor]:
    """taming vgg.pth -> the five lin vectors ([1, C, 1, 1] -> [C])."""
    dev = resolve_device(device)
    return [_f32(state[f"lin{k}.model.1.weight"], dev).reshape(-1) for k in range(5)]


def port_lpips(lins_state: Mapping[str, Any], vgg_state: Optional[Mapping[str, Any]] = None,
               rng: Union[int, torch.Generator, None] = None, *, device=None) -> Dict:
    """LPIPS parameters from the two torch checkpoints; without
    ``vgg_state`` the backbone is random (``init_lpips_params(rng)``)."""
    if vgg_state is not None:
        convs, calibrated = port_vgg16_features(vgg_state, device=device), True
    else:
        convs = init_lpips_params(0 if rng is None else rng, device=device)["convs"]
        calibrated = False
    return {"convs": convs, "lins": port_lpips_lins(lins_state, device=device),
            "calibrated": calibrated}


def _slices(params: Dict, x: Tensor) -> List[Tensor]:
    """x [B, 3, H, W] (scaled) -> the five relu feature maps, NCHW."""
    feats, ci = [], 0
    for si, slice_plan in enumerate(VGG16_PLAN):
        if si > 0:
            x = F.max_pool2d(x, 2)
        for _ in slice_plan:
            c = params["convs"][ci]
            x = F.relu(F.conv2d(x, c["w"], c["b"], padding=1))
            ci += 1
        feats.append(x)
    return feats


def vgg16_slices(params: Dict, x: Tensor) -> List[Tensor]:
    """x [B, H, W, 3] (scaled) -> the five relu*_* feature maps, NHWC."""
    return [f.permute(0, 2, 3, 1) for f in _slices(params, x.permute(0, 3, 1, 2))]


def _normalize_ch(x: Tensor, eps: float = 1e-10) -> Tensor:
    """Over channels (dim 1), ``eps`` added to the norm, not under the root."""
    return x / (torch.sqrt((x ** 2).sum(dim=1, keepdim=True)) + eps)


def lpips(params: Dict, x: Tensor, y: Tensor) -> Tensor:
    """Perceptual distance per sample, [B]. x, y in [-1, 1], NHWC. Both go
    through VGG16 as one batch (no layer mixes samples)."""
    shift = torch.as_tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
    xy = torch.cat([x.float(), y.float()]).permute(0, 3, 1, 2)
    feats = _slices(params, (xy - shift) / scale)
    B = x.shape[0]
    total = torch.zeros((B,), device=x.device)
    for f, lin in zip(feats, params["lins"]):
        d = (_normalize_ch(f[:B]) - _normalize_ch(f[B:])) ** 2  # [B, C, h, w]
        total = total + (d * lin.view(1, -1, 1, 1)).sum(dim=1).mean(dim=(1, 2))
    return total
