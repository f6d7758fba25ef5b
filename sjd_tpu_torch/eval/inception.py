"""InceptionV3 pool3 features, the FID backbone (sjd_tpu/eval/inception.py).

:func:`port_inception_v3` folds each BasicConv2d's BatchNorm (eps 1e-3,
eval mode) into its conv and keeps the OIHW layout of ``F.conv2d``;
:func:`pool3_features` runs the trunk (Conv2d_1a .. Mixed_7c, then the
global average pool to 2048 features) in NCHW. The JAX package computes
these convolutions outside any Pallas kernel, so they are ``F.conv2d``
here.

``fid_pools=True`` gives pytorch_fid's two changes to torchvision's graph
(FIDInceptionA/C/E): the in-block 3x3 stride-1 average pools leave the
padding out of the count, and Mixed_7c's pool branch takes the maximum.
``fid_pools=False`` is torchvision's inception_v3.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

Tensor = torch.Tensor

_BN_EPS = 1e-3  # BasicConv2d's BatchNorm2d eps (torchvision inception.py)


def port_inception_v3(sd: Mapping[str, Any], device=None) -> Dict[str, dict]:
    """A torchvision or pytorch_fid InceptionV3 state dict -> {block name:
    {"w" OIHW, "b"}} in f32 with the BatchNorm folded in; the fc and
    AuxLogits weights are left out (pool3 comes before them)."""
    from ..utils.port import as_tensor

    dev = resolve_device(device)
    params: Dict[str, dict] = {}
    for key in sd:
        if not key.endswith(".conv.weight"):
            continue
        base = key[: -len(".conv.weight")]
        if base.startswith("AuxLogits"):
            continue
        f32 = lambda name: as_tensor(sd[f"{base}.{name}"]).to(torch.float32)  # noqa: E731
        w, g, b = f32("conv.weight"), f32("bn.weight"), f32("bn.bias")
        m, v = f32("bn.running_mean"), f32("bn.running_var")
        scale = g / torch.sqrt(v + _BN_EPS)
        params[base] = {"w": (w * scale[:, None, None, None]).to(dev),
                        "b": (b - m * scale).to(dev)}
    if "Conv2d_1a_3x3" not in params or "Mixed_7c.branch_pool" not in params:
        raise ValueError("the state dict does not look like an InceptionV3 checkpoint")
    return params


def _basic_convs() -> Dict[str, Tuple[int, int, Tuple[int, int]]]:
    """torchvision inception_v3's BasicConv2d layers: name -> (in channels,
    out channels, kernel), the trunk's and AuxLogits'."""
    convs = {"Conv2d_1a_3x3": (3, 32, (3, 3)), "Conv2d_2a_3x3": (32, 32, (3, 3)),
             "Conv2d_2b_3x3": (32, 64, (3, 3)), "Conv2d_3b_1x1": (64, 80, (1, 1)),
             "Conv2d_4a_3x3": (80, 192, (3, 3))}

    def block(base, layers):
        convs.update({f"{base}.{n}": (ci, co, k) for n, ci, co, k in layers})

    for base, cin, pool in (("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64), ("Mixed_5d", 288, 64)):
        block(base, [("branch1x1", cin, 64, (1, 1)), ("branch5x5_1", cin, 48, (1, 1)),
                     ("branch5x5_2", 48, 64, (5, 5)), ("branch3x3dbl_1", cin, 64, (1, 1)),
                     ("branch3x3dbl_2", 64, 96, (3, 3)), ("branch3x3dbl_3", 96, 96, (3, 3)),
                     ("branch_pool", cin, pool, (1, 1))])
    block("Mixed_6a", [("branch3x3", 288, 384, (3, 3)), ("branch3x3dbl_1", 288, 64, (1, 1)),
                       ("branch3x3dbl_2", 64, 96, (3, 3)), ("branch3x3dbl_3", 96, 96, (3, 3))])
    for base, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160), ("Mixed_6e", 192)):
        block(base, [("branch1x1", 768, 192, (1, 1)), ("branch7x7_1", 768, c7, (1, 1)),
                     ("branch7x7_2", c7, c7, (1, 7)), ("branch7x7_3", c7, 192, (7, 1)),
                     ("branch7x7dbl_1", 768, c7, (1, 1)), ("branch7x7dbl_2", c7, c7, (7, 1)),
                     ("branch7x7dbl_3", c7, c7, (1, 7)), ("branch7x7dbl_4", c7, c7, (7, 1)),
                     ("branch7x7dbl_5", c7, 192, (1, 7)), ("branch_pool", 768, 192, (1, 1))])
    block("AuxLogits", [("conv0", 768, 128, (1, 1)), ("conv1", 128, 768, (5, 5))])
    block("Mixed_7a", [("branch3x3_1", 768, 192, (1, 1)), ("branch3x3_2", 192, 320, (3, 3)),
                       ("branch7x7x3_1", 768, 192, (1, 1)), ("branch7x7x3_2", 192, 192, (1, 7)),
                       ("branch7x7x3_3", 192, 192, (7, 1)), ("branch7x7x3_4", 192, 192, (3, 3))])
    for base, cin in (("Mixed_7b", 1280), ("Mixed_7c", 2048)):
        block(base, [("branch1x1", cin, 320, (1, 1)), ("branch3x3_1", cin, 384, (1, 1)),
                     ("branch3x3_2a", 384, 384, (1, 3)), ("branch3x3_2b", 384, 384, (3, 1)),
                     ("branch3x3dbl_1", cin, 448, (1, 1)), ("branch3x3dbl_2", 448, 384, (3, 3)),
                     ("branch3x3dbl_3a", 384, 384, (1, 3)),
                     ("branch3x3dbl_3b", 384, 384, (3, 1)), ("branch_pool", cin, 192, (1, 1))])
    return convs


def synth_inception_state_dict(seed: int) -> Dict[str, np.ndarray]:
    """A seeded random InceptionV3 state dict with torchvision's names and
    shapes (numpy): He-scaled conv weights and BatchNorm statistics near
    the identity, so that activations stay finite through the trunk; the
    fc and AuxLogits heads included, as torchvision saves them."""
    rs = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}
    for name, (ci, co, (kh, kw)) in _basic_convs().items():
        fan_in = ci * kh * kw
        sd[f"{name}.conv.weight"] = (rs.randn(co, ci, kh, kw)
                                     * np.sqrt(2.0 / fan_in)).astype(np.float32)
        sd[f"{name}.bn.weight"] = rs.uniform(0.5, 1.5, co).astype(np.float32)
        sd[f"{name}.bn.bias"] = (0.1 * rs.randn(co)).astype(np.float32)
        sd[f"{name}.bn.running_mean"] = (0.1 * rs.randn(co)).astype(np.float32)
        sd[f"{name}.bn.running_var"] = rs.uniform(0.5, 1.5, co).astype(np.float32)
        sd[f"{name}.bn.num_batches_tracked"] = np.zeros((), np.int64)
    for head, cin in (("AuxLogits.fc", 768), ("fc", 2048)):
        sd[f"{head}.weight"] = (rs.randn(1000, cin) * np.sqrt(1.0 / cin)).astype(np.float32)
        sd[f"{head}.bias"] = np.zeros(1000, np.float32)
    return sd


def _conv(params, name, x, stride=1, pad=(0, 0)):
    p = params[name]
    return F.relu(F.conv2d(x, p["w"], p["b"], stride=stride, padding=pad))


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)


def _avg_pool_3x3_s1(x, count_include_pad: bool):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=count_include_pad)


def _inception_a(params, base, x, fid: bool):
    c = lambda n, xx, **kw: _conv(params, f"{base}.{n}", xx, **kw)  # noqa: E731
    b1 = c("branch1x1", x)
    b5 = c("branch5x5_2", c("branch5x5_1", x), pad=(2, 2))
    bd = c("branch3x3dbl_3",
           c("branch3x3dbl_2", c("branch3x3dbl_1", x), pad=(1, 1)),
           pad=(1, 1))
    bp = c("branch_pool", _avg_pool_3x3_s1(x, count_include_pad=not fid))
    return torch.cat([b1, b5, bd, bp], dim=1)


def _inception_b(params, base, x):
    c = lambda n, xx, **kw: _conv(params, f"{base}.{n}", xx, **kw)  # noqa: E731
    b3 = c("branch3x3", x, stride=2)
    bd = c("branch3x3dbl_3",
           c("branch3x3dbl_2", c("branch3x3dbl_1", x), pad=(1, 1)),
           stride=2)
    return torch.cat([b3, bd, _max_pool(x)], dim=1)


def _inception_c(params, base, x, fid: bool):
    c = lambda n, xx, **kw: _conv(params, f"{base}.{n}", xx, **kw)  # noqa: E731
    b1 = c("branch1x1", x)
    b7 = c("branch7x7_3", c("branch7x7_2", c("branch7x7_1", x), pad=(0, 3)),
           pad=(3, 0))
    bd = c("branch7x7dbl_5",
           c("branch7x7dbl_4",
             c("branch7x7dbl_3",
               c("branch7x7dbl_2", c("branch7x7dbl_1", x), pad=(3, 0)),
               pad=(0, 3)),
             pad=(3, 0)),
           pad=(0, 3))
    bp = c("branch_pool", _avg_pool_3x3_s1(x, count_include_pad=not fid))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(params, base, x):
    c = lambda n, xx, **kw: _conv(params, f"{base}.{n}", xx, **kw)  # noqa: E731
    b3 = c("branch3x3_2", c("branch3x3_1", x), stride=2)
    b7 = c("branch7x7x3_4",
           c("branch7x7x3_3",
             c("branch7x7x3_2", c("branch7x7x3_1", x), pad=(0, 3)),
             pad=(3, 0)),
           stride=2)
    return torch.cat([b3, b7, _max_pool(x)], dim=1)


def _inception_e(params, base, x, fid: bool, fid_max_pool: bool):
    c = lambda n, xx, **kw: _conv(params, f"{base}.{n}", xx, **kw)  # noqa: E731
    b1 = c("branch1x1", x)
    b3 = c("branch3x3_1", x)
    b3 = torch.cat([c("branch3x3_2a", b3, pad=(0, 1)), c("branch3x3_2b", b3, pad=(1, 0))],
                   dim=1)
    bd = c("branch3x3dbl_2", c("branch3x3dbl_1", x), pad=(1, 1))
    bd = torch.cat([c("branch3x3dbl_3a", bd, pad=(0, 1)), c("branch3x3dbl_3b", bd, pad=(1, 0))],
                   dim=1)
    if fid and fid_max_pool:
        pooled = F.max_pool2d(x, 3, stride=1, padding=1)  # FIDInceptionE_2 (Mixed_7c)
    else:
        pooled = _avg_pool_3x3_s1(x, count_include_pad=not fid)
    bp = c("branch_pool", pooled)
    return torch.cat([b1, b3, bd, bp], dim=1)


def trunk(params: Dict[str, dict], images: Tensor, *,
          fid_pools: bool = True) -> Iterator[Tuple[str, Tensor]]:
    """Each stage's output [N, C, H, W] in order, under torchvision's names
    (Conv2d_1a_3x3 .. Mixed_7c), from ``images`` [N, H, W, 3] in [0, 1]
    scaled to [-1, 1] as pytorch_fid does."""
    x = images.to(torch.float32).permute(0, 3, 1, 2) * 2.0 - 1.0
    x = _conv(params, "Conv2d_1a_3x3", x, stride=2)
    yield "Conv2d_1a_3x3", x
    x = _conv(params, "Conv2d_2a_3x3", x)
    yield "Conv2d_2a_3x3", x
    x = _conv(params, "Conv2d_2b_3x3", x, pad=(1, 1))
    yield "Conv2d_2b_3x3", x
    x = _conv(params, "Conv2d_3b_1x1", _max_pool(x))
    yield "Conv2d_3b_1x1", x
    x = _conv(params, "Conv2d_4a_3x3", x)
    yield "Conv2d_4a_3x3", x
    x = _max_pool(x)
    for blk in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        x = _inception_a(params, blk, x, fid_pools)
        yield blk, x
    x = _inception_b(params, "Mixed_6a", x)
    yield "Mixed_6a", x
    for blk in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        x = _inception_c(params, blk, x, fid_pools)
        yield blk, x
    x = _inception_d(params, "Mixed_7a", x)
    yield "Mixed_7a", x
    x = _inception_e(params, "Mixed_7b", x, fid_pools, fid_max_pool=False)
    yield "Mixed_7b", x
    x = _inception_e(params, "Mixed_7c", x, fid_pools, fid_max_pool=True)
    yield "Mixed_7c", x


def pool3_features(
    params: Dict[str, dict],
    images: Tensor,  # [N, H, W, 3] in [0, 1]
    *,
    fid_pools: bool = True,
) -> Tensor:
    """The whole trunk, then the global average pool -> [N, 2048] f32. The
    images should be 299 x 299 (the caller resizes; any side of at least
    75 runs)."""
    for _, x in trunk(params, images, fid_pools=fid_pools):
        pass
    return x.mean(dim=(2, 3))


def make_inception_extractor_from_ckpt(path: str, *, fid_pools: bool = True,
                                       batch: int = 16, device=None):
    """A torch checkpoint file -> ``extract(images [N, H, W, 3] in [0, 1])``
    -> [N, 2048] numpy: each batch goes to the device, is resized to 299
    (bilinear, as pytorch_fid) and runs through the trunk there."""
    from ..utils.image_io import resize_bilinear
    from ..utils.port import load_torch_checkpoint

    dev = resolve_device(device)
    params = port_inception_v3(load_torch_checkpoint(path), device=dev)

    def extract(images: np.ndarray) -> np.ndarray:
        out = []
        with torch.no_grad():
            for i in range(0, len(images), batch):
                x = torch.as_tensor(np.asarray(images[i : i + batch], np.float32), device=dev)
                if x.shape[1] != 299 or x.shape[2] != 299:
                    x = resize_bilinear(x, (299, 299))
                out.append(pool3_features(params, x, fid_pools=fid_pools).cpu().numpy())
        return np.concatenate(out)

    return extract
