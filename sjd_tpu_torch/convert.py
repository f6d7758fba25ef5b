"""Carry the JAX package's parameters and configurations over to the port.

The JAX side hands over numpy arrays (``jax.tree.map(np.asarray, params)``)
and its config dataclasses; nothing here imports JAX or ``sjd_tpu``.

  * Decoder weights keep the stacked ``[NL, out, in]`` layout, which is
    already torch's ``F.linear`` layout.
  * bf16 arrays (ml_dtypes) go through float32 before ``torch.bfloat16``,
    because ``torch.from_numpy`` refuses them; the values are unchanged.
  * VQ convolution weights are HWIO in JAX and become OIHW.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import resolve_device
from .models.transformer import DecoderConfig
from .models.vq.taming import VQConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(dtype) -> torch.dtype:
    """A numpy / ml_dtypes / jnp dtype (or its type) -> the torch dtype."""
    return _DTYPES[np.dtype(dtype).name]


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _tree(x: Any, leaf):
    if isinstance(x, dict):
        return {k: _tree(v, leaf) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, leaf) for v in x]
    return leaf(x)


def decoder_config_from_jax(jcfg, **overrides) -> DecoderConfig:
    """The port's DecoderConfig with the fields of a sjd_tpu DecoderConfig."""
    names = {f.name for f in dataclasses.fields(DecoderConfig)}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
          if f.name in names and f.name not in ("dtype", "attn_impl")}
    kw["dtype"] = torch_dtype(jcfg.dtype)
    kw.update(overrides)
    return DecoderConfig(**kw)


def vq_config_from_jax(jcfg) -> VQConfig:
    names = {f.name for f in dataclasses.fields(VQConfig)}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
          if f.name in names and f.name != "dtype"}
    return VQConfig(dtype=torch_dtype(jcfg.dtype), **kw)


def params_from_jax(np_tree: dict, cfg: DecoderConfig, device=None) -> dict:
    """sjd_tpu decoder params (numpy leaves) -> the port's params."""
    dev = resolve_device(device)
    params = _tree(np_tree, lambda a: tensor_from_numpy(a, dev))
    n, d = cfg.num_layers, cfg.hidden_size
    if tuple(params["embed"].shape) != (cfg.vocab_size, d):
        raise ValueError(f"embed is {tuple(params['embed'].shape)}, config "
                         f"wants {(cfg.vocab_size, d)}")
    for name, t in params["layers"].items():
        if t.shape[0] != n:
            raise ValueError(f"layers/{name} stacks {t.shape[0]} layers, config has {n}")
    return params


def vq_params_from_jax(np_tree: dict, cfg: VQConfig, device=None) -> dict:
    """sjd_tpu taming VQ params (numpy leaves) -> the port's decoder-side
    params, conv weights HWIO -> OIHW."""
    dev = resolve_device(device)

    def leaf(a):
        t = tensor_from_numpy(a, dev)
        return t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t

    keep = ("decoder", "codebook", "post_quant_conv_w", "post_quant_conv_b")
    params = {k: _tree(np_tree[k], leaf) for k in keep}
    if tuple(params["codebook"].shape) != (cfg.n_embed, cfg.embed_dim):
        raise ValueError(f"codebook is {tuple(params['codebook'].shape)}, config "
                         f"wants {(cfg.n_embed, cfg.embed_dim)}")
    return params
