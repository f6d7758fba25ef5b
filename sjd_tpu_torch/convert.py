"""Carry the JAX package's parameters and configurations over to the port.

The JAX side hands over numpy arrays (``jax.tree.map(np.asarray, params)``)
and its config dataclasses; nothing here imports JAX or ``sjd_tpu``.

  * Decoder weights keep the stacked ``[NL, out, in]`` layout, which is
    already torch's ``F.linear`` layout.
  * bf16 arrays (ml_dtypes) go through float32 before ``torch.bfloat16``,
    because ``torch.from_numpy`` refuses them; the values are unchanged.
  * VQ convolution weights are HWIO in JAX and become OIHW; the Emu3 VQ's
    3-D ones are DHWIO and become OIDHW.
  * LlamaGen's conditioning embedders and the T5 encoder keep their trees
    (``fc1``/``fc2`` are [in, out] in both, T5's projections [out, in]).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import resolve_device
from .models.t5 import T5EncoderConfig
from .models.transformer import DecoderConfig
from .models.vq.emu3_vq import Emu3VQConfig
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
    """The port's DecoderConfig with the fields of a sjd_tpu DecoderConfig.
    A field the port lacks must hold the JAX default, or this raises: its
    value would be dropped, and the port would compute something else.
    ``attn_impl`` names TPU paths and is not carried over."""
    names = {f.name for f in dataclasses.fields(DecoderConfig)}
    dropped = [f.name for f in dataclasses.fields(jcfg)
               if f.name not in names and getattr(jcfg, f.name) != f.default]
    if dropped:
        raise ValueError(f"the port's DecoderConfig has no field for {dropped}, whose values "
                         "differ from the JAX defaults")
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
          if f.name in names and f.name not in ("dtype", "attn_impl")}
    kw["dtype"] = torch_dtype(jcfg.dtype)
    kw.update(overrides)
    return DecoderConfig(**kw)


def cond_params_from_jax(np_tree: dict, device=None) -> dict:
    """sjd_tpu LlamaGen conditioning params (``init_cond_params``, numpy
    leaves) -> the port's: the ``kind`` string as it is, f32 tensors."""
    dev = resolve_device(device)
    return {k: v if k == "kind" else tensor_from_numpy(v, dev) for k, v in np_tree.items()}


def t5_config_from_jax(jcfg) -> T5EncoderConfig:
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    return T5EncoderConfig(dtype=torch_dtype(jcfg.dtype), **kw)


def t5_params_from_jax(np_tree: dict, cfg: T5EncoderConfig, device=None) -> dict:
    """sjd_tpu T5 encoder params (``init_t5_params`` or ``port_t5_encoder``,
    numpy leaves) -> the port's: the same tree and [out, in] layout."""
    dev = resolve_device(device)
    params = {k: tensor_from_numpy(v, dev) for k, v in np_tree.items()}
    n, d = cfg.num_layers, cfg.d_model
    if tuple(params["embed"].shape) != (cfg.vocab_size, d) or params["wq"].shape[0] != n:
        raise ValueError(f"the T5 tree (embed {tuple(params['embed'].shape)}, "
                         f"{params['wq'].shape[0]} layers) does not match {cfg}")
    return params


def _vq_config(cls, jcfg):
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
          if f.name in names and f.name != "dtype"}
    return cls(dtype=torch_dtype(jcfg.dtype), **kw)


def vq_config_from_jax(jcfg) -> VQConfig:
    return _vq_config(VQConfig, jcfg)


def emu3_vq_config_from_jax(jcfg) -> Emu3VQConfig:
    return _vq_config(Emu3VQConfig, jcfg)


def _pack_int4(q: np.ndarray) -> np.ndarray:
    """int4 codes [..., K] -> split-half packed uint8 [..., K/2] (the JAX
    package's quantize_weights layout)."""
    q = q.astype(np.int8)
    K = q.shape[-1]
    lo, hi = q[..., : K // 2], q[..., K // 2:]
    return ((lo & 0xF).astype(np.uint8) | (hi.astype(np.uint8) << np.uint8(4))).astype(np.uint8)


def _quant_leaf(x: Any, dev):
    """A quantized leaf dict of the JAX tree -> the port's: {"q4p", "s"} and
    {"q": int8, "s"} as they are, and an unpacked int4 {"q": s4, "s"} (as a
    TPU run's persist_int4_params leaves it) repacked to {"q4p", "s"}."""
    q = np.asarray(x["q"]) if "q" in x else None
    if q is not None and q.dtype.name == "int4":
        x = {"q4p": _pack_int4(q), "s": x["s"]}
    return {k: tensor_from_numpy(v, dev) for k, v in x.items()}


def _leading(t) -> int:
    """The stacked (layer) axis of a tensor or of a quantized leaf's codes."""
    if isinstance(t, dict):
        t = t["q4p"] if "q4p" in t else t["q"]
    return t.shape[0]


def params_from_jax(np_tree: dict, cfg: DecoderConfig, device=None) -> dict:
    """sjd_tpu decoder params (numpy leaves) -> the port's params. Quantized
    trees (``quantize_weights``: int8 and packed int4 projections and head,
    the int8 embedding) keep their bytes; unpacked int4 codes are repacked."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict) and "s" in x and ("q" in x or "q4p" in x):
            return _quant_leaf(x, dev)
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return tensor_from_numpy(x, dev)

    params = conv(np_tree)
    n, d = cfg.num_layers, cfg.hidden_size
    embed = params["embed"]
    rows = embed["q"] if isinstance(embed, dict) else embed
    if tuple(rows.shape) != (cfg.vocab_size, d):
        raise ValueError(f"embed is {tuple(rows.shape)}, config wants {(cfg.vocab_size, d)}")
    for name, t in params["layers"].items():
        if _leading(t) != n:
            raise ValueError(f"layers/{name} stacks {_leading(t)} layers, config has {n}")
    return params


def vq_params_from_jax(np_tree: dict, cfg: VQConfig, device=None) -> dict:
    """sjd_tpu taming VQ params (numpy leaves) -> the port's params (the
    decoder half, and the encoder half where the tree has one), conv
    weights HWIO -> OIHW."""
    dev = resolve_device(device)

    def leaf(a):
        t = tensor_from_numpy(a, dev)
        return t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t

    keep = ("decoder", "codebook", "post_quant_conv_w", "post_quant_conv_b",
            "encoder", "quant_conv_w", "quant_conv_b")
    params = {k: _tree(np_tree[k], leaf) for k in keep if k in np_tree}
    if tuple(params["codebook"].shape) != (cfg.n_embed, cfg.embed_dim):
        raise ValueError(f"codebook is {tuple(params['codebook'].shape)}, config "
                         f"wants {(cfg.n_embed, cfg.embed_dim)}")
    return params


def emu3_vq_params_from_jax(np_tree: dict, cfg: Emu3VQConfig, device=None) -> dict:
    """sjd_tpu Emu3 VQ params (numpy leaves) -> the port's: 2-D convolution
    weights HWIO -> OIHW, 3-D ones DHWIO -> OIDHW, the rest as they are."""
    dev = resolve_device(device)

    def leaf(a):
        t = tensor_from_numpy(a, dev)
        if t.dim() == 4:
            return t.permute(3, 2, 0, 1).contiguous()
        if t.dim() == 5:
            return t.permute(4, 3, 0, 1, 2).contiguous()
        return t

    params = _tree(np_tree, leaf)
    if tuple(params["codebook"].shape) != (cfg.codebook_size, cfg.embed_dim):
        raise ValueError(f"codebook is {tuple(params['codebook'].shape)}, config "
                         f"wants {(cfg.codebook_size, cfg.embed_dim)}")
    return params


def inception_params_from_jax(np_tree: dict, device=None) -> dict:
    """sjd_tpu InceptionV3 params (``port_inception_v3``: BN folded, HWIO
    numpy leaves) -> the port's: OIHW, f32."""
    dev = resolve_device(device)
    return {name: {"w": tensor_from_numpy(p["w"], dev).permute(3, 2, 0, 1).contiguous(),
                   "b": tensor_from_numpy(p["b"], dev)}
            for name, p in np_tree.items()}


def clip_config_from_jax(jcfg):
    """The port's CLIPConfig with a sjd_tpu CLIPConfig's fields."""
    from .eval.clip import CLIPConfig, CLIPTowerConfig

    def tower(t):
        return CLIPTowerConfig(**{f.name: getattr(t, f.name) for f in dataclasses.fields(t)})

    return CLIPConfig(vision=tower(jcfg.vision), text=tower(jcfg.text),
                      projection_dim=jcfg.projection_dim, dtype=torch_dtype(jcfg.dtype))


def clip_params_from_jax(np_tree: dict, cfg, device=None) -> dict:
    """sjd_tpu CLIP params (``port_clip``, numpy leaves) -> the port's: the
    stacked ``[L, ...]`` tower leaves as they are, and the ``[P * P * 3,
    D]`` patch matrix (each patch flattened as (P, P, 3)) back to the conv
    weight ``[D, 3, P, P]``."""
    dev = resolve_device(device)
    params = _tree({k: v for k, v in np_tree.items() if k != "patch_kernel"},
                   lambda a: tensor_from_numpy(a, dev))
    P = cfg.vision.patch_size
    pk = tensor_from_numpy(np_tree["patch_kernel"], dev)
    params["patch_weight"] = pk.reshape(P, P, 3, -1).permute(3, 2, 0, 1).contiguous()
    return params


def train_config_from_jax(jcfg):
    """The port's ``parallel.TrainConfig`` with every field of a sjd_tpu
    TrainConfig (the two have the same fields and defaults)."""
    from .parallel.training import TrainConfig

    return TrainConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def vq_train_config_from_jax(jcfg):
    """The port's ``VQTrainConfig`` with every field of a sjd_tpu one (the
    two have the same fields and defaults)."""
    from .models.vq.train import VQTrainConfig

    return VQTrainConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _oihw_tree(np_tree, dev):
    """Numpy leaves -> tensors, 4-D (HWIO) ones to OIHW and 2-D ([in, out]
    linear) ones to [out, in]."""
    def leaf(a):
        t = tensor_from_numpy(a, dev)
        if t.dim() == 4:
            return t.permute(3, 2, 0, 1).contiguous()
        return t.t().contiguous() if t.dim() == 2 else t

    return _tree(np_tree, leaf)


def lpips_params_from_jax(np_tree: dict, device=None) -> dict:
    """sjd_tpu LPIPS params (``init_lpips_params`` or ``port_lpips``, numpy
    leaves) -> the port's: conv weights HWIO -> OIHW, ``calibrated`` kept."""
    dev = resolve_device(device)
    return {"convs": _oihw_tree(np_tree["convs"], dev),
            "lins": [tensor_from_numpy(v, dev) for v in np_tree["lins"]],
            "calibrated": bool(np_tree["calibrated"])}


def patchgan_params_from_jax(np_tree: dict, device=None) -> dict:
    """sjd_tpu PatchGAN params (numpy leaves) -> the port's: conv weights
    HWIO -> OIHW."""
    return _oihw_tree(np_tree, resolve_device(device))


def stylegan_disc_params_from_jax(np_tree: dict, device=None) -> dict:
    """sjd_tpu StyleGAN discriminator params (numpy leaves) -> the port's:
    conv weights HWIO -> OIHW, ``fc1``/``fc2`` [in, out] -> [out, in]."""
    return _oihw_tree(np_tree, resolve_device(device))
