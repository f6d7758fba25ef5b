"""CLIP (ViT-B/32) image and text towers for CLIPScore
(sjd_tpu/eval/clip.py): the vision ViT (patch conv, class token, pre-LN
blocks, quick-GELU) and the causal text transformer, with a port of the HF
CLIPModel weights, so that ``evaluate_clip_score`` runs from a local
checkpoint directory.

The patch embedding keeps the checkpoint's OIHW ``[D, 3, P, P]`` weight and
runs as ``F.conv2d`` with stride P; the JAX package flattens each patch as
(P, P, 3) against a ``[P * P * 3, D]`` matrix, which
``convert.clip_params_from_jax`` folds back. The tokenizer is any callable
with the HF tokenizer's call signature (``tokenizer(texts,
padding="max_length", max_length=, truncation=True, return_tensors="np")
["input_ids"]``); transformers' ``CLIPTokenizerFast`` is built only when
none is given.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CLIPTowerConfig:
    hidden_size: int
    layers: int
    heads: int
    intermediate_size: int
    # vision only
    image_size: int = 224
    patch_size: int = 32
    # text only
    vocab_size: int = 49408
    max_positions: int = 77
    eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vision: CLIPTowerConfig
    text: CLIPTowerConfig
    projection_dim: int = 512
    dtype: torch.dtype = torch.float32

    @classmethod
    def vit_b32(cls, dtype=torch.float32) -> "CLIPConfig":
        return cls(
            vision=CLIPTowerConfig(hidden_size=768, layers=12, heads=12,
                                   intermediate_size=3072),
            text=CLIPTowerConfig(hidden_size=512, layers=12, heads=8,
                                 intermediate_size=2048),
            projection_dim=512, dtype=dtype,
        )

    @classmethod
    def from_hf_config(cls, cfg: Mapping[str, Any], dtype=torch.float32) -> "CLIPConfig":
        v, t = cfg["vision_config"], cfg["text_config"]
        return cls(
            vision=CLIPTowerConfig(
                hidden_size=v["hidden_size"], layers=v["num_hidden_layers"],
                heads=v["num_attention_heads"],
                intermediate_size=v["intermediate_size"],
                image_size=v.get("image_size", 224),
                patch_size=v.get("patch_size", 32),
            ),
            text=CLIPTowerConfig(
                hidden_size=t["hidden_size"], layers=t["num_hidden_layers"],
                heads=t["num_attention_heads"],
                intermediate_size=t["intermediate_size"],
                vocab_size=t.get("vocab_size", 49408),
                max_positions=t.get("max_position_embeddings", 77),
            ),
            projection_dim=cfg.get("projection_dim", 512),
            dtype=dtype,
        )


def _ln(x: Tensor, w: Tensor, b: Tensor, eps: float) -> Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps).to(x.dtype)


def _quick_gelu(x: Tensor) -> Tensor:
    return x * torch.sigmoid(1.702 * x)


def _encoder(x: Tensor, lp: Mapping[str, Tensor], cfg: CLIPTowerConfig, *,
             causal: bool) -> Tensor:
    """The pre-LN stack over stacked ``[n_layers, ...]`` weights: ln1/ln2
    (w, b), wq/wk/wv/wo with their biases, fc1/fc2 with b1/b2."""
    B, T, D = x.shape
    H = cfg.heads
    Dh = D // H
    scale = Dh ** -0.5
    bias = torch.zeros((T, T), dtype=torch.float32, device=x.device)
    if causal:
        bias = bias.masked_fill(~torch.ones((T, T), dtype=torch.bool, device=x.device).tril(),
                                torch.finfo(torch.float32).min)

    def heads(t):
        return t.reshape(B, T, H, Dh).transpose(1, 2)

    for i in range(cfg.layers):
        p = {k: v[i] for k, v in lp.items()}
        h = _ln(x, p["ln1_w"], p["ln1_b"], cfg.eps)
        q = heads(F.linear(h, p["wq"], p["bq"]))
        k = heads(F.linear(h, p["wk"], p["bk"]))
        v = heads(F.linear(h, p["wv"], p["bv"]))
        scores = torch.matmul((q * scale).float(), k.float().transpose(-1, -2)) + bias
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, D)
        x = x + F.linear(ctx, p["wo"], p["bo"])
        h = _ln(x, p["ln2_w"], p["ln2_b"], cfg.eps)
        x = x + F.linear(_quick_gelu(F.linear(h, p["fc1"], p["b1"])), p["fc2"], p["b2"])
    return x


def clip_image_features(params: Mapping[str, Any], cfg: CLIPConfig,
                        pixels: Tensor) -> Tensor:
    """``pixels`` [B, H, W, 3], CLIP-normalised -> [B, projection_dim] image
    embeddings (CLIPModel.get_image_features)."""
    v = cfg.vision
    B = pixels.shape[0]
    x = F.conv2d(pixels.to(cfg.dtype).permute(0, 3, 1, 2), params["patch_weight"],
                 stride=v.patch_size)  # [B, D, g, g]
    x = x.flatten(2).transpose(1, 2)  # patches row-major, as the JAX flatten
    cls = params["class_embed"].to(cfg.dtype).expand(B, 1, v.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["vis_pos_embed"][None]
    x = _ln(x, params["vis_pre_ln_w"], params["vis_pre_ln_b"], v.eps)
    x = _encoder(x, params["vis_layers"], v, causal=False)
    pooled = _ln(x[:, 0], params["vis_post_ln_w"], params["vis_post_ln_b"], v.eps)
    return F.linear(pooled, params["visual_projection"])


def clip_text_features(params: Mapping[str, Any], cfg: CLIPConfig, ids: Tensor) -> Tensor:
    """``ids`` [B, T] (BPE ids; <|endoftext|> is the largest) -> [B,
    projection_dim] text embeddings (CLIPModel.get_text_features), pooled
    at each row's largest id, HF's pooling for the standard CLIP vocab."""
    t = cfg.text
    B, T = ids.shape
    ids = ids.long()
    x = params["token_embed"][ids].to(cfg.dtype) + params["txt_pos_embed"][None, :T]
    x = _encoder(x, params["txt_layers"], t, causal=True)
    x = _ln(x, params["txt_final_ln_w"], params["txt_final_ln_b"], t.eps)
    pooled = x[torch.arange(B, device=x.device), ids.argmax(dim=-1)]
    return F.linear(pooled, params["text_projection"])


# ---------------------------------------------------------------------------
# weight port (HF CLIPModel names)
# ---------------------------------------------------------------------------

_LAYER_KEYS = {
    "ln1_w": "layer_norm1.weight", "ln1_b": "layer_norm1.bias",
    "wq": "self_attn.q_proj.weight", "bq": "self_attn.q_proj.bias",
    "wk": "self_attn.k_proj.weight", "bk": "self_attn.k_proj.bias",
    "wv": "self_attn.v_proj.weight", "bv": "self_attn.v_proj.bias",
    "wo": "self_attn.out_proj.weight", "bo": "self_attn.out_proj.bias",
    "ln2_w": "layer_norm2.weight", "ln2_b": "layer_norm2.bias",
    "fc1": "mlp.fc1.weight", "b1": "mlp.fc1.bias",
    "fc2": "mlp.fc2.weight", "b2": "mlp.fc2.bias",
}


def port_clip(sd: Mapping[str, Any], cfg: CLIPConfig, device=None) -> Dict[str, Any]:
    """An HF CLIPModel state dict -> the towers' params on ``device``, each
    tower's layers stacked ``[n_layers, ...]``."""
    from ..utils.port import as_tensor, stack_to

    dev = resolve_device(device)
    dt = cfg.dtype

    def t(name):
        return as_tensor(sd[name]).to(device=dev, dtype=dt)

    def tower(prefix: str, n: int) -> Dict[str, Tensor]:
        return {k: stack_to(sd, [f"{prefix}layers.{i}.{name}" for i in range(n)], dt, dev)
                for k, name in _LAYER_KEYS.items()}

    return {
        "patch_weight": t("vision_model.embeddings.patch_embedding.weight"),
        "class_embed": t("vision_model.embeddings.class_embedding"),
        "vis_pos_embed": t("vision_model.embeddings.position_embedding.weight"),
        "vis_pre_ln_w": t("vision_model.pre_layrnorm.weight"),
        "vis_pre_ln_b": t("vision_model.pre_layrnorm.bias"),
        "vis_layers": tower("vision_model.encoder.", cfg.vision.layers),
        "vis_post_ln_w": t("vision_model.post_layernorm.weight"),
        "vis_post_ln_b": t("vision_model.post_layernorm.bias"),
        "visual_projection": t("visual_projection.weight"),
        "token_embed": t("text_model.embeddings.token_embedding.weight"),
        "txt_pos_embed": t("text_model.embeddings.position_embedding.weight"),
        "txt_layers": tower("text_model.encoder.", cfg.text.layers),
        "txt_final_ln_w": t("text_model.final_layer_norm.weight"),
        "txt_final_ln_b": t("text_model.final_layer_norm.bias"),
        "text_projection": t("text_projection.weight"),
    }


def hf_config(cfg: CLIPConfig) -> Dict[str, Any]:
    """``cfg`` as the fields of an HF ``config.json`` that
    :meth:`CLIPConfig.from_hf_config` reads."""
    v, t = cfg.vision, cfg.text
    return {
        "vision_config": {"hidden_size": v.hidden_size, "num_hidden_layers": v.layers,
                          "num_attention_heads": v.heads,
                          "intermediate_size": v.intermediate_size,
                          "image_size": v.image_size, "patch_size": v.patch_size},
        "text_config": {"hidden_size": t.hidden_size, "num_hidden_layers": t.layers,
                        "num_attention_heads": t.heads,
                        "intermediate_size": t.intermediate_size,
                        "vocab_size": t.vocab_size, "max_position_embeddings": t.max_positions},
        "projection_dim": cfg.projection_dim,
    }


def synth_clip_state_dict(cfg: CLIPConfig, seed: int) -> Dict[str, np.ndarray]:
    """A seeded random HF CLIPModel state dict (numpy f32) with ``cfg``'s
    shapes: norms near the identity, projections scaled by fan-in."""
    rs = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}

    def r(*shape, scale=0.1, shift=0.0):
        return (shift + scale * rs.randn(*shape)).astype(np.float32)

    def norm(name, d):
        sd[name + ".weight"], sd[name + ".bias"] = r(d, shift=1.0), r(d)

    def tower(prefix, tc: CLIPTowerConfig):
        d, ff = tc.hidden_size, tc.intermediate_size
        for i in range(tc.layers):
            p = f"{prefix}layers.{i}."
            norm(p + "layer_norm1", d)
            norm(p + "layer_norm2", d)
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[p + f"self_attn.{proj}.weight"] = r(d, d, scale=d ** -0.5)
                sd[p + f"self_attn.{proj}.bias"] = r(d)
            sd[p + "mlp.fc1.weight"], sd[p + "mlp.fc1.bias"] = r(ff, d, scale=d ** -0.5), r(ff)
            sd[p + "mlp.fc2.weight"], sd[p + "mlp.fc2.bias"] = r(d, ff, scale=ff ** -0.5), r(d)

    v, t = cfg.vision, cfg.text
    P, g = v.patch_size, v.image_size // v.patch_size
    sd["vision_model.embeddings.patch_embedding.weight"] = r(
        v.hidden_size, 3, P, P, scale=(3 * P * P) ** -0.5)
    sd["vision_model.embeddings.class_embedding"] = r(v.hidden_size)
    sd["vision_model.embeddings.position_embedding.weight"] = r(g * g + 1, v.hidden_size)
    norm("vision_model.pre_layrnorm", v.hidden_size)
    tower("vision_model.encoder.", v)
    norm("vision_model.post_layernorm", v.hidden_size)
    sd["visual_projection.weight"] = r(cfg.projection_dim, v.hidden_size,
                                       scale=v.hidden_size ** -0.5)
    sd["text_model.embeddings.token_embedding.weight"] = r(t.vocab_size, t.hidden_size)
    sd["text_model.embeddings.position_embedding.weight"] = r(t.max_positions, t.hidden_size)
    tower("text_model.encoder.", t)
    norm("text_model.final_layer_norm", t.hidden_size)
    sd["text_projection.weight"] = r(cfg.projection_dim, t.hidden_size,
                                     scale=t.hidden_size ** -0.5)
    return sd


# ---------------------------------------------------------------------------
# preprocessing (CLIPProcessor's, on the host)
# ---------------------------------------------------------------------------

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_images(images: np.ndarray, image_size: int = 224) -> np.ndarray:
    """[B, H, W, 3] float in [0, 1] or uint8 -> CLIP-normalised [B, S, S, 3]
    f32: the shortest side resized to S (uint8 bicubic, PIL's counterpart),
    then the centre crop."""
    from ..utils.image_io import resize_bicubic_uint8

    out = np.empty((len(images), image_size, image_size, 3), np.float32)
    for i, im in enumerate(images):
        if im.dtype != np.uint8:
            im = (np.clip(im, 0.0, 1.0) * 255).astype(np.uint8)
        hpx, wpx = im.shape[:2]
        short = min(wpx, hpx)
        nw, nh = round(wpx * image_size / short), round(hpx * image_size / short)
        im = resize_bicubic_uint8(im, (nh, nw))
        left, top = (nw - image_size) // 2, (nh - image_size) // 2
        out[i] = im[top : top + image_size, left : left + image_size] / np.float32(255.0)
    return (out - CLIP_MEAN) / CLIP_STD


class NativeCLIP:
    """CLIP embeddings from a local HF checkpoint directory (``config.json``
    and ``*.safetensors`` or ``pytorch_model*.bin``), on ``device``."""

    def __init__(self, model_dir: str, tokenizer=None, device=None, dtype=torch.float32):
        from ..utils.port import checkpoint_files, load_torch_checkpoint

        self.device = resolve_device(device)
        with open(os.path.join(model_dir, "config.json")) as f:
            self.config = CLIPConfig.from_hf_config(json.load(f), dtype)
        sd: Dict[str, Any] = {}
        for path in checkpoint_files(model_dir):
            sd.update(load_torch_checkpoint(path))
        self.params = port_clip(sd, self.config, device=self.device)
        if tokenizer is None:
            from transformers import CLIPTokenizerFast

            tokenizer = CLIPTokenizerFast.from_pretrained(model_dir)
        self.tokenizer = tokenizer

    def image_embeds(self, images: np.ndarray, batch: int = 32) -> np.ndarray:
        out = []
        with torch.no_grad():
            for i in range(0, len(images), batch):
                px = preprocess_images(images[i : i + batch], self.config.vision.image_size)
                x = torch.from_numpy(px).to(self.device)
                out.append(clip_image_features(self.params, self.config, x).float()
                           .cpu().numpy())
        return np.concatenate(out)

    def text_embeds(self, texts: List[str], batch: int = 64) -> np.ndarray:
        out = []
        with torch.no_grad():
            for i in range(0, len(texts), batch):
                enc = self.tokenizer(
                    list(texts[i : i + batch]), padding="max_length",
                    max_length=self.config.text.max_positions,
                    truncation=True, return_tensors="np")
                ids = torch.as_tensor(np.asarray(enc["input_ids"]), device=self.device)
                out.append(clip_text_features(self.params, self.config, ids).float()
                           .cpu().numpy())
        return np.concatenate(out)


def make_native_clip_extractor(model_dir: str, tokenizer=None,
                               device=None) -> Tuple[Any, Any]:
    """(image_embeds, text_embeds) with ``metrics.make_clip_extractor``'s
    interface, on the native towers."""
    clip = NativeCLIP(model_dir, tokenizer=tokenizer, device=device)
    return clip.image_embeds, clip.text_embeds
