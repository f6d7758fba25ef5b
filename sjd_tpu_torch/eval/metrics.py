"""Quantitative quality metrics: FID, Inception Score and CLIPScore
(sjd_tpu/eval/metrics.py).

The metric math is numpy/scipy on the host, the JAX package's line for
line, over pluggable feature extractors: the InceptionV3 and CLIP towers of
this package (``eval/inception.py``, ``eval/clip.py``) on the device,
torchvision's and transformers' (imported only when asked for; the machine
with the GPU has neither), or the checkpoint-free pixel statistics that
drive the pipeline end to end where no weights exist.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from ..utils.image_io import read_image, resize_bicubic_uint8


# ---------------------------------------------------------------------------
# metric math (feature space)
# ---------------------------------------------------------------------------


def frechet_distance(
    feats_a: np.ndarray, feats_b: np.ndarray, eps: float = 1e-6
) -> float:
    """FID between two feature sets [N, D] (Heusel et al. 2017)."""
    from scipy import linalg

    mu1, mu2 = feats_a.mean(0), feats_b.mean(0)
    s1 = np.cov(feats_a, rowvar=False)
    s2 = np.cov(feats_b, rowvar=False)
    diff = mu1 - mu2
    # the JAX package passes disp=False, which newer scipy no longer takes;
    # the default returns the same matrix
    covmean = linalg.sqrtm(s1 @ s2)
    if not np.isfinite(covmean).all():
        offset = np.eye(s1.shape[0]) * eps
        covmean = linalg.sqrtm((s1 + offset) @ (s2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean))


def inception_score(
    probs: np.ndarray, splits: int = 10
) -> tuple[float, float]:
    """IS from class probabilities [N, C] (Salimans et al. 2016)."""
    scores = []
    n = probs.shape[0]
    splits = max(1, min(splits, n))  # no empty split on a small set
    for part in np.array_split(probs, splits):
        py = part.mean(0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12))
        scores.append(np.exp(kl.sum(1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def clip_score(
    image_embeds: np.ndarray, text_embeds: np.ndarray, scale: float = 100.0
) -> float:
    """Mean max(0, cos(image, text)) * scale over matched pairs [N, D]."""
    a = image_embeds / np.linalg.norm(image_embeds, axis=-1, keepdims=True)
    b = text_embeds / np.linalg.norm(text_embeds, axis=-1, keepdims=True)
    return float(np.maximum((a * b).sum(-1), 0).mean() * scale)


# ---------------------------------------------------------------------------
# image directories
# ---------------------------------------------------------------------------


def _order(name: str):
    # the harness writes {index}.png: numeric order keeps image i beside
    # prompt i (lexicographic order puts 10.png before 2.png)
    stem = os.path.splitext(name)[0]
    return (0, int(stem), name) if stem.isdigit() else (1, 0, name)


def load_image_dir(path: str, size: Optional[int] = None) -> np.ndarray:
    """The PNG and JPEG files of ``path`` in numeric ``{index}`` order ->
    float32 [N, H, W, 3] in [0, 1]; with ``size`` each is resized to a
    square on the host (uint8 bicubic, PIL's counterpart)."""
    arrs = []
    for name in sorted(os.listdir(path), key=_order):
        if not name.lower().endswith((".png", ".jpg", ".jpeg")):
            continue
        img = read_image(os.path.join(path, name))
        if size:
            img = resize_bicubic_uint8(img, (size, size))
        arrs.append(img.astype(np.float32) / 255.0)
    if not arrs:
        raise FileNotFoundError(f"no images under {path}")
    return np.stack(arrs)


def make_inception_extractor(device=None):
    """InceptionV3 pool3 features through torchvision's ImageNet weights,
    where torchvision is installed."""
    import torch

    from .. import resolve_device

    try:
        from torchvision.models import Inception_V3_Weights, inception_v3
    except ImportError as e:
        raise RuntimeError(
            "torchvision unavailable: pass a feature extractor to "
            "evaluate_quantitative_scores(feature_fn=...), e.g. "
            "inception.make_inception_extractor_from_ckpt") from e
    dev = resolve_device(device)
    net = inception_v3(weights=Inception_V3_Weights.DEFAULT, transform_input=False)
    net.fc = torch.nn.Identity()
    net = net.eval().to(dev)

    def extract(images: np.ndarray, batch: int = 32) -> np.ndarray:
        out = []
        with torch.no_grad():
            for i in range(0, len(images), batch):
                x = torch.tensor(images[i : i + batch], device=dev).permute(0, 3, 1, 2)
                x = torch.nn.functional.interpolate(
                    x, size=(299, 299), mode="bilinear", align_corners=False)
                out.append(net(x * 2 - 1).cpu().numpy())
        return np.concatenate(out)

    return extract


def make_clip_extractor(model_dir: str, device=None):
    """CLIP image and text embedding functions through transformers'
    CLIPModel from a local checkpoint directory, where transformers is
    installed (a cross-check of the native towers)."""
    import torch
    from transformers import CLIPModel, CLIPProcessor

    from .. import resolve_device

    dev = resolve_device(device)
    model = CLIPModel.from_pretrained(model_dir).eval().to(dev)
    proc = CLIPProcessor.from_pretrained(model_dir)

    def image_embeds(images: np.ndarray, batch: int = 32) -> np.ndarray:
        out = []
        with torch.no_grad():
            for i in range(0, len(images), batch):
                inputs = proc(
                    images=[(im * 255).astype(np.uint8) for im in images[i : i + batch]],
                    return_tensors="pt")
                out.append(model.get_image_features(**inputs.to(dev)).cpu().numpy())
        return np.concatenate(out)

    def text_embeds(texts, batch: int = 64) -> np.ndarray:
        out = []
        with torch.no_grad():
            for i in range(0, len(texts), batch):
                inputs = proc(text=list(texts[i : i + batch]), return_tensors="pt",
                              padding=True, truncation=True)
                out.append(model.get_text_features(**inputs.to(dev)).cpu().numpy())
        return np.concatenate(out)

    return image_embeds, text_embeds


def evaluate_clip_score(
    generated_dir: str, prompts, model_dir: str, *, native: bool = True,
    tokenizer=None, device=None,
) -> float:
    """CLIPScore over a generated directory and its prompts, in order.
    ``native=True`` runs this package's towers (``eval/clip.py``) from the
    checkpoint directory, with ``tokenizer`` (any callable with the HF
    tokenizer's call signature; transformers' when None);
    ``native=False`` transformers' CLIPModel."""
    if native:
        from .clip import make_native_clip_extractor

        image_embeds, text_embeds = make_native_clip_extractor(
            model_dir, tokenizer=tokenizer, device=device)
    else:
        image_embeds, text_embeds = make_clip_extractor(model_dir, device=device)
    imgs = load_image_dir(generated_dir, size=224)
    return clip_score(image_embeds(imgs), text_embeds(list(prompts)))


def make_pixel_extractor(pool: int = 8):
    """Checkpoint-free smoke extractor: mean-pooled pixel statistics as the
    feature vector. Not comparable with Inception FID: it drives the whole
    scoring pipeline (generate, shard, FID and IS math) where no extractor
    weights exist."""

    def extract(images: np.ndarray) -> np.ndarray:
        n, h, w, c = images.shape
        ph, pw = h // pool, w // pool
        x = images[:, : ph * pool, : pw * pool, :]
        x = x.reshape(n, pool, ph, pool, pw, c).mean(axis=(2, 4))
        return x.reshape(n, -1).astype(np.float64)

    return extract


def make_pixel_probs(n_classes: int = 16):
    """Smoke classifier for the IS formula: a softmax over coarse colour
    statistics. The same caveat as :func:`make_pixel_extractor`."""

    def probs(images: np.ndarray) -> np.ndarray:
        n = images.shape[0]
        feats = images.reshape(n, -1, 3).mean(axis=1).astype(np.float64)
        feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-6)
        logits = np.concatenate(
            [np.outer(np.tanh(feats[:, k]), np.arange(1, n_classes // 3 + 1))
             for k in range(3)]
            + [np.zeros((n, n_classes - 3 * (n_classes // 3)))],
            axis=1,
        )
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    return probs


def evaluate_quantitative_scores(
    generated_dir: str,
    reference_dir: Optional[str] = None,
    *,
    feature_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    probs_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> dict:
    """FID against ``reference_dir`` and IS over a generated directory."""
    gen = load_image_dir(generated_dir)
    results: dict = {"n_images": len(gen)}
    if reference_dir is not None:
        # the extractor is needed for FID only: an IS-only run needs no
        # torchvision
        if feature_fn is None:
            feature_fn = make_inception_extractor()
        ref = load_image_dir(reference_dir)
        results["fid"] = frechet_distance(feature_fn(gen), feature_fn(ref))
    if probs_fn is not None:
        is_mean, is_std = inception_score(probs_fn(gen))
        results["inception_score"] = is_mean
        results["inception_score_std"] = is_std
    return results
