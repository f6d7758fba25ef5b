"""Image pre- and post-processing for the VQ tokenizers
(sjd_tpu/data/image_processing.py): area-preserving factor-multiple sizes,
[-1, 1] normalisation and back, and Lumina's list of input crop sizes.
PIL is imported only where a PIL image is taken or made."""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def smart_resize(height: int, width: int, factor: int = 8, min_pixels: int = 512 * 512,
                 max_pixels: int = 1024 * 1024) -> Tuple[int, int]:
    """Factor-divisible dims with the area clamped to [min_pixels,
    max_pixels] and the aspect ratio (nearly) kept."""
    if height < factor or width < factor:
        raise ValueError(f"height:{height} or width:{width} must be >= factor:{factor}")
    if max(height, width) / min(height, width) > 5:
        raise ValueError("absolute aspect ratio must be smaller than 5")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def preprocess(image, *, factor: int = 8, min_pixels: int = 512 * 512,
               max_pixels: int = 1024 * 1024) -> np.ndarray:
    """PIL image -> [H, W, 3] float32 in [-1, 1], smart-resized (bicubic)."""
    from PIL import Image

    w, h = image.size
    h2, w2 = smart_resize(h, w, factor, min_pixels, max_pixels)
    image = image.convert("RGB").resize((w2, h2), Image.BICUBIC)
    return np.asarray(image, np.float32) / 255.0 * 2.0 - 1.0


def postprocess(pixels):
    """[H, W, 3] in [-1, 1] -> PIL image."""
    from PIL import Image

    arr = ((np.clip(np.asarray(pixels, np.float32), -1, 1) + 1) * 127.5).astype(np.uint8)
    return Image.fromarray(arr)


def generate_crop_size_list(num_patches: int = 1024, patch_size: int = 32,
                            max_ratio: float = 4.0) -> List[Tuple[int, int]]:
    """(width, height) crops with a bounded aspect ratio whose patch grids
    fit the budget (Lumina's crop_size_list)."""
    if max_ratio < 1:
        raise ValueError(f"max_ratio must be >= 1, got {max_ratio}")
    sizes = []
    wp, hp = num_patches, 1
    while wp > 0:
        if max(wp, hp) / min(wp, hp) <= max_ratio:
            sizes.append((wp * patch_size, hp * patch_size))
        if (hp + 1) * wp <= num_patches:
            hp += 1
        else:
            wp -= 1
    return sizes
