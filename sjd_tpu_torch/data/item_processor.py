"""FlexAR token layout and conversation prompting for Lumina-mGPT
(sjd_tpu/data/item_processor.py):

  image block = <image_start> <size h_grids> <size w_grids>
                (row of w_lat ids + <new_line>) x h_lat <image_end>
  size token id = 8804 + pixels // 32; latent dim = n_grids * 2
  conversation turns end with <reserved08706>; the text-to-image prompt is
  "Generate an image of {W}x{H} according to the following prompt:\\n{caption}"

The layout functions are tokenizer-free; :class:`FlexARItemProcessor` adds
a tokenizer (any object with ``encode``) for text and the VQ encoder for
image inputs.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.chameleon import IMAGE_END_ID, IMAGE_START_ID, NEW_LINE_ID, SIZE_TOKEN_BASE
from .image_processing import generate_crop_size_list
from .vocab_translation import VocabMapping, bpe_to_img, img_to_bpe

SEP_TOKEN = "<reserved08706>"
IMAGE_PLACEHOLDER = "<|image|>"


def size_token_id(pixels: int, patch_size: int = 32) -> int:
    return SIZE_TOKEN_BASE + pixels // patch_size


def grid_dims(pixels_h: int, pixels_w: int) -> Tuple[int, int]:
    """Latent grid (h, w) of a pixel size: VQ factor 16."""
    return pixels_h // 16, pixels_w // 16


def image_block_from_grid(grid_ids: np.ndarray, pixels_h: int, pixels_w: int,
                          mapping: Optional[VocabMapping] = None) -> List[int]:
    """[h_lat, w_lat] codebook ids -> the FlexAR image block, the ids
    translated to the LM's image tokens through ``mapping`` (None keeps
    them raw)."""
    grid_ids = np.asarray(grid_ids)
    h_lat, w_lat = grid_ids.shape
    if (h_lat, w_lat) != grid_dims(pixels_h, pixels_w):
        raise ValueError(f"grid {(h_lat, w_lat)} is not the latent grid of "
                         f"{pixels_h}x{pixels_w} px")
    if mapping is not None:
        grid_ids = img_to_bpe(mapping, grid_ids)
    with_eol = np.concatenate(
        [grid_ids, np.full((h_lat, 1), NEW_LINE_ID, grid_ids.dtype)], axis=1).reshape(-1)
    return [IMAGE_START_ID, size_token_id(pixels_h), size_token_id(pixels_w),
            *[int(t) for t in with_eol], IMAGE_END_ID]


def image_grid_from_block(tokens: Sequence[int],
                          mapping: Optional[VocabMapping] = None) -> np.ndarray:
    """Image token span (from <image_start>) -> [h, w] grid of ids, through
    ``mapping`` when given."""
    tokens = list(tokens)
    if tokens[0] != IMAGE_START_ID:
        raise ValueError("expected <image_start>")
    h_lat = (tokens[1] - SIZE_TOKEN_BASE) * 2
    w_lat = (tokens[2] - SIZE_TOKEN_BASE) * 2
    body = tokens[3:]
    rows = []
    for r in range(h_lat):
        row = body[r * (w_lat + 1): r * (w_lat + 1) + w_lat]
        if len(row) != w_lat:
            raise ValueError(f"truncated image at row {r}")
        eol = body[r * (w_lat + 1) + w_lat]
        if eol != NEW_LINE_ID:
            raise ValueError(f"missing <new_line> at row {r}: {eol}")
        rows.append(row)
    grid = np.asarray(rows, np.int32)
    if mapping is not None:
        grid = bpe_to_img(mapping, grid)
    return grid


def split_generation(tokens: Sequence[int]):
    """Split ids into ('text', [ids]) and ('image', [ids]) spans."""
    spans, cur = [], []
    tokens = list(tokens)
    i = 0
    while i < len(tokens):
        if tokens[i] == IMAGE_START_ID:
            if cur:
                spans.append(("text", cur))
            j = i
            while j < len(tokens) and tokens[j] != IMAGE_END_ID:
                j += 1
            spans.append(("image", tokens[i: j + 1]))
            cur, i = [], j + 1
        else:
            cur.append(tokens[i])
            i += 1
    if cur:
        spans.append(("text", cur))
    return spans


def image_grid(images, rows: int, cols: int):
    """Tile images into one grid image: uint8 ``[H, W, 3]`` arrays into one
    array with numpy, PIL images into one PIL image."""
    if not _is_pil(images[0]):
        h, w = np.asarray(images[0]).shape[:2]
        grid = np.zeros((rows * h, cols * w, 3), np.uint8)
        for i, img in enumerate(images):
            r, c = divmod(i, cols)
            grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = img
        return grid
    from PIL import Image

    w, h = images[0].size
    grid = Image.new("RGB", (cols * w, rows * h))
    for i, img in enumerate(images):
        grid.paste(img, ((i % cols) * w, (i // cols) * h))
    return grid


def t2i_question(caption: str, pixels_w: int = 768, pixels_h: int = 768) -> str:
    return (f"Generate an image of {pixels_w}x{pixels_h} according to the "
            f"following prompt:\n{caption}")


def conversation_prompt(qas: List[List[Optional[str]]]) -> str:
    """Turns joined with the separator token; a trailing None answer leaves
    a generation prompt."""
    out = []
    for q, a in qas:
        out.append(q + SEP_TOKEN)
        if a is not None:
            out.append(a + SEP_TOKEN)
    return "".join(out)


def _is_pil(image) -> bool:
    return hasattr(image, "size") and hasattr(image, "convert") and not isinstance(
        image, (np.ndarray, torch.Tensor))


class FlexARItemProcessor:
    """Tokenizer-backed prompt builder. ``tokenizer`` is any object with
    ``encode`` over the Chameleon vocabulary. With ``vq_params`` (on any
    device: the encoder runs there) and ``mapping`` it also turns images
    into FlexAR blocks, spliced where ``<|image|>`` appears in a turn."""

    def __init__(self, tokenizer, *, mapping: Optional[VocabMapping] = None,
                 vq_params=None, vq_cfg=None, input_patches: int = 1024):
        self.tokenizer = tokenizer
        self.mapping = mapping
        self.vq_params = vq_params
        self.vq_cfg = vq_cfg
        # crop sizes for image inputs; input_patches bounds their tokens
        self.crop_size_list = generate_crop_size_list(num_patches=input_patches,
                                                      patch_size=32)

    def t2i_prompt_ids(self, caption: str, pixels: int = 768) -> List[int]:
        text = conversation_prompt([[t2i_question(caption, pixels, pixels), None]])
        return list(self.tokenizer.encode(text))

    def process_image(self, image) -> List[int]:
        """A PIL image or a uint8 ``[H, W, 3]`` array of any size (fitted to
        a crop size first), or an ``[H, W, 3]`` float array in [-1, 1] (H, W
        multiples of twice the VQ factor) -> FlexAR block: VQ encode at the
        image's size, codebook -> BPE ids, rows with <new_line>, the size
        header."""
        from ..models.vq import encode as vq_encode

        if self.vq_params is None:
            raise ValueError("process_image needs vq_params")
        f = self.vq_cfg.downsample_factor
        if _is_pil(image):
            image = self._fit_to_crop(image)
            w_px, h_px = image.size
            arr = np.asarray(image.convert("RGB"), np.float32) / 127.5 - 1.0
        elif np.asarray(image).dtype == np.uint8:
            arr = self._fit_to_crop(np.asarray(image)).astype(np.float32) / 127.5 - 1.0
            h_px, w_px = arr.shape[:2]
        else:
            arr = np.asarray(image, np.float32)
            h_px, w_px = arr.shape[:2]
            if h_px % (2 * f) or w_px % (2 * f):
                raise ValueError(f"float array inputs must be multiples of {2 * f}px (pass "
                                 "uint8 pixels or a PIL image for crop-list fitting)")
        dev = self.vq_params["codebook"].device
        with torch.no_grad():
            ids = vq_encode(self.vq_params, self.vq_cfg, torch.from_numpy(arr[None]).to(dev))
        grid = ids[0].cpu().numpy().astype(np.int32).reshape(h_px // f, w_px // f)
        return image_block_from_grid(grid, h_px, w_px, mapping=self.mapping)

    def crop_box(self, w_px: int, h_px: int) -> Tuple[int, int, int, int, int, int]:
        """The deterministic var_center_crop of a ``w_px`` x ``h_px`` image:
        the crop size whose aspect ratio is nearest, the size that covers it
        and the centred box: (resize w, resize h, left, top, crop w, crop h)."""
        cw, ch = min(self.crop_size_list,
                     key=lambda s: abs(math.log((w_px / h_px) / (s[0] / s[1]))))
        scale = max(cw / w_px, ch / h_px)
        rw, rh = max(cw, round(w_px * scale)), max(ch, round(h_px * scale))
        return rw, rh, (rw - cw) // 2, (rh - ch) // 2, cw, ch

    def _fit_to_crop(self, image):
        """A PIL image (resized by PIL) or a uint8 [H, W, 3] array (resized
        by ``resize_bicubic_uint8``, PIL's default bicubic), fitted to the
        :meth:`crop_box`."""
        if _is_pil(image):
            rw, rh, left, top, cw, ch = self.crop_box(*image.size)
            image = image.resize((rw, rh))
            return image.crop((left, top, left + cw, top + ch))
        from ..utils.image_io import resize_bicubic_uint8

        rw, rh, left, top, cw, ch = self.crop_box(image.shape[1], image.shape[0])
        return resize_bicubic_uint8(image, (rh, rw))[top:top + ch, left:left + cw]

    def multimodal_prompt_ids(self, qas: List[List[Optional[str]]],
                              images: Sequence = ()) -> List[int]:
        """Conversation turns with each ``<|image|>`` replaced by the next
        image's block, in order."""
        img_iter = iter(images)
        out: List[int] = []

        def emit(text: str):
            for k, part in enumerate(text.split(IMAGE_PLACEHOLDER)):
                if k:
                    out.extend(self.process_image(next(img_iter)))
                if part:
                    out.extend(self.tokenizer.encode(part))

        for q, a in qas:
            emit(q + SEP_TOKEN)
            if a is not None:
                emit(a + SEP_TOKEN)
        return out

    def decode_images(self, tokens: Sequence[int]) -> List[np.ndarray]:
        """Every image span of ``tokens`` as its grid of codebook ids."""
        return [image_grid_from_block(span, mapping=self.mapping)
                for kind, span in split_generation(tokens) if kind == "image"]
