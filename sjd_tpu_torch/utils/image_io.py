"""Image files and host-side resizes for the evaluation and VQ training paths, without PIL
(the machine with the GPU has none).

  * :func:`encode_png` makes the bytes of a PNG from a uint8 ``[H, W, 3]``
    or ``[H, W]`` array with the standard library's ``zlib``;
    :func:`write_png` writes them atomically (a ``.tmp`` file, then
    ``os.replace``): a run cut mid-write leaves no truncated PNG that a
    resuming harness would take for a finished image.
  * :func:`decode_png` reads the bytes of every PNG that PIL opens, with
    ``zlib`` and numpy only: grey, grey + alpha, RGB, RGBA and palette (with
    or without ``tRNS``), at every bit depth PNG allows (1, 2, 4, 8, 16),
    with any of the five row filters, plain or Adam7 interlaced; a file PNG
    does not allow (a depth its color type has not, no ``PLTE`` in a
    palette file) is refused with its format named. :func:`read_png` is
    the same on a file.
  * :func:`read_image` gives PIL's ``convert("RGB")`` of a PNG bit for bit
    (16-bit grey clipped, as PIL clips it), or reads a JPEG or WEBP
    through PIL (imported only then: without PIL such a file raises with
    its name, never skipped). :func:`image_from_bytes` does the same for
    the bytes of an upload, told apart by the PNG signature.
  * :func:`resize_bicubic_uint8` is PIL's ``resize(..., BICUBIC)`` bit for
    bit: its fixed-point two-pass resampling written in numpy.
    :func:`resize_bilinear` is the
    counterpart of ``jax.image.resize(method="bilinear")`` on floats:
    ``F.interpolate(mode="bilinear", antialias=True, align_corners=False)``
    (without ``antialias`` a downsample samples instead of averaging).
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # samples per pixel, by color type
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_COLOR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey + alpha", 6: "RGBA"}
# Adam7's seven passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """A uint8 ``[H, W]``, ``[H, W, 3]`` or ``[H, W, 4]`` array -> the bytes
    of a PNG (every row with filter 0)."""
    a = np.asarray(arr)
    if a.dtype != np.uint8:
        raise ValueError(f"a PNG is written from uint8, not {a.dtype}")
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3 or a.shape[2] not in (1, 3, 4):
        raise ValueError(f"expected [H, W], [H, W, 3] or [H, W, 4], got {a.shape}")
    h, w, c = a.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(a).reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write :func:`encode_png` of ``arr`` to ``path``, through ``path +
    ".tmp"`` and ``os.replace``."""
    data = encode_png(arr)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, pos: int, h: int, stride: int, bpp: int,
              path: str) -> Tuple[np.ndarray, int]:
    """The ``h`` filtered scanlines of ``stride`` bytes at ``raw[pos:]`` ->
    ([h, stride] uint8, the offset after them). None and Up are whole-row
    numpy; Sub is a per-channel running sum; Average and Paeth depend on the
    reconstructed left neighbour, so they run byte by byte."""
    end = pos + h * (stride + 1)
    if len(raw) < end:
        raise ValueError(f"{path}: the image data is truncated")
    lines = np.frombuffer(raw, np.uint8, h * (stride + 1), pos).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, cur = lines[y, 0], lines[y, 1:]
        if kind == 0:
            row = cur.copy()
        elif kind == 1:
            row = (np.cumsum(cur.reshape(-1, bpp).astype(np.int64), axis=0)
                   .reshape(-1) & 0xFF).astype(np.uint8)
        elif kind == 2:
            row = cur + prev
        elif kind in (3, 4):
            r, up, f = bytearray(stride), prev.tolist(), cur.tolist()
            for i in range(stride):
                left = r[i - bpp] if i >= bpp else 0
                if kind == 3:
                    r[i] = (f[i] + ((left + up[i]) >> 1)) & 0xFF
                else:
                    ul = up[i - bpp] if i >= bpp else 0
                    r[i] = (f[i] + _paeth(left, up[i], ul)) & 0xFF
            row = np.frombuffer(bytes(r), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has filter type {kind}, which PNG does not define")
        out[y] = row
        prev = row
    return out, end


def _samples(rows: np.ndarray, w: int, c: int, depth: int) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, w, c]: uint16 at 16 bits,
    else uint8 (sub-byte samples unpacked most significant bits first)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2")[:, :w * c].astype(np.uint16).reshape(h, w, c)
    if depth == 8:
        return rows[:, :w * c].reshape(h, w, c)
    bits = np.unpackbits(rows, axis=1)[:, :w * c * depth].reshape(h, w, c, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=3, dtype=np.uint8)


def read_png(path: str) -> np.ndarray:
    """:func:`decode_png` of the file at ``path``."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "the PNG data") -> np.ndarray:
    """The bytes of any PNG -> its pixels: ``[H, W]`` grey, ``[H, W, 2]``
    grey + alpha, ``[H, W, 3]`` RGB, ``[H, W, 4]`` RGBA. Palette images come
    out RGB, or RGBA with a ``tRNS`` chunk (indices past the palette are
    black, as PIL pads it). Sub-byte grey is scaled to 0..255 (x 255, 85,
    17), as PIL opens it; 16-bit files come out uint16, every other one
    uint8. Adam7 interlaced files are reassembled. A file PNG does not allow
    raises, naming ``path``."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, header, palette, trns, idat = 8, None, None, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    w, h, depth, color, _, _, interlace = header
    if depth not in _DEPTHS.get(color, ()) or interlace > 1:
        raise ValueError(
            f"{path}: a {depth}-bit {_COLOR_NAMES.get(color, f'color type {color}')} PNG"
            f"{f' with interlace method {interlace}' if interlace > 1 else ''}, "
            "which PNG does not define")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: a palette PNG without a PLTE chunk")
    c = _CHANNELS[color]
    bpp = max(1, c * depth // 8)
    raw = zlib.decompress(b"".join(idat))
    if interlace:
        px = np.zeros((h, w, c), np.uint16 if depth == 16 else np.uint8)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
            if pw == 0 or ph == 0:
                continue  # an empty pass has no scanlines at all
            rows, off = _unfilter(raw, off, ph, (pw * c * depth + 7) // 8, bpp, path)
            px[y0::dy, x0::dx] = _samples(rows, pw, c, depth)
    else:
        rows, _ = _unfilter(raw, 0, h, (w * c * depth + 7) // 8, bpp, path)
        px = _samples(rows, w, c, depth)
    if color == 3:
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        n = min(256, len(palette) // 3)
        pal[:n, :3] = np.frombuffer(palette, np.uint8, 3 * n).reshape(n, 3)
        if trns is not None:
            pal[:len(trns[:256]), 3] = np.frombuffer(trns[:256], np.uint8)
        return pal[px[:, :, 0]][:, :, :4 if trns is not None else 3]
    if color == 0:
        px = px[:, :, 0]
        if depth < 8:
            px = px * np.uint8(255 // ((1 << depth) - 1))
    return px


def read_image(path: str) -> np.ndarray:
    """An image file -> uint8 ``[H, W, 3]`` RGB, as PIL's
    ``Image.open(path).convert("RGB")`` gives it: grey repeated, alpha
    dropped; from 16 bits, grey clipped to 255 (PIL's ``I;16`` to ``RGB``)
    and every other kind its high byte. A JPEG or WEBP goes through PIL."""
    if path.lower().endswith((".jpg", ".jpeg", ".webp")):
        with open(path, "rb") as f:
            return _pil_rgb(f.read(), path)
    return _rgb(read_png(path))


def image_from_bytes(data: bytes, name: str = "the image") -> np.ndarray:
    """The bytes of an image file -> uint8 ``[H, W, 3]`` RGB, as
    :func:`read_image` reads the file: a PNG (told by its signature) without
    PIL, any other format through PIL, which raises naming ``name`` when
    PIL is not installed."""
    if data[:8] == _PNG_SIGNATURE:
        return _rgb(decode_png(data, name))
    return _pil_rgb(data, name)


def _pil_rgb(data: bytes, name: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{name}: reading an image that is not a PNG (a JPEG or WEBP) "
                           "needs PIL, which is not installed") from e
    import io

    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"))


def _rgb(a: np.ndarray) -> np.ndarray:
    """:func:`decode_png`'s pixels -> uint8 RGB, as PIL's ``convert``."""
    if a.dtype == np.uint16:
        a = (np.minimum(a, 255) if a.ndim == 2 else a >> 8).astype(np.uint8)
    if a.ndim == 2:
        return np.repeat(a[:, :, None], 3, axis=2)
    if a.shape[2] == 2:
        return np.repeat(a[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(a[:, :, :3])


# PIL's 8-bit resampling (libImaging/Resample.c): coefficients in fixed
# point with this many fraction bits, rounded and clipped after each pass
_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic_filter (a = -0.5), in its order of operations."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _resample_axis(a: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One pass of PIL's two-pass resize along ``axis`` of a uint8 array:
    precompute_coeffs and normalize_coeffs_8bpc, then each output sample
    as the fixed-point sum of its taps, rounded and clipped to uint8."""
    in_size = a.shape[axis]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = _bicubic(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):  # in order, as the C loop sums
        ww += w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    k = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << _PRECISION_BITS)).astype(np.int64)
    idx = np.minimum(xmin[:, None] + taps[None, :], in_size - 1)  # past xmax: weight 0
    src = np.moveaxis(a, axis, -1)
    acc = (src[..., idx].astype(np.int64) * k).sum(-1) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def resize_bicubic_uint8(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 ``[H, W, C]`` -> uint8 ``[h, w, C]`` for ``size = (h, w)``, on the
    host: PIL's ``resize((w, h), BICUBIC)`` (its default filter) bit for
    bit, in numpy: the horizontal pass, then the vertical one, each skipped
    where the size stays."""
    a = np.ascontiguousarray(arr)
    h, w = size
    if a.shape[1] != w:
        a = _resample_axis(a, 1, w)
    if a.shape[0] != h:
        a = _resample_axis(a, 0, h)
    return np.array(a)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Float ``[N, H, W, C]`` -> ``[N, h, w, C]`` on ``x``'s device: the
    counterpart of ``jax.image.resize(x, (N, h, w, C), "bilinear")``."""
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                        antialias=True, align_corners=False)
    return out.permute(0, 2, 3, 1)
