"""Image files and host-side resizes for the evaluation path, without PIL
(the machine with the GPU has none).

  * :func:`write_png` writes a uint8 ``[H, W, 3]`` or ``[H, W]`` array with
    the standard library's ``zlib``, atomically (a ``.tmp`` file, then
    ``os.replace``): a run cut mid-write leaves no truncated PNG that a
    resuming harness would take for a finished image.
  * :func:`read_png` reads 8-bit grey, RGB and RGBA, non-interlaced, with
    any of the five row filters, so files written by PIL or another tool
    read back; anything else is refused with its format named.
  * :func:`read_image` reads a PNG, or a JPEG through PIL (imported only
    then: without PIL a JPEG raises with the file's name, never skipped).
  * :func:`resize_bicubic_uint8` is the counterpart of PIL's
    ``resize(..., BICUBIC)``: ``F.interpolate(mode="bicubic",
    antialias=True)`` on a uint8 CPU tensor. :func:`resize_bilinear` is the
    counterpart of ``jax.image.resize(method="bilinear")`` on floats:
    ``F.interpolate(mode="bilinear", antialias=True, align_corners=False)``
    (without ``antialias`` a downsample samples instead of averaging).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_CHANNELS = {0: 1, 2: 3, 6: 4}  # grey, RGB, RGBA
_COLOR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey + alpha", 6: "RGBA"}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write a uint8 ``[H, W]``, ``[H, W, 3]`` or ``[H, W, 4]`` array to
    ``path`` as a PNG (every row with filter 0), through ``path + ".tmp"``
    and ``os.replace``."""
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
    data = (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))
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


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """The filtered scanlines -> [h, stride] uint8. None and Up are whole-row
    numpy; Sub is a per-channel running sum; Average and Paeth depend on the
    reconstructed left neighbour, so they run byte by byte."""
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: the image data is truncated")
    lines = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
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
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit grey (``[H, W]``), RGB (``[H, W, 3]``) or RGBA (``[H, W, 4]``)
    non-interlaced PNG -> uint8 array; any other PNG raises naming its
    format."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _COLOR_CHANNELS or interlace:
        raise ValueError(
            f"{path}: a {depth}-bit {_COLOR_NAMES.get(color, f'color type {color}')} PNG"
            f"{' (interlaced)' if interlace else ''}; only 8-bit grey, RGB and RGBA "
            "non-interlaced PNGs are read")
    c = _COLOR_CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c, path)
    return pixels.reshape(h, w) if c == 1 else pixels.reshape(h, w, c)


def read_image(path: str) -> np.ndarray:
    """A PNG or JPEG file -> uint8 ``[H, W, 3]`` RGB (grey repeated, alpha
    dropped: PIL's ``convert("RGB")``). A JPEG goes through PIL."""
    if path.lower().endswith((".jpg", ".jpeg")):
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(f"{path}: reading a JPEG needs PIL, which is not "
                               "installed") from e
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"))
    a = read_png(path)
    if a.ndim == 2:
        return np.repeat(a[:, :, None], 3, axis=2)
    return a[:, :, :3]


def resize_bicubic_uint8(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """uint8 ``[H, W, C]`` -> uint8 ``[h, w, C]`` for ``size = (h, w)``, on the
    host: the counterpart of PIL's ``resize((w, h), BICUBIC)``, which keeps
    an image of the same size as it is."""
    if tuple(arr.shape[:2]) == tuple(size):
        return np.array(arr)
    t = torch.from_numpy(np.ascontiguousarray(arr)).permute(2, 0, 1)[None]
    out = F.interpolate(t, size=tuple(size), mode="bicubic", antialias=True,
                        align_corners=False)
    return out[0].permute(1, 2, 0).contiguous().numpy()


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Float ``[N, H, W, C]`` -> ``[N, h, w, C]`` on ``x``'s device: the
    counterpart of ``jax.image.resize(x, (N, h, w, C), "bilinear")``."""
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                        antialias=True, align_corners=False)
    return out.permute(0, 2, 3, 1)
