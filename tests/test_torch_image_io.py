"""``utils/image_io.read_png`` and ``read_image`` against PIL: every kind of
PNG that PIL opens (palette with and without ``tRNS``, grey + alpha, bit
depths 1, 2, 4 and 16, Adam7 interlace) must read as PIL's
``Image.open(p).convert("RGB")``, bit for bit. Files PIL can write are
written by PIL; the others (sub-byte grey, 16-bit colour, every interlaced
file) by :func:`raw_png` below, with all five row filters, and PIL reads
them as the truth."""

import struct
import zlib

import numpy as np
import pytest

pytestmark = pytest.mark.filterwarnings("ignore:Palette images with Transparency")

Image = pytest.importorskip("PIL.Image")

from sjd_tpu_torch.utils import image_io  # noqa: E402

COLOR = {1: 0, 2: 4, 3: 2, 4: 6}  # samples per pixel -> PNG color type (not palette)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """samples [h, w, c] -> unfiltered scanline bytes [h, stride]."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, w * c).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    bits = (samples.reshape(h, w * c, 1) >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _filter(rows: np.ndarray, bpp: int, first_kind: int) -> bytes:
    """Filter each row with kind (first_kind + y) % 5."""
    out, prev = [], np.zeros(rows.shape[1], np.int64)
    for y, cur in enumerate(rows.astype(np.int64)):
        kind = (first_kind + y) % 5
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        out.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def raw_png(samples: np.ndarray, depth: int, *, color=None, interlace=False, palette=None,
            trns=None) -> bytes:
    """PNG bytes of ``samples`` [h, w, c] (palette indices when ``palette``)."""
    h, w, c = samples.shape
    color = 3 if palette is not None else COLOR[c] if color is None else color
    bpp = max(1, c * depth // 8)
    if interlace:
        parts = []
        for i, (x0, y0, dx, dy) in enumerate(ADAM7):
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                parts.append(_filter(_pack(sub, depth), bpp, i))
        data = b"".join(parts)
    else:
        data = _filter(_pack(samples, depth), bpp, 0)
    extra = (_chunk(b"PLTE", palette) if palette is not None else b"") + (
        _chunk(b"tRNS", trns) if trns is not None else b"")
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
            + extra + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b""))


def _pixels(shape, high, seed):
    rs = np.random.RandomState(seed)
    a = rs.randint(0, high, shape)
    a[::3] = a[::3, :1]  # flat rows among noisy ones
    return a


def _same_as_pil(path) -> np.ndarray:
    with Image.open(path) as img:
        want = np.asarray(img.convert("RGB"))
    got = image_io.read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return want


PALETTE = (np.random.RandomState(7).rand(256, 3) * 255).astype(np.uint8)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("transparency", [False, True], ids=["opaque", "tRNS"])
def test_palette_pngs_written_by_pil(tmp_path, bits, transparency):
    n = 1 << bits
    idx = _pixels((19, 23), n, bits).astype(np.uint8)
    img = Image.fromarray(idx, "P")
    img.putpalette(PALETTE[:n].tobytes())
    kw = {"bits": bits} if bits < 8 else {}
    if transparency:
        kw["transparency"] = bytes((np.arange(n) * 37 % 256).astype(np.uint8))
    img.save(tmp_path / "p.png", **kw)
    with Image.open(tmp_path / "p.png") as back:
        assert back.mode == "P" and ("transparency" in back.info) == transparency
    _same_as_pil(tmp_path / "p.png")
    got = image_io.read_png(str(tmp_path / "p.png"))
    assert got.shape == (19, 23, 4 if transparency else 3)
    np.testing.assert_array_equal(got[:, :, :3], PALETTE[idx])


def test_palette_indices_past_the_palette_are_black(tmp_path):
    idx = np.arange(12, dtype=np.uint8).reshape(3, 4)
    path = tmp_path / "short.png"
    path.write_bytes(raw_png(idx[:, :, None], 8, palette=PALETTE[:5].tobytes(), trns=b"\x00\x80"))
    want = _same_as_pil(path)
    assert (want[idx >= 5] == 0).all()


@pytest.mark.parametrize("mode,shape,dtype,high", [
    ("LA", (21, 17, 2), np.uint8, 256), ("1", (13, 29), bool, 2),
    ("I;16", (15, 11), np.uint16, 65536), ("I;16", (15, 11), np.uint16, 300)],
    ids=["grey_alpha", "1bit", "16bit_grey", "16bit_grey_low"])
def test_grey_pngs_written_by_pil(tmp_path, mode, shape, dtype, high):
    a = _pixels(shape, high, 3).astype(dtype)
    Image.fromarray(a).save(tmp_path / "g.png")
    with Image.open(tmp_path / "g.png") as back:
        assert back.mode == mode
    want = _same_as_pil(tmp_path / "g.png")
    if mode == "I;16":  # PIL clips 16-bit grey to 255 rather than scaling it
        np.testing.assert_array_equal(want[:, :, 0], np.minimum(a, 255))
        np.testing.assert_array_equal(image_io.read_png(str(tmp_path / "g.png")), a)


KINDS = [(1, d) for d in (1, 2, 4, 8, 16)] + [(c, d) for c in (2, 3, 4) for d in (8, 16)]


@pytest.mark.parametrize("channels,depth", KINDS, ids=[f"{c}ch{d}bit" for c, d in KINDS])
@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
def test_every_depth_and_kind_with_every_filter(tmp_path, depth, channels, interlace):
    a = _pixels((13, 11, channels), 1 << depth, depth + channels)
    path = tmp_path / "k.png"
    path.write_bytes(raw_png(a, depth, interlace=interlace))
    _same_as_pil(path)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("h,w", [(1, 1), (3, 5), (9, 17)])
def test_interlaced_palettes_and_small_sides(tmp_path, bits, h, w):
    """Adam7 with empty passes (sides under 8) and sub-byte rows."""
    idx = _pixels((h, w, 1), 1 << bits, h * w + bits)
    path = tmp_path / "i.png"
    path.write_bytes(raw_png(idx, bits, interlace=True, palette=PALETTE[:1 << bits].tobytes(),
                             trns=b"\x10\x20"))
    _same_as_pil(path)


def test_grey_and_rgb_with_trns_drop_it(tmp_path):
    for name, a, trns in (("g.png", _pixels((6, 7, 1), 256, 1), b"\x00\x05"),
                          ("c.png", _pixels((6, 7, 3), 256, 2), b"\x00\x05\x00\x06\x00\x07")):
        (tmp_path / name).write_bytes(raw_png(a, 8, trns=trns))
        _same_as_pil(tmp_path / name)


def test_webp_and_jpeg_need_pil_and_name_the_file(tmp_path, monkeypatch):
    import sys

    a = (np.random.RandomState(0).rand(16, 16, 3) * 255).astype(np.uint8)
    Image.fromarray(a).save(tmp_path / "0.webp")
    _same_as_pil(tmp_path / "0.webp")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="0.webp"):
        image_io.read_image(str(tmp_path / "0.webp"))
