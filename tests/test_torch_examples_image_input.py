"""The image paths the port's entry points take without PIL, against PIL and
sjd_tpu, on the CPU:

  * generate_image2image's command line against the JAX script (noise
    input; a PNG already at --input-size, so that neither side resizes), on
    the synthesized tiny checkpoint files of
    tests/test_torch_checkpoint.py:229-237, both loaders wrapped to take the
    tiny configurations, image top-k 1 (greedy image tokens) and the port's
    crc32 HashTokenizer (the JAX script's hash() changes with the process):
    the same input block and image tokens, saved images within 1 LSB;
  * ``image_grid`` on uint8 arrays equals sjd_tpu's on PIL images exactly;
  * ``resize_bicubic_uint8`` equals PIL's BICUBIC resize bit for bit, up
    and down, on noise, edges and gradients of random sizes; so
    ``_fit_to_crop`` on a uint8 array equals sjd_tpu's on the PIL image of
    the same pixels (the same crop box, size and pixels);
  * ``process_image`` of a uint8 array of any size is the float path on its
    fitted pixels; a float array off the 32 px grid still raises;
  * ``encode_png`` / ``decode_png`` round trips against PIL both ways (RGB,
    RGBA, grey), and ``write_png`` writes ``encode_png``'s bytes;
  * ``load_lumina_mgpt(vq_dtype=torch.bfloat16)`` against the JAX loader's
    ``vq_dtype=jnp.bfloat16`` on the same VQ file: bf16 weights (the
    codebook f32), and the same tokens decode to images within 6 uint8 LSB,
    0.5 LSB on average (each bf16 layer rounds its output, and the two
    convolutions sum in other orders; measured here: at most 4, on average
    0.32-0.36; the f32 decoders differ by at most 1).

About 22 s here alone, on one torch thread."""

import io

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from ckpt_synth import ChameleonFakeTokenizer
from sjd_tpu import loader as jax_loader
from sjd_tpu.data import item_processor as jitem
from sjd_tpu_torch.convert import decoder_config_from_jax, vq_config_from_jax
from sjd_tpu_torch.data import item_processor as item
from sjd_tpu_torch.data.image_processing import generate_crop_size_list
from sjd_tpu_torch.examples import generate_image2image
from sjd_tpu_torch.loader import load_lumina_mgpt
from sjd_tpu_torch.utils.image_io import decode_png, encode_png, resize_bicubic_uint8, write_png
from test_torch_checkpoint import lumina_files  # noqa: F401 - a fixture
from test_torch_examples import (  # noqa: F401 - one_torch_thread: an autouse fixture
    TARGET, Recorder, check_same, one_torch_thread, port_lumina, run_both)
from test_torch_lumina_slice import TINY_CHAMELEON, TINY_CHAMELEON_VQ


@pytest.mark.parametrize("source", ["noise", "png"])
def test_generate_image2image_equals_jax(lumina_files, monkeypatch, tmp_path,  # noqa: F811
                                         source, jax_i2i):
    _, ckpt_dir, vq_path = lumina_files
    args = ["--ckpt-dir", ckpt_dir, "--vq-ckpt", vq_path, "--target-size", str(TARGET),
            "--input-size", "64", "--seed", "5"]
    if source == "png":
        img = (np.random.RandomState(1).rand(64, 64, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / "in.png")
        args += ["--image", str(tmp_path / "in.png")]
    port_rec = port_lumina(image_top_k=1)
    out = run_both(monkeypatch, tmp_path, "generate_image2image", generate_image2image,
                   port_rec, jax_i2i, "load_lumina_mgpt", args)
    check_same(out, 1, n_spans=2)
    assert isinstance(port_rec.calls[0]["tokenizer"], generate_image2image.HashTokenizer)


@pytest.fixture(scope="module")
def jax_i2i():
    """The JAX Lumina loader on the tiny configurations with image top-k 1
    and the crc32 HashTokenizer, loaded once."""
    return Recorder(jax_loader.load_lumina_mgpt, memo=True, model_cfg=TINY_CHAMELEON,
                    vq_cfg=TINY_CHAMELEON_VQ, tokenizer=generate_image2image.HashTokenizer(),
                    image_top_k=1)


def smooth_image(h, w, seed):
    """uint8 [h, w, 3]: gradients with noise (a photograph's statistics
    more than uniform noise's)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([np.sin(6 * xx), np.cos(5 * yy), xx * yy * 2 - 1], -1) * 100 + 128
    return np.clip(img + 12 * rng.standard_normal(img.shape), 0, 255).astype(np.uint8)


def test_image_grid_of_arrays_equals_jax_on_pil_images():
    imgs = [(np.random.RandomState(i).rand(16, 24, 3) * 255).astype(np.uint8)
            for i in range(5)]
    for rows, cols in ((1, 5), (2, 3)):
        got = item.image_grid(imgs, rows, cols)
        want = np.asarray(jitem.image_grid([Image.fromarray(a) for a in imgs], rows, cols))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    # PIL images keep the PIL path
    pil = item.image_grid([Image.fromarray(a) for a in imgs[:2]], 1, 2)
    np.testing.assert_array_equal(np.asarray(pil), item.image_grid(imgs[:2], 1, 2))


def test_resize_bicubic_uint8_equals_pil():
    rng = np.random.default_rng(0)
    for trial in range(60):
        h, w, oh, ow = (int(v) for v in rng.integers(1, 160, 4))
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if trial % 2:  # edges: a black and white pattern
            a = (a > 127).astype(np.uint8) * 255
        want = np.asarray(Image.fromarray(a).resize((ow, oh), Image.BICUBIC))
        np.testing.assert_array_equal(resize_bicubic_uint8(a, (oh, ow)), want)


@pytest.mark.parametrize("hw", [(400, 500), (700, 300), (64, 64), (1100, 1500)])
def test_fit_to_crop_of_an_array_equals_jax_on_the_pil_image(hw):
    a = smooth_image(*hw, seed=hw[0])
    proc = item.FlexARItemProcessor(None)
    jproc = jitem.FlexARItemProcessor(None)
    got = proc._fit_to_crop(a)
    want = np.asarray(jproc._fit_to_crop(Image.fromarray(a)))
    rw, rh, left, top, cw, ch = proc.crop_box(hw[1], hw[0])
    assert got.shape == want.shape == (ch, cw, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # the PIL path is unchanged
    np.testing.assert_array_equal(np.asarray(proc._fit_to_crop(Image.fromarray(a))), want)


def test_process_image_of_a_uint8_array_is_the_float_path_on_its_fit():
    from sjd_tpu_torch.models.vq import init_vq_params

    vq_cfg = vq_config_from_jax(TINY_CHAMELEON_VQ)
    proc = item.FlexARItemProcessor(ChameleonFakeTokenizer(), vq_cfg=vq_cfg,
                                    vq_params=init_vq_params(1, vq_cfg, device="cpu"))
    proc.crop_size_list = generate_crop_size_list(4, 32)
    a = smooth_image(50, 70, seed=3)
    fitted = proc._fit_to_crop(a)
    assert fitted.shape[0] % 32 == 0 and fitted.shape[1] % 32 == 0
    block = proc.process_image(a)
    assert block == proc.process_image(fitted.astype(np.float32) / 127.5 - 1.0)
    with pytest.raises(ValueError, match="multiples of 32"):
        proc.process_image(a.astype(np.float32) / 127.5 - 1.0)


@pytest.mark.parametrize("channels", [3, 4, 1])
def test_png_bytes_round_trip_against_pil(tmp_path, channels):
    a = (np.random.RandomState(channels).rand(19, 23, channels) * 255).astype(np.uint8)
    a = a[:, :, 0] if channels == 1 else a
    data = encode_png(a)
    with Image.open(io.BytesIO(data)) as img:
        np.testing.assert_array_equal(np.asarray(img), a)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="PNG", optimize=True)
    np.testing.assert_array_equal(decode_png(buf.getvalue()), a)
    write_png(str(tmp_path / "a.png"), a)
    assert (tmp_path / "a.png").read_bytes() == data
    with pytest.raises(ValueError, match="upload 0"):
        decode_png(b"GIF89a", "upload 0")


def test_lumina_vq_dtype_bf16_equals_jax(lumina_files):  # noqa: F811
    _, _, vq_path = lumina_files
    kw = dict(vq_ckpt=vq_path, target_size=TARGET, tokenizer=ChameleonFakeTokenizer())
    jm = jax_loader.load_lumina_mgpt(model_cfg=TINY_CHAMELEON, vq_cfg=TINY_CHAMELEON_VQ,
                                     vq_dtype=jnp.bfloat16, **kw)
    pm = load_lumina_mgpt(model_cfg=decoder_config_from_jax(TINY_CHAMELEON),
                          vq_cfg=vq_config_from_jax(TINY_CHAMELEON_VQ),
                          vq_dtype=torch.bfloat16, device="cpu", **kw)
    vq = pm.extras["vq_params"]
    assert pm.extras["vq_cfg"].dtype == torch.bfloat16
    assert vq["codebook"].dtype == torch.float32
    assert vq["post_quant_conv_w"].dtype == torch.bfloat16
    grid = np.random.RandomState(0).randint(0, 8192, (4, 4))
    toks = item.image_block_from_grid(grid, TARGET, TARGET, mapping=pm.extras["mapping"])
    got = pm.extras["decode_image_fn"](toks)
    want = np.asarray(jm.extras["decode_image_fn"](toks))
    assert got.shape == want.shape == (TARGET, TARGET, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 6 and diff.mean() <= 0.5, (diff.max(), diff.mean())
