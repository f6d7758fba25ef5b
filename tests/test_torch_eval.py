"""The port's evaluation path (sjd_tpu_torch/eval: datasets, metrics,
harness, latency, the eval_model and recon_eval command lines, and
utils/image_io) against sjd_tpu on the same inputs:

  * datasets: equal records from a Parti-layout TSV (quoted fields,
    doubled quotes, tabs inside quotes, blank lines, pandas' missing-value
    strings) and a COCO captions JSON; ``shard_prompts`` equal over a
    hypothesis range of sizes, nodes and workers; ``workdir_name`` equal;
  * metrics: FID, IS and CLIPScore within 1e-10 (the same numpy/scipy
    code); the pixel extractors bit-equal; ``evaluate_quantitative_scores``
    on PIL-written PNG directories within 1e-10;
  * image_io: PNG round trips bit-equal both ways against PIL (RGB, RGBA,
    grey; ``optimize=True``), all five row filters, JPEG through PIL and an
    error naming the file without it; the bilinear resize within 1e-5 of
    ``jax.image.resize`` (on [0, 1]); the uint8 bicubic resize against
    PIL's BICUBIC on uniform noise, the hardest case: to 256 px within 1 LSB
    on at most 0.05% of the values (bit-equal from 256), to 224 px within 2
    LSB on at most 1% (measured: 1 LSB on 0.33-0.57%);
  * the harness: ``run_prompt_set`` and ``run_prompt_set_batched`` in token
    and embedding mode on converted tiny params (after
    tests/test_data_eval.py:70, :167 and :216): greedy records give the JAX
    harness's tokens, so pixel-equal PNGs, and the resume skips them;
  * ``decode_step_latencies``: the same keys on a tiny config;
  * the command lines on the CPU: the JSON lines' keys equal to the JAX
    scripts'; ``recon_eval`` feeds the [0, 1] images to the encoder as the
    JAX script does, and gives its rFID and PSNR."""

import importlib.util
import json
import os
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import jax
import jax.numpy as jnp

from ckpt_synth import save_torch_pt, synth_vqgan_state_dict
from helpers import TINY, TINY_GRAMMAR, make_engine
from sjd_tpu.core import SamplingParams as JaxSamplingParams
from sjd_tpu.eval import datasets as jds
from sjd_tpu.eval import harness as jh
from sjd_tpu.eval import latency as jlat
from sjd_tpu.eval import metrics as jm
from sjd_tpu.models.llamagen import embed_class as jembed_class
from sjd_tpu.models.llamagen import embed_uncond_class as jembed_uncond_class
from sjd_tpu_torch.convert import decoder_config_from_jax, vq_config_from_jax
from sjd_tpu_torch.eval import datasets as pds
from sjd_tpu_torch.eval import eval_model, recon_eval
from sjd_tpu_torch.eval import harness as ph
from sjd_tpu_torch.eval import latency as plat
from sjd_tpu_torch.eval import metrics as pm
from sjd_tpu_torch.models import llamagen as pl
from sjd_tpu_torch.utils import image_io
from test_torch_checkpoint import LLAMAGEN_VQ
from test_torch_llamagen import _engines, _models
from test_torch_lumina_slice import TINY_CHAMELEON, TINY_CHAMELEON_VQ
from test_torch_serving import engine, grid_prompt

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 120


# --------------------------------------------------------------------------
# datasets
# --------------------------------------------------------------------------

PARTI_TSV = (
    "Prompt\tCategory\tChallenge\tNote\n"
    '"a ""quoted"" fox\twith a tab inside"\tAnimals\tBasic\t\n'
    "\n"
    "a plain prompt with, commas\tArts\tFine-grained Detail\tsome note\n"
    "NA\tX\tY\tZ\n"
    "null\tX\tY\t\n"
    "\tEmpty\tY\tZ\n"
    '"NA"\tQuoted NA\tY\tZ\n'
    "  spaced prompt \tX\tY\tZ\n"
    "\n"
    "short row\n"
    "None\tX\tY\tZ\n"
)


def records(recs):
    return [(r.index, r.prompt, r.negative_prompt) for r in recs]


def test_parti_tsv_equals_pandas(tmp_path):
    path = tmp_path / "parti.tsv"
    path.write_text(PARTI_TSV)
    want = records(jds.load_parti_prompts(str(path)))
    got = records(pds.load_parti_prompts(str(path)))
    assert got == want
    assert got[0][1] == 'a "quoted" fox\twith a tab inside' and len(got) == 9
    assert records(pds.create_dataset("parti", str(path))) == want


def test_coco_captions_equal(tmp_path):
    ann = {"annotations": [
        {"image_id": 42, "caption": "A dog. "}, {"image_id": 7, "caption": " a cat on a mat"},
        {"image_id": 42, "caption": "A big brown dog on grass"},
        {"image_id": 7, "caption": "a cat on a hat"},  # a tie keeps the first
        {"image_id": 3, "caption": "boats"}]}
    path = tmp_path / "captions.json"
    path.write_text(json.dumps(ann))
    want = records(jds.create_dataset("coco", str(path)))
    assert records(pds.create_dataset("coco", str(path))) == want
    assert [p for _, p, _ in want] == ["boats", "a cat on a mat", "A big brown dog on grass"]


@settings(max_examples=60, deadline=None)
@given(n=st.integers(0, 60), nodes=st.integers(1, 4), workers=st.integers(1, 4),
       data=st.data())
def test_shard_prompts_equal(n, nodes, workers, data):
    node = data.draw(st.integers(0, nodes - 1))
    worker = data.draw(st.integers(0, workers - 1))
    kw = dict(node_id=node, num_nodes=nodes, worker_id=worker, num_workers=workers)
    want = jds.shard_prompts([jds.PromptRecord(i, str(i)) for i in range(n)], **kw)
    got = pds.shard_prompts([pds.PromptRecord(i, str(i)) for i in range(n)], **kw)
    assert records(got) == records(want)


def test_workdir_name_equal():
    kw = dict(ds="coco", size=768, window=16, cfg=3.0, topk=2000, scheme="a/b", seed=42)
    assert ph.workdir_name("lumina_mgpt", **kw) == jh.workdir_name("lumina_mgpt", **kw)


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------


def close(a, b, tol=1e-10):
    assert abs(a - b) <= tol * max(1.0, abs(b)), (a, b)


@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("N", [8, 100])
def test_metric_math_equal(D, N):
    rs = np.random.RandomState(D + N)
    a, b = rs.randn(N, D), rs.randn(N, D) * 1.3 + 0.5
    close(pm.frechet_distance(a, b), jm.frechet_distance(a, b))
    logits = rs.randn(N, D) * 3
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for x, y in zip(pm.inception_score(probs), jm.inception_score(probs)):
        close(x, y)
    close(pm.clip_score(a, b), jm.clip_score(a, b))


def test_pixel_extractors_equal():
    imgs = np.random.RandomState(0).rand(6, 40, 36, 3).astype(np.float32)
    np.testing.assert_array_equal(pm.make_pixel_extractor()(imgs),
                                  jm.make_pixel_extractor()(imgs))
    np.testing.assert_array_equal(pm.make_pixel_probs()(imgs), jm.make_pixel_probs()(imgs))


def write_pil_dir(d, n, seed, modes=("RGB",), side=32):
    """``n`` PIL-written PNGs named {i}.png (numeric order matters past 9)."""
    d.mkdir()
    rs = np.random.RandomState(seed)
    for i in range(n):
        mode = modes[i % len(modes)]
        shape = (side, side) if mode == "L" else (side, side, len(mode))
        Image.fromarray((rs.rand(*shape) * 255).astype(np.uint8), mode).save(
            d / f"{i}.png", optimize=bool(i % 2))
    return str(d)


def test_quantitative_scores_on_pil_png_dirs_equal(tmp_path):
    gen = write_pil_dir(tmp_path / "gen", 12, 0, modes=("RGB", "RGBA", "L"))
    ref = write_pil_dir(tmp_path / "ref", 5, 1)
    kw = dict(feature_fn=jm.make_pixel_extractor(), probs_fn=jm.make_pixel_probs())
    want = jm.evaluate_quantitative_scores(gen, ref, **kw)
    got = pm.evaluate_quantitative_scores(gen, ref, feature_fn=pm.make_pixel_extractor(),
                                          probs_fn=pm.make_pixel_probs())
    assert got.keys() == want.keys() and got["n_images"] == 12
    for k in want:
        close(got[k], want[k])
    np.testing.assert_array_equal(pm.load_image_dir(gen), jm.load_image_dir(gen))
    # resized on the host: PIL's BICUBIC against the uint8 interpolation
    diff = np.abs(pm.load_image_dir(gen, size=24) - jm.load_image_dir(gen, size=24)) * 255
    assert diff.max() <= 2 + 1e-4


# --------------------------------------------------------------------------
# image_io
# --------------------------------------------------------------------------

MODE_SHAPES = {"RGB": (37, 53, 3), "RGBA": (20, 31, 4), "L": (17, 9)}


def sample_image(mode, seed=0):
    rs = np.random.RandomState(seed)
    a = (rs.rand(*MODE_SHAPES[mode]) * 255).astype(np.uint8)
    a[::3] = np.arange(a.shape[1], dtype=np.uint8)[:, None] if a.ndim == 3 else np.arange(
        a.shape[1], dtype=np.uint8)  # smooth rows, where PIL picks other filters
    return a


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("mode", list(MODE_SHAPES))
def test_png_round_trips_against_pil(tmp_path, mode, optimize):
    a = sample_image(mode)
    Image.fromarray(a, mode).save(tmp_path / "pil.png", optimize=optimize)
    np.testing.assert_array_equal(image_io.read_png(str(tmp_path / "pil.png")), a)
    image_io.write_png(str(tmp_path / "port.png"), a)
    assert not (tmp_path / "port.png.tmp").exists()
    with Image.open(tmp_path / "port.png") as img:
        assert img.mode == mode
        np.testing.assert_array_equal(np.asarray(img), a)


def filtered_png(a, kind, interlace=0):
    """PNG bytes of uint8 ``a`` with every row under filter ``kind``."""
    h, w = a.shape[:2]
    c = 1 if a.ndim == 2 else a.shape[2]
    x = a.reshape(h, w * c).astype(np.int64)
    prev, out = np.zeros(w * c, np.int64), []
    for y in range(h):
        cur = x[y]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
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
    color = {1: 0, 3: 2, 4: 6}[c]

    def chunk(k, d):
        return struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, interlace))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", range(5))
@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_png_reads_every_row_filter(tmp_path, mode, kind):
    a = sample_image(mode, seed=kind)
    path = tmp_path / "f.png"
    path.write_bytes(filtered_png(a, kind))
    with Image.open(path) as img:  # the file is valid PNG
        np.testing.assert_array_equal(np.asarray(img), a)
    np.testing.assert_array_equal(image_io.read_png(str(path)), a)


def test_png_refuses_what_it_does_not_read(tmp_path):
    """Palette, 16-bit and interlaced files are read (tests/test_torch_image_io.py);
    what PNG does not define is refused, with its format named."""
    good = filtered_png(sample_image("RGB"), 0)

    def with_header(depth, color, interlace=0):
        ihdr = struct.pack(">IIBBBBB", 53, 37, depth, color, 0, 0, interlace)
        body = b"IHDR" + ihdr
        return (good[:8] + struct.pack(">I", 13) + body + struct.pack(">I", zlib.crc32(body))
                + good[33:])

    for name, data, words in (
            ("rgb4.png", with_header(4, 2), "4-bit RGB"),
            ("p16.png", with_header(16, 3), "16-bit palette"),
            ("c5.png", with_header(8, 5), "color type 5"),
            ("i2.png", with_header(8, 2, interlace=2), "interlace method 2"),
            ("nopal.png", with_header(8, 3), "without a PLTE"),
            ("jpeg.png", b"\xff\xd8\xff\xe0" + good[4:], "not a PNG")):
        (tmp_path / name).write_bytes(data)
        with pytest.raises(ValueError, match=words):
            image_io.read_png(str(tmp_path / name))


def test_jpeg_through_pil_and_never_skipped_without_it(tmp_path, monkeypatch):
    a = (np.random.RandomState(0).rand(24, 16, 3) * 255).astype(np.uint8)
    d = tmp_path / "ref"
    d.mkdir()
    Image.fromarray(a).save(d / "0.jpg", quality=90)
    Image.fromarray(a).save(d / "1.png")
    with Image.open(d / "0.jpg") as img:
        want = np.asarray(img.convert("RGB"))
    np.testing.assert_array_equal(image_io.read_image(str(d / "0.jpg")), want)
    np.testing.assert_array_equal(pm.load_image_dir(str(d)), jm.load_image_dir(str(d)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="0.jpg"):
        pm.load_image_dir(str(d))


@pytest.mark.parametrize("side", [64, 128, 512])
def test_bilinear_resize_equals_jax_image_resize(side):
    x = np.random.RandomState(side).rand(2, side, side, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), method="bilinear"))
    got = image_io.resize_bilinear(torch.from_numpy(x), (299, 299)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("side", [256, 512, 768])
def test_bicubic_uint8_resize_against_pil(side):
    a = (np.random.RandomState(side).rand(side, side, 3) * 255).astype(np.uint8)
    for out, max_lsb, share in ((256, 1, 0.0005), (224, 2, 0.01)):
        want = np.asarray(Image.fromarray(a).resize((out, out), Image.BICUBIC)).astype(int)
        lsb = np.abs(image_io.resize_bicubic_uint8(a, (out, out)).astype(int) - want)
        assert lsb.max() <= max_lsb and (lsb > 0).mean() <= share, (out, lsb.max())


# --------------------------------------------------------------------------
# the harness
# --------------------------------------------------------------------------


def image_of(toks):
    """A token row -> uint8 [4, 8, 3]: its last 8 tokens before the image end
    (49; a multi-token step may commit tokens past it), tiled."""
    toks = [int(t) for t in toks]
    toks = toks[:toks.index(49)] if 49 in toks else toks
    px = (np.asarray(toks[-8:], np.int64) * 5 % 256).astype(np.uint8)
    return np.stack([np.tile(px, (4, 1)), np.tile(px[::-1], (4, 1)), np.tile(px, (4, 1)) // 2],
                    axis=-1)


class FakeModel:
    def __init__(self, engine, params, extras, sample_fn=None):
        self.engine, self.params, self.extras, self.sample_fn = engine, params, extras, sample_fn


def grid_prompt_of(prompt):
    return grid_prompt(53 + len(prompt) % 2)  # the size token from the text: 2x2 or 4x4


RECORDS = [pds.PromptRecord(index=i, prompt="p" * (i + 1)) for i in range(5)]
JAX_RECORDS = [jds.PromptRecord(index=i, prompt="p" * (i + 1)) for i in range(5)]


@pytest.fixture(scope="module")
def tiny_pair():
    from helpers import tiny_params
    from sjd_tpu_torch.convert import params_from_jax
    from test_torch_serving import CFG

    jparams = tiny_params()
    jeng = make_engine(window=5, max_len=64, grammar=TINY_GRAMMAR, eos_id=49,
                       sampling=JaxSamplingParams(do_cfg=False, image_top_k=44,
                                                  text_top_k=60, greedy=True))
    return jeng, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                                          device="cpu")


def read_dir(d):
    return {n: image_io.read_png(os.path.join(d, n)) for n in sorted(os.listdir(d))
            if n.endswith(".png")}


def assert_same_pngs(got_dir, want_dir, n):
    got, want = read_dir(got_dir), read_dir(want_dir)
    assert sorted(got) == sorted(want) == sorted(f"{i}.png" for i in range(n))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_run_prompt_set_greedy_equals_jax_and_resumes(tiny_pair, tmp_path):
    jeng, jparams, params = tiny_pair
    eng = engine(greedy=True)

    def jax_sample(prompt):
        res = jeng.generate(jparams, jax.random.PRNGKey(0),
                            jnp.asarray([grid_prompt_of(prompt)], jnp.int32))
        return Image.fromarray(image_of(np.asarray(res.tokens[0, :int(res.length[0])])))

    def sample(prompt):
        res = eng.generate(params, 0, torch.tensor([grid_prompt_of(prompt)]))
        return image_of(res.tokens[0, :int(res.length[0])].numpy())

    want = jh.run_prompt_set(jax_sample, JAX_RECORDS, str(tmp_path / "jax"), log_every=0)
    got = ph.run_prompt_set(sample, RECORDS, str(tmp_path / "port"), log_every=0,
                            stats_path=str(tmp_path / "stats.json"))
    assert got.keys() == want.keys() and got["generated"] == want["generated"] == 5
    assert json.loads((tmp_path / "stats.json").read_text()) == got
    assert_same_pngs(str(tmp_path / "port"), str(tmp_path / "jax"), 5)
    again = ph.run_prompt_set(sample, RECORDS, str(tmp_path / "port"), log_every=0)
    assert again["generated"] == 0 and again["skipped_existing"] == 5


def test_run_prompt_set_batched_token_mode_equals_jax_and_resumes(tiny_pair, tmp_path):
    from sjd_tpu_torch.core.grammar import init_state

    jeng, jparams, params = tiny_pair
    want_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jmodel = FakeModel(jeng, jparams, {
        "prompt_ids_fn": grid_prompt_of,
        "decode_image_fn": lambda toks: Image.fromarray(image_of(toks))})
    want = jh.run_prompt_set_batched(jmodel, JAX_RECORDS, want_dir, slots=2, chunk_steps=8,
                                     log_every=0)
    metas = []

    def make_gstate(m):
        metas.append(list(m))
        return init_state(len(m), device="cpu")

    model = FakeModel(engine(greedy=True), params, {
        "prompt_ids_fn": grid_prompt_of, "decode_image_fn": image_of,
        "make_gstate": make_gstate})
    got = ph.run_prompt_set_batched(model, RECORDS, got_dir, slots=2, chunk_steps=8,
                                    log_every=0)
    assert got.keys() == want.keys() and got["generated"] == want["generated"] == 5
    assert metas and all(m == [None, None] for m in metas)
    assert_same_pngs(got_dir, want_dir, 5)
    # the resume: one missing image is made again, equal; then nothing is
    os.remove(os.path.join(got_dir, "3.png"))
    again = ph.run_prompt_set_batched(model, RECORDS, got_dir, slots=2, chunk_steps=8,
                                      log_every=0)
    assert (again["generated"], again["skipped_existing"]) == (1, 4)
    assert_same_pngs(got_dir, want_dir, 5)
    none = ph.run_prompt_set_batched(model, RECORDS, got_dir, slots=2, log_every=0)
    jnone = jh.run_prompt_set_batched(jmodel, JAX_RECORDS, want_dir, slots=2, log_every=0)
    assert none == jnone == {"generated": 0, "skipped_existing": 5, "images_per_min": None}


def test_run_prompt_set_batched_embed_mode_equals_jax(tmp_path):
    cfg, jeng, eng = _engines(1)
    jparams, cond, params, pc = _models(cfg, "c2i")
    block = 16

    def jax_embed(prompt):
        label = jnp.asarray([int(prompt)], jnp.int32)
        return jembed_class(cond, label, jnp.float32), jembed_uncond_class(cond, 1,
                                                                           jnp.float32), None

    def embed(prompt):
        label = torch.tensor([int(prompt)])
        return pl.embed_class(pc, label, torch.float32), pl.embed_uncond_class(
            pc, 1, torch.float32), None

    def decode(toks):
        return image_of(list(toks)[1:1 + block])

    extras = {"prompt_width": 1, "embed_dim": cfg.hidden_size}
    jmodel = FakeModel(jeng, jparams, dict(
        extras, embed_prompt_fn=jax_embed,
        decode_image_fn=lambda toks: Image.fromarray(decode(toks))))
    model = FakeModel(eng, params, dict(extras, embed_prompt_fn=embed, decode_image_fn=decode))
    recs = [pds.PromptRecord(index=i, prompt=str((3 * i) % 10)) for i in range(11)]
    jrecs = [jds.PromptRecord(index=r.index, prompt=r.prompt) for r in recs]
    want = jh.run_prompt_set_batched(jmodel, jrecs, str(tmp_path / "jax"), slots=2,
                                     chunk_steps=4, log_every=0)
    got = ph.run_prompt_set_batched(model, recs, str(tmp_path / "port"), slots=2,
                                    chunk_steps=4, log_every=0)
    assert got.keys() == want.keys() and got["generated"] == want["generated"] == 11
    assert_same_pngs(str(tmp_path / "port"), str(tmp_path / "jax"), 11)
    again = ph.run_prompt_set_batched(model, recs, str(tmp_path / "port"), slots=2,
                                      log_every=0)
    assert (again["generated"], again["skipped_existing"]) == (0, 11)


# --------------------------------------------------------------------------
# latency
# --------------------------------------------------------------------------


def test_decode_step_latencies_same_keys(tiny_pair):
    from test_torch_serving import CFG

    _, jparams, params = tiny_pair
    kw = dict(batch=2, window=4, buf_len=48, cache_fill=10, iters=2)
    want = jlat.decode_step_latencies(TINY, jparams, **kw)
    got = plat.decode_step_latencies(CFG, params, device="cpu", **kw)
    assert list(got) == list(want) == list(plat.default_variants(CFG))
    assert all(isinstance(v, float) and v > 0 for v in got.values())


# --------------------------------------------------------------------------
# the command lines
# --------------------------------------------------------------------------


def load_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_eval_model_cli_on_cpu(tmp_path, monkeypatch, capsys):
    from sjd_tpu_torch import loader

    captions = {"annotations": [{"image_id": i, "caption": f"caption {i} " * (i + 1)}
                                for i in range(4)]}
    (tmp_path / "coco.json").write_text(json.dumps(captions))
    ref = write_pil_dir(tmp_path / "ref", 3, 2, side=64)
    tiny = dict(model_cfg=decoder_config_from_jax(TINY_CHAMELEON),
                vq_cfg=vq_config_from_jax(TINY_CHAMELEON_VQ))
    monkeypatch.setattr(eval_model, "load_pretrained_model",
                        lambda name, **kw: loader.load_pretrained_model(name, **kw, **tiny))
    common = ["--model", "lumina_mgpt", "--target-size", "64", "--dataset", "coco",
              "--dataset-path", str(tmp_path / "coco.json"), "--max-prompts", "2",
              "--fid-reference-dir", ref, "--smoke-extractor", "--device", "cpu"]
    out = {}
    for name, extra in (("solo", []), ("batched", ["--slots", "2", "--chunk-steps", "8"])):
        eval_model.main(common + ["--workdir", str(tmp_path / name)] + extra)
        out[name] = json_lines(capsys.readouterr().out)
        assert len(out[name]) == 2 and out[name][0]["generated"] == 2
        imgs = read_dir(str(tmp_path / name))
        assert len(imgs) == 2 and all(a.shape == (64, 64, 3) for a in imgs.values())
    assert out["batched"][0]["slots"] == 2
    assert all(np.isfinite(v) for v in out["solo"][1].values())

    # the JAX script's lines, from a stand-in model that returns PIL images
    class Stub:
        def sample_fn(self, prompt):
            return Image.fromarray(np.zeros((64, 64, 3), np.uint8))

    monkeypatch.setattr("sjd_tpu.loader.load_pretrained_model", lambda name, **kw: Stub())
    monkeypatch.setattr(sys, "argv", ["eval_model.py"] + common[:-2]
                        + ["--workdir", str(tmp_path / "jax")])
    load_example("eval_model").main()
    want = json_lines(capsys.readouterr().out)
    assert [set(d) for d in out["solo"]] == [set(d) for d in want]


def test_recon_eval_cli_equals_jax_on_cpu(tmp_path, monkeypatch, capsys):
    from sjd_tpu_torch.models import vq as pvq

    ckpt = str(tmp_path / "vq.pt")
    save_torch_pt(synth_vqgan_state_dict(LLAMAGEN_VQ, seed=0, style="llamagen"), ckpt)
    imgs = write_pil_dir(tmp_path / "imgs", 4, 3)  # 32 px: no resize on either side
    monkeypatch.setattr("sjd_tpu.models.vq.LLAMAGEN_VQ16", LLAMAGEN_VQ)
    monkeypatch.setattr(pvq, "LLAMAGEN_VQ16", vq_config_from_jax(LLAMAGEN_VQ))
    monkeypatch.setattr("sjd_tpu.utils.compile_cache.enable_persistent_cache",
                        lambda *a, **k: None)
    seen = []
    real_encode = pvq.encode

    def encode(params, cfg, px):
        seen.append((float(px.min()), float(px.max())))
        return real_encode(params, cfg, px)

    monkeypatch.setattr(pvq, "encode", encode)
    args = ["--images", imgs, "--tokenizer", "llamagen", "--vq-ckpt", ckpt, "--size", "32",
            "--batch", "3", "--smoke-extractor"]
    recon_eval.main(args + ["--device", "cpu", "--out", str(tmp_path / "out")])
    (got,) = json_lines(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["recon_eval.py"] + args)
    load_example("recon_eval").main()
    (want,) = json_lines(capsys.readouterr().out)
    assert list(got) == list(want)
    assert {k: got[k] for k in ("tokenizer", "n", "smoke_weights", "smoke_extractor")} == {
        k: want[k] for k in ("tokenizer", "n", "smoke_weights", "smoke_extractor")}
    # the JAX script's range: the [0, 1] images enter the encoder as they are
    assert len(seen) == 2 and all(0.0 <= lo and hi <= 1.0 for lo, hi in seen)
    assert abs(got["psnr_db"] - want["psnr_db"]) <= 0.01 + 1e-9
    assert abs(got["rfid"] - want["rfid"]) <= 1e-3 * max(1.0, abs(want["rfid"]))
    assert len(read_dir(str(tmp_path / "out"))) == 4
