"""The port's command lines (sjd_tpu_torch/examples) against the JAX
scripts of examples/, on the CPU, run in-process with their argv (as
tests/test_torch_eval.py:490-570 runs eval_model and recon_eval); the
image-to-image command line is in test_torch_examples_image_input.py,
quant_fidelity in test_torch_examples_quant.py:

  * generate_lumina_mgpt (t2i, and --num-repeats 2) and generate_llamagen
    (c2i), on the synthesized tiny checkpoint files of
    tests/test_torch_checkpoint.py:229-237 and
    tests/test_torch_llamagen.py:254: both command lines with image top-k 1,
    which makes the image tokens greedy on both sides, give the same image
    tokens and saved images within 1 LSB. The loaders are wrapped to take
    the tiny configurations (and, for Lumina, the ChameleonFakeTokenizer on
    both sides: the JAX loader's placeholder ids hash with hash(), which
    changes with the process); the JAX model is loaded once, so its engine
    compiles once. The port's engine stops at <image_end>: the text random
    weights write after it is not compared;
  * generate_emu3: the saved image equals the port's loader's sample_fn on
    the same inputs; ``quantize`` reaches the loader only when given; the
    printed lines are the JAX script's (its loader a stand-in);
  * latency_budget and hbm_bw_probe at a tiny configuration and one block:
    the JAX scripts' key sets, finite values; with no CUDA the entry points
    raise.

About 37 s here alone, on one torch thread."""

import dataclasses
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from ckpt_synth import ChameleonFakeTokenizer, Emu3FakeTokenizer
from sjd_tpu import loader as jax_loader
from sjd_tpu_torch.convert import (
    decoder_config_from_jax, emu3_vq_config_from_jax, vq_config_from_jax)
from sjd_tpu_torch.data.item_processor import split_generation
from sjd_tpu_torch.examples import (
    generate_emu3, generate_llamagen, generate_lumina_mgpt, hbm_bw_probe, latency_budget,
    quant_fidelity)
from sjd_tpu_torch import loader
from sjd_tpu_torch.models.chameleon import IMAGE_END_ID
from test_torch_checkpoint import lumina_files  # noqa: F401 - a fixture
from test_torch_emu3 import TINY_EMU3, TINY_EMU3_VQ
from test_torch_eval import json_lines, load_example
from test_torch_llamagen import LATENT, TINY_VQ16, llamagen_files, tiny_cfg  # noqa: F401
from test_torch_lumina_slice import TINY_CHAMELEON, TINY_CHAMELEON_VQ

TARGET = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's CPU ops on one thread while this module runs: the suite runs
    six files at once, and the tiny models' ops, each spread over every
    core, oversubscribe them (this file took 456 s beside five other
    files, and 98 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def read(path):
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB")).astype(int)


def image_spans(rows):
    """Each generated row's image span, <image_start> to <image_end>."""
    return [[s for k, s in split_generation(list(map(int, r))) if k == "image"] for r in rows]


class Recorder:
    """Wraps a loader: adds keyword arguments, keeps each loaded model and
    every token row its engine generates."""

    def __init__(self, fn, memo=False, **extra):
        self.fn, self.extra, self.memo = fn, extra, {} if memo else None
        self.rows, self.calls = [], []

    def __call__(self, *args, **kw):
        self.calls.append(dict(kw))
        kw.update(self.extra)
        key = repr((args, sorted((k, type(v).__name__ if k == "tokenizer" else v)
                                 for k, v in kw.items())))
        if self.memo is not None and key in self.memo:
            return self.memo[key]
        model = self.fn(*args, **kw)
        gen = model.engine.generate

        def generate(*a, **k):
            res = gen(*a, **k)
            self.rows.append(np.asarray(res.tokens[0, :int(res.length[0])]))
            return res

        model.engine.generate = generate
        if self.memo is not None:
            self.memo[key] = model
        return model


def port_lumina(**extra):
    def load(*args, **kw):
        model = loader.load_lumina_mgpt(*args, **kw)
        eng = model.engine
        eng.config = dataclasses.replace(eng.config, eos_id=IMAGE_END_ID)
        return model

    return Recorder(load, model_cfg=decoder_config_from_jax(TINY_CHAMELEON),
                    vq_cfg=vq_config_from_jax(TINY_CHAMELEON_VQ), **extra)


@pytest.fixture(scope="module")
def jax_t2i():
    """The JAX Lumina loader on the tiny configurations, loaded once."""
    return Recorder(jax_loader.load_lumina_mgpt, memo=True, model_cfg=TINY_CHAMELEON,
                    vq_cfg=TINY_CHAMELEON_VQ, tokenizer=ChameleonFakeTokenizer())


def run_both(monkeypatch, tmp_path, name, port_mod, port_rec, jax_rec, jax_attr, args):
    """The port's and the JAX command line on ``args``: their printed lines,
    saved images (read back through PIL) and generated token rows."""
    out = {}
    for side in ("port", "jax"):
        path = str(tmp_path / f"{name}_{side}.png")
        rec = port_rec if side == "port" else jax_rec
        rec.rows.clear()
        if side == "port":
            monkeypatch.setattr(port_mod, jax_attr, port_rec)
            port_mod.main(args + ["--out", path, "--device", "cpu"])
        else:
            monkeypatch.setattr(f"sjd_tpu.loader.{jax_attr}", jax_rec)
            monkeypatch.setattr(sys, "argv", [f"{name}.py"] + args + ["--out", path])
            load_example(name).main()
        out[side] = (read(path), list(rec.rows))
    return out


def check_same(out, n_images, n_spans=1):
    """The same image spans in every row (an i2i prompt's own block and
    the generated image), saved images within 1 LSB."""
    (pimg, prows), (jimg, jrows) = out["port"], out["jax"]
    assert len(prows) == len(jrows) == n_images
    pspans, jspans = image_spans(prows), image_spans(jrows)
    assert all(len(s) == n_spans for s in pspans) and pspans == jspans
    assert pimg.shape == jimg.shape and np.abs(pimg - jimg).max() <= 1


@pytest.mark.parametrize("repeats", [1, 2])
def test_generate_lumina_mgpt_equals_jax(lumina_files, jax_t2i, monkeypatch, tmp_path,  # noqa: F811
                                         capsys, repeats):
    _, ckpt_dir, vq_path = lumina_files
    args = ["--ckpt-dir", ckpt_dir, "--vq-ckpt", vq_path, "--target-size", str(TARGET),
            "--image-top-k", "1", "--seed", "3", "--num-repeats", str(repeats)]
    port_rec = port_lumina(tokenizer=ChameleonFakeTokenizer())
    out = run_both(monkeypatch, tmp_path, "generate_lumina_mgpt", generate_lumina_mgpt,
                   port_rec, jax_t2i, "load_lumina_mgpt", args)
    check_same(out, repeats)
    assert out["port"][0].shape == (TARGET, TARGET * repeats, 3)
    # each side's last two lines: the time, then the file it saved
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(" ")[0] for ln in lines[-4:]] == ["Time", "saved"] * 2
    assert lines[-3].endswith("_port.png") and lines[-1].endswith("_jax.png")


def test_generate_llamagen_c2i_equals_jax(llamagen_files, monkeypatch, tmp_path):  # noqa: F811
    gpt_path, vq_path = llamagen_files
    args = ["--gpt-ckpt", gpt_path, "--vq-ckpt", vq_path, "--latent-size", str(LATENT),
            "--prompt", "3", "--image-top-k", "1", "--seed", "2"]
    port_rec = Recorder(loader.load_llamagen, model_cfg=decoder_config_from_jax(tiny_cfg(1)),
                        vq_cfg=vq_config_from_jax(TINY_VQ16))
    jax_rec = Recorder(jax_loader.load_llamagen, model_cfg=tiny_cfg(1), vq_cfg=TINY_VQ16)
    out = run_both(monkeypatch, tmp_path, "generate_llamagen", generate_llamagen, port_rec,
                   jax_rec, "load_llamagen", args)
    (pimg, prows), (jimg, jrows) = out["port"], out["jax"]
    assert [r[1:].tolist() for r in prows] == [r[1:].tolist() for r in jrows]
    assert len(prows[0]) == 1 + LATENT ** 2
    assert pimg.shape == jimg.shape == (16 * LATENT, 16 * LATENT, 3)
    assert np.abs(pimg - jimg).max() <= 1


def test_generate_llamagen_t2i_with_t5_dir_raises_the_loaders_error(tmp_path):
    with pytest.raises(ValueError, match="t5_dir needs t5_tokenizer"):
        generate_llamagen.main(["--model-type", "t2i", "--t5-dir", str(tmp_path),
                                "--device", "cpu"])


def test_generate_emu3_equals_the_loader(monkeypatch, tmp_path, capsys):
    tiny = dict(model_cfg=decoder_config_from_jax(TINY_EMU3),
                vq_cfg=emu3_vq_config_from_jax(TINY_EMU3_VQ), tokenizer=Emu3FakeTokenizer())
    rec = Recorder(loader.load_emu3, **tiny)
    monkeypatch.setattr(generate_emu3, "load_emu3", rec)
    args = ["--image-area", "256", "--seed", "4", "--prompt", "a red fox"]
    generate_emu3.main(args + ["--out", str(tmp_path / "a.png"), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert "quantize" not in rec.calls[0] and (rec.calls[0]["h"], rec.calls[0]["w"]) == (2, 2)
    want = loader.load_emu3(h=2, w=2, device="cpu", **tiny).sample_fn("a red fox", rng_seed=4)
    np.testing.assert_array_equal(read(tmp_path / "a.png"), want.astype(int))
    generate_emu3.main(args + ["--quantize", "4", "--out", str(tmp_path / "b.png"),
                               "--device", "cpu"])
    capsys.readouterr()
    assert rec.calls[1]["quantize"] == 4

    # the JAX script's lines, from a stand-in loader that returns a PIL image
    class Stub:
        def sample_fn(self, prompt, rng_seed):
            return Image.fromarray(np.zeros((16, 16, 3), np.uint8))

    monkeypatch.setattr("sjd_tpu.loader.load_emu3", lambda *a, **k: Stub())
    monkeypatch.setattr(sys, "argv", ["generate_emu3.py"] + args
                        + ["--out", str(tmp_path / "c.png")])
    load_example("generate_emu3").main()
    jlines = capsys.readouterr().out.splitlines()
    assert [ln.split(" ")[0] for ln in lines] == [ln.split(" ")[0] for ln in jlines]
    assert lines[0] == jlines[0] == "latent grid 2x2"


# --------------------------------------------------------------------------
# latency_budget, hbm_bw_probe
# --------------------------------------------------------------------------

# examples/latency_budget.py:104-262 and examples/hbm_bw_probe.py:75-155
BUDGET_KEYS = {"weights_floor_ms", "fwd_ms", "fwd_half_layers_ms", "fwd_small_head_ms",
               "sampling_ms", "dispatch_ms", "engine_step_lowfill_ms", "nfe_sampled_lowfill",
               "engine_step_highfill_ms", "nfe_sampled_highfill", "config"}
PROBE_KEYS = {"stream_bf16_gbps", "stream_bf16_ms", "stream_s4_gbps", "stream_s4_ms",
              "dot_s4_gbps", "dot_s4_ms", "stream_s8_gbps", "stream_s8_ms_half",
              "dot_s8_gbps", "dot_s8_ms_half"}


def test_latency_budget_has_the_jax_keys_on_a_tiny_config(monkeypatch, capsys):
    tiny = dataclasses.replace(decoder_config_from_jax(TINY_CHAMELEON), dtype=torch.bfloat16,
                               max_position_embeddings=4096)
    real = latency_budget.lumina_engine
    monkeypatch.setattr(latency_budget, "lumina_engine",
                        lambda **kw: real(model_cfg=tiny, **kw))
    monkeypatch.setattr(latency_budget, "ITERS", 2)
    monkeypatch.setattr(latency_budget, "WARM_STEPS", 2)
    monkeypatch.setattr(latency_budget, "TIMED_STEPS", 3)
    latency_budget.main(["--device", "cpu"])
    (got,) = json_lines(capsys.readouterr().out)
    assert set(got) == BUDGET_KEYS
    assert got["config"] == {"model": "lumina-7B int4 W4A16 (int8 head)", "batch_cfg": 2,
                             "window": 16, "kv_quant": True, "head": "lm_head"}
    assert all(np.isfinite(v) and v > 0 for k, v in got.items() if k != "config")
    assert got["nfe_sampled_lowfill"] == got["nfe_sampled_highfill"] == 3


def test_hbm_bw_probe_has_the_jax_keys_at_one_block(monkeypatch, capsys):
    monkeypatch.setattr(hbm_bw_probe, "BLOCKS", 1)
    monkeypatch.setattr(hbm_bw_probe, "ITERS", 1)
    hbm_bw_probe.main(["--device", "cpu"])
    (got,) = json_lines(capsys.readouterr().out)
    assert set(got) == PROBE_KEYS
    assert all(np.isfinite(v) and v > 0 for v in got.values())


def test_entry_points_refuse_a_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (hbm_bw_probe, latency_budget, quant_fidelity):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main([])
