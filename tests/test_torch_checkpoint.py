"""Checkpoints from disk in the port (sjd_tpu_torch/utils/port.py,
models/vq/port.py, loader.py) against sjd_tpu, at tiny widths with the real
65536 vocabulary and the downsample-16 VQ layout
(tests/test_checkpoint_drill.py:33-43):

  * the port's own safetensors reader against ``safetensors.numpy``, for
    every dtype it maps;
  * the file layouts that tests/ckpt_synth.py writes (sharded safetensors,
    sharded ``pytorch_model-*.bin``, a nested ``.pt``) ported to trees
    bit-equal to ``params_from_jax`` of sjd_tpu's port of the same state
    dict: both qk-norm layouts, GQA with swin-norm, LlamaGen's gpt-fast
    naming, the VQGAN in both name styles;
  * W4A16 (equilibrated) and W8A16 bytes from a checkpoint equal to the JAX
    loader's;
  * the Lumina disk drill (tests/test_checkpoint_drill.py:53, :176) through
    both loaders: smoke False, the same prompt ids, and the same greedy
    tokens, NFE and accept_hist (the JAX engine's draft seeds replayed,
    as tests/test_torch_lumina_slice.py does)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ckpt_synth import (
    ChameleonFakeTokenizer, save_sharded_safetensors, save_torch_bins, save_torch_pt,
    synth_hf_llama_state_dict, synth_llamagen_state_dict, synth_vqgan_state_dict)
from sjd_tpu import loader as jax_loader
from sjd_tpu.models import DecoderConfig
from sjd_tpu.models.chameleon import lumina_engine as jax_lumina_engine
from sjd_tpu.models.vq import VQConfig
from sjd_tpu.models.vq import port_vqgan as jax_port_vqgan
from sjd_tpu.utils import port as jax_port
from sjd_tpu_torch.convert import (
    decoder_config_from_jax, params_from_jax, vq_config_from_jax, vq_params_from_jax)
from sjd_tpu_torch.core.engine import StepDraws
from sjd_tpu_torch.loader import load_lumina_mgpt
from sjd_tpu_torch.models.chameleon import lumina_engine
from sjd_tpu_torch.models.vq import port_vqgan
from sjd_tpu_torch.utils import port
from test_torch_lumina_slice import TINY_CHAMELEON, TINY_CHAMELEON_VQ, _replayed_seeds

TINY_GQA_SWIN = dataclasses.replace(TINY_CHAMELEON, num_heads=4, num_kv_heads=2,
                                    swin_norm=True)
TINY_LLAMAGEN = DecoderConfig(
    vocab_size=16384, hidden_size=16, intermediate_size=32, num_layers=2, num_heads=2,
    num_kv_heads=2, head_dim=8, dtype=jnp.float32, max_position_embeddings=128)
LLAMAGEN_VQ = VQConfig(ch=32, ch_mult=(1, 1, 1, 1, 1), num_res_blocks=1, z_channels=32,
                       embed_dim=8, n_embed=16384, l2_norm_codebook=True)
TARGET = 64


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def assert_trees_equal(got, want):
    """Same keys, dtypes, shapes and bytes."""
    if isinstance(want, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            assert_trees_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_trees_equal(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

DTYPES = {"BF16": "bfloat16", "F16": np.float16, "F32": np.float32, "I64": np.int64,
          "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_safetensors_reader_equals_safetensors_numpy(tmp_path, name):
    import ml_dtypes
    from safetensors.numpy import load_file, save_file

    rs = np.random.RandomState(len(name))
    dt = ml_dtypes.bfloat16 if DTYPES[name] == "bfloat16" else np.dtype(DTYPES[name])
    if dt == np.bool_:
        arrs = {"a": rs.rand(3, 5) > 0.5}
    elif np.issubdtype(dt, np.integer):
        info = np.iinfo(dt)
        arrs = {"a": rs.randint(info.min, info.max, (3, 5), dtype=np.int64).astype(dt)}
    else:
        arrs = {"a": (rs.randn(3, 5) * 100).astype(np.float32).astype(dt)}
    arrs.update(scalar=arrs["a"][0, :1].reshape(()), empty=arrs["a"][:0])
    path = str(tmp_path / "t.safetensors")
    save_file(arrs, path)
    want = load_file(path)
    f = port.SafetensorsFile(path)
    assert sorted(f) == sorted(want) and len(f) == 3
    for k, w in want.items():
        got = f[k]
        assert got.dtype == port.SAFETENSORS_DTYPES[name] and tuple(got.shape) == w.shape
        if name == "BF16":  # numpy has no bf16: compare the bits
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), w.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), w)


def test_safetensors_reader_refuses_unknown_dtypes(tmp_path):
    import json
    import struct

    header = json.dumps({"a": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}})
    path = tmp_path / "bad.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header.encode() + b"\0\0")
    with pytest.raises(ValueError, match="F8_E4M3"):
        port.SafetensorsFile(str(path))


# ---------------------------------------------------------------------------
# decoder trees from the three file layouts
# ---------------------------------------------------------------------------

def _write(sd, d, layout):
    if layout == "safetensors":
        save_sharded_safetensors(sd, d, shards=3)
    elif layout == "bin":
        save_torch_bins(sd, d, shards=2)
    else:
        save_torch_pt(sd, os.path.join(d, "weights.pt"), nest="module")


@pytest.mark.parametrize("cfg,qk_layout", [(TINY_CHAMELEON, "flat"), (TINY_CHAMELEON, "per_head"),
                                           (TINY_GQA_SWIN, "flat")],
                         ids=["flat", "per_head", "gqa_swin"])
@pytest.mark.parametrize("layout", ["safetensors", "bin", "pt"])
def test_file_layouts_port_to_the_jax_tree(tmp_path, layout, cfg, qk_layout):
    sd = synth_hf_llama_state_dict(cfg, seed=9, qk_layout=qk_layout)
    d = str(tmp_path / layout)
    _write(sd, d, layout)
    pcfg = decoder_config_from_jax(cfg)
    got = port.port_hf_llama_like(port.load_sharded_state(d), pcfg, device="cpu")
    want = params_from_jax(np_tree(jax_port.port_hf_llama_like(sd, cfg)), pcfg, device="cpu")
    assert_trees_equal(got, want)
    if qk_layout == "flat":  # [D] repeated across the heads
        assert torch.equal(got["layers"]["q_norm_scale"][:, 0], got["layers"]["q_norm_scale"][:, -1])


def test_checkpoint_files_take_the_jax_precedence(tmp_path):
    """*.safetensors before pytorch_model*.bin before *.pt before *.pth;
    nothing there raises."""
    for name in ("b.pth", "a.pt", "pytorch_model-00001-of-00001.bin", "m.safetensors"):
        (tmp_path / name).write_bytes(b"")
        files = [os.path.basename(f) for f in port.checkpoint_files(str(tmp_path))]
        assert files == [name]
    with pytest.raises(FileNotFoundError):
        port.checkpoint_files(str(tmp_path / "nothing"))


def test_port_tied_embeddings_and_bf16_stay_bf16(tmp_path):
    """A bf16 checkpoint is read as bf16 (no f32 detour: the same bits),
    and a tied model has no lm_head."""
    cfg = dataclasses.replace(TINY_CHAMELEON, tie_word_embeddings=True)
    sd = synth_hf_llama_state_dict(cfg, seed=4)
    sd_bf16 = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()}
    from safetensors.torch import save_file

    save_file(sd_bf16, str(tmp_path / "model.safetensors"))
    pcfg = decoder_config_from_jax(cfg, dtype=torch.bfloat16)
    got = port.port_hf_llama_like(port.load_sharded_state(str(tmp_path)), pcfg, device="cpu")
    assert "lm_head" not in got
    assert got["embed"].dtype == torch.bfloat16
    assert torch.equal(got["embed"], sd_bf16["model.embed_tokens.weight"])
    assert torch.equal(got["layers"]["w_down"][1], sd_bf16["model.layers.1.mlp.down_proj.weight"])


def test_interleaved_to_splithalf_rows_equals_jax():
    w = np.random.RandomState(0).randn(3 * 8, 5).astype(np.float32)
    want = jax_port._interleaved_to_splithalf_rows(w, 3, 8)
    got = port._interleaved_to_splithalf_rows(torch.from_numpy(w), 3, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_port_llamagen_equals_jax(tmp_path):
    sd = synth_llamagen_state_dict(TINY_LLAMAGEN, seed=7, num_classes=10)
    path = str(tmp_path / "GPT-tiny.pt")
    save_torch_pt(sd, path, nest="model")
    pcfg = decoder_config_from_jax(TINY_LLAMAGEN)
    got, cond = port.port_llamagen(port.load_torch_checkpoint(path), pcfg, device="cpu")
    jparams, jcond = jax_port.port_llamagen(sd, TINY_LLAMAGEN)
    assert_trees_equal(got, params_from_jax(np_tree(jparams), pcfg, device="cpu"))
    assert cond["kind"] == jcond["kind"] == "c2i"
    np.testing.assert_array_equal(cond["label_table"].numpy(), np.asarray(jcond["label_table"]))


@pytest.mark.parametrize("style", ["taming", "llamagen"])
def test_port_vqgan_equals_jax(tmp_path, style):
    """Encoder and decoder halves, from a "state_dict"-nested .ckpt
    (taming) or a safetensors file (llamagen)."""
    cfg = TINY_CHAMELEON_VQ if style == "taming" else LLAMAGEN_VQ
    sd = synth_vqgan_state_dict(cfg, seed=2, style=style)
    if style == "taming":
        path = str(tmp_path / "vq" / "vqgan.ckpt")
        save_torch_pt(sd, path, nest="state_dict")
    else:
        from safetensors.numpy import save_file

        path = str(tmp_path / "vq.safetensors")
        save_file(sd, path)
    pcfg = vq_config_from_jax(cfg)
    got = port_vqgan(port.load_torch_checkpoint(path), pcfg, style=style, device="cpu")
    want = vq_params_from_jax(np_tree(jax_port_vqgan(sd, cfg, style=style)), pcfg,
                              device="cpu")
    assert {"encoder", "decoder", "quant_conv_w", "post_quant_conv_w"} <= set(got)
    assert_trees_equal(got, want)


# ---------------------------------------------------------------------------
# quantized bytes and the Lumina drill through both loaders
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lumina_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("lumina")
    sd = synth_hf_llama_state_dict(TINY_CHAMELEON, seed=1, qk_layout="flat")
    ckpt_dir = str(root / "lumina")
    save_sharded_safetensors(sd, ckpt_dir, shards=2)
    vq_path = str(root / "vq" / "vqgan.ckpt")
    save_torch_pt(synth_vqgan_state_dict(TINY_CHAMELEON_VQ, seed=2), vq_path, nest="state_dict")
    return sd, ckpt_dir, vq_path


@pytest.mark.parametrize("quantize", [4, True], ids=["w4a16", "w8a16"])
def test_checkpoint_quantized_bytes_equal_jax(lumina_files, quantize):
    """The JAX checkpoint path (port, then quantize_weights under jit,
    equilibrated for int4, int8 head) and the port's load of the same files
    give the same bytes, bf16 weights."""
    sd, ckpt_dir, _ = lumina_files
    cfg = dataclasses.replace(TINY_CHAMELEON, dtype=jnp.bfloat16)
    jp = jax_loader.quantize_ported_params(
        jax_port.port_hf_llama_like(jax_loader._load_sharded_state(ckpt_dir), cfg), cfg, quantize)
    pcfg = decoder_config_from_jax(cfg)
    model = load_lumina_mgpt(ckpt_dir=ckpt_dir, quantize=quantize, target_size=TARGET,
                             model_cfg=pcfg, vq_cfg=vq_config_from_jax(TINY_CHAMELEON_VQ),
                             device="cpu")
    assert_trees_equal(model.params, params_from_jax(np_tree(jp), pcfg, device="cpu"))
    wq = model.params["layers"]["wq"]
    assert set(wq) == ({"q4p", "s"} if quantize == 4 else {"q", "s"})
    assert set(model.params["lm_head"]) == {"q", "s"}


def test_lumina_disk_drill_equals_jax(lumina_files):
    """Both loaders on the same files and tokenizer: smoke False, the same
    trees and prompt ids; then greedy generation from each loader's weights
    gives the same tokens, NFE and accept_hist, and the images agree."""
    sd, ckpt_dir, vq_path = lumina_files
    tok = ChameleonFakeTokenizer()
    kw = dict(ckpt_dir=ckpt_dir, vq_ckpt=vq_path, target_size=TARGET, tokenizer=tok)
    jm = jax_loader.load_lumina_mgpt(model_cfg=TINY_CHAMELEON, vq_cfg=TINY_CHAMELEON_VQ, **kw)
    pcfg = decoder_config_from_jax(TINY_CHAMELEON)
    pm = load_lumina_mgpt(model_cfg=pcfg, vq_cfg=vq_config_from_jax(TINY_CHAMELEON_VQ),
                          device="cpu", **kw)
    assert jm.smoke is False and pm.smoke is False, pm.extras["smoke_reasons"]
    assert pm.extras["smoke_reasons"] == []
    assert_trees_equal(pm.params, params_from_jax(np_tree(jm.params), pcfg, device="cpu"))
    assert_trees_equal(pm.extras["vq_params"], vq_params_from_jax(
        np_tree(jm.extras["vq_params"]), vq_config_from_jax(TINY_CHAMELEON_VQ), device="cpu"))
    caption = "a photo of a cat"
    ids = pm.extras["prompt_ids_fn"](caption)
    assert ids == jm.extras["prompt_ids_fn"](caption)
    np.testing.assert_array_equal(pm.extras["mapping"].bpe2img, jm.extras["mapping"].bpe2img)

    jeng = jax_lumina_engine(model_cfg=TINY_CHAMELEON, target_size=TARGET, greedy=True)
    eng = lumina_engine(model_cfg=pcfg, target_size=TARGET, greedy=True, device="cpu")
    key = jax.random.PRNGKey(3)
    want = jeng.generate(jm.params, key, jnp.asarray([ids], jnp.int32))
    W = eng.config.window
    seeds = _replayed_seeds(key, 1, W, eng.spec.image_vocab_start, eng.spec.image_vocab_end)
    eng._draws = lambda st: StepDraws(next(seeds), None, torch.rand(1, W - 1), None)
    got = eng.generate(pm.params, 0, torch.tensor([ids]))
    n = int(want.length[0])
    assert int(got.length[0]) == n
    toks = got.tokens[0, :n].tolist()
    assert toks == np.asarray(want.tokens[0, :n]).tolist()
    assert got.nfe == int(want.nfe)
    np.testing.assert_array_equal(got.accept_hist.numpy(), np.asarray(want.accept_hist))
    # the image through each loader's VQ decoder and the tokenizer's mapping
    img = pm.extras["decode_image_fn"](toks)
    jimg = np.asarray(jm.extras["decode_image_fn"](toks))
    assert img.shape == jimg.shape == (TARGET, TARGET, 3)
    assert np.abs(img.astype(int) - jimg.astype(int)).max() <= 1
