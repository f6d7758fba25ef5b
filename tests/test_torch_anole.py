"""Anole in the port (sjd_tpu_torch: the anole grammar kind, models/anole.py,
loader.load_anole) against sjd_tpu on the same inputs:

  * the anole masks of the four multimodal_generation_modes at image
    phases None, 0, 3, L-1 and L (the cases of
    tests/test_anole_modes_vs_reference.py:120-122, held here against
    sjd_tpu's grammar), over a window whose rows cross the <boi> room
    limit and the first generated position; the forced tokens, the
    residual row and the state updates, exactly;
  * the fixed-length image (tests/test_engine_edges.py:37);
  * greedy parity of a tiny anole engine per mode: tokens, NFE and
    accept_hist (the JAX engine's draft seeds replayed);
  * the load_anole checkpoint drill (tests/test_checkpoint_drill.py:111)
    through both loaders, and encode_image_fn
    (tests/test_image_input.py:125).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ckpt_synth import ChameleonFakeTokenizer, save_torch_pt, synth_hf_llama_state_dict
from ckpt_synth import synth_vqgan_state_dict
from sjd_tpu import loader as jax_loader
from sjd_tpu.core import grammar as jg
from sjd_tpu.models import anole as janole
from sjd_tpu.models import init_params as jax_init_params
from sjd_tpu.models.vq import VQConfig
from sjd_tpu_torch.convert import (
    decoder_config_from_jax, params_from_jax, vq_config_from_jax, vq_params_from_jax)
from sjd_tpu_torch.core import grammar as pg
from sjd_tpu_torch.core.engine import StepDraws
from sjd_tpu_torch.loader import load_anole, load_pretrained_model
from sjd_tpu_torch.models import anole as panole
from test_torch_checkpoint import assert_trees_equal, np_tree
from test_torch_lumina_slice import TINY_CHAMELEON, TINY_CHAMELEON_VQ, _replayed_seeds

V = 120
BOI, EOI, EOS = 101, 100, 2
IMG_LO, IMG_HI = 4, 99
L_IMG = 8
MAXLEN = 64
MODES = ["image-only", "text-only", "interleaved", "unrestricted"]


def _specs(mode, max_len=MAXLEN):
    kw = dict(image_start_id=BOI, image_end_id=EOI, eos_id=EOS, image_vocab_start=IMG_LO,
              image_vocab_end=IMG_HI, image_seq_length=L_IMG,
              boi_suppress_from=(max_len - L_IMG - 1
                                 if mode in ("image-only", "interleaved") else -1))
    return (dataclasses.replace(janole.anole_grammar(mode, max_len=max_len), **kw),
            dataclasses.replace(panole.anole_grammar(mode, max_len=max_len), **kw))


def _states(in_image, img_count):
    arrs = dict(in_image=np.asarray([in_image]), size_known=np.asarray([True]),
                h_lat=np.zeros(1, np.int32), w_lat=np.zeros(1, np.int32),
                img_count=np.asarray([img_count], np.int32),
                header_seen=np.asarray([2], np.int32))
    return (jg.GrammarState(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            pg.GrammarState(**{k: torch.from_numpy(v) for k, v in arrs.items()}))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("phase", [None, 0, 3, L_IMG - 1, L_IMG])
def test_mode_masks_equal_jax(mode, phase):
    """A 6-row window at each phase, its rows at generated offsets that
    include the first one (eos suppressed there in image-only mode) and
    cross boi_suppress_from; the forced tokens and the residual row."""
    jspec, pspec = _specs(mode)
    jst, pst = _states(phase is not None, phase or 0)
    W = 6
    scores = np.random.default_rng(7 + (phase or 0)).standard_normal((1, W, V)).astype(np.float32)
    for first in (4, 4 + MAXLEN - L_IMG - 4):
        pred = np.arange(first, first + W, dtype=np.int32)[None]
        begin = np.asarray([4], np.int32)
        want = np.asarray(jg.apply_grammar(jspec, jst, jnp.asarray(scores),
                                           pred_pos=jnp.asarray(pred),
                                           begin_pos=jnp.asarray(begin)))
        got = pg.apply_grammar(pspec, pst, torch.from_numpy(scores),
                               pred_pos=torch.from_numpy(pred),
                               begin_pos=torch.from_numpy(begin)).numpy()
        np.testing.assert_array_equal(got, want)
        k = np.asarray([3], np.int32)
        want1 = np.asarray(jg.apply_grammar_single(
            jspec, jst, jnp.asarray(scores[:, 0]), jnp.asarray(k),
            pred_pos=jnp.asarray(pred[:, 3]), begin_pos=jnp.asarray(begin)))
        got1 = pg.apply_grammar_single(
            pspec, pst, torch.from_numpy(scores[:, 0]), torch.from_numpy(k),
            pred_pos=torch.from_numpy(pred[:, 3]), begin_pos=torch.from_numpy(begin)).numpy()
        np.testing.assert_array_equal(got1, want1)
    o = (phase or 0) + np.arange(W, dtype=np.int32)[None]
    jf, jt = jg.forced_token_at(jspec, jst, jnp.asarray(o))
    pf, ptok = pg.forced_token_at(pspec, pst, torch.from_numpy(o))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(jt))


def test_anole_state_updates_equal_jax():
    """<boi> opens an image, its body counts, <eoi> closes it and resets,
    over random windows (count and mask forms)."""
    jspec, pspec = _specs("interleaved")
    jst = jg.init_state(2)
    pst = pg.init_state(2)
    rng = np.random.default_rng(3)
    for step in range(12):
        toks = rng.choice([BOI, EOI, 5, 50, 99, 110], (2, 5)).astype(np.int32)
        n = (rng.random((2, 5)) < 0.8) if step % 2 else rng.integers(0, 6, 2).astype(np.int32)
        jst = jg.update_state(jspec, jst, jnp.asarray(toks), jnp.asarray(n))
        pst = pg.update_state(pspec, pst, torch.from_numpy(toks), torch.from_numpy(n))
        for a, b in zip(pst, jst):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_normalize_mode_and_grammar_equal_jax():
    assert panole.normalize_mode("interleaved-text-image") == "interleaved"
    with pytest.raises(ValueError):
        panole.normalize_mode("video")
    for mode in MODES:
        for max_len in (0, 1200):
            a = panole.anole_grammar(mode, max_len=max_len)
            b = janole.anole_grammar(mode, max_len=max_len)
            for f in dataclasses.fields(pg.GrammarSpec):
                assert getattr(a, f.name) == getattr(b, f.name), (mode, f.name)


def test_fixed_length_image():
    """tests/test_engine_edges.py:37 on the port: exactly image_seq_length
    image tokens after <boi>, then <eoi>, on the sampled path."""
    from helpers import TINY, tiny_params
    from sjd_tpu_torch.core.engine import EngineConfig, SJDEngine
    from sjd_tpu_torch.core.processors import SamplingParams
    from sjd_tpu_torch.models.adapter import decoder_model_fns

    spec = pg.GrammarSpec(kind="anole", image_start_id=48, image_end_id=49,
                          image_vocab_start=4, image_vocab_end=47, image_seq_length=12)
    cfg = decoder_config_from_jax(TINY)
    eng = SJDEngine(decoder_model_fns(cfg, max_positions=512, device="cpu"),
                    EngineConfig(window=5, max_len=40, eos_id=63, cfg_mode="none"), spec,
                    SamplingParams(do_cfg=False, image_top_k=40, text_top_k=10))
    params = params_from_jax(np_tree(tiny_params()), cfg, device="cpu")
    res = eng.generate(params, 3, torch.tensor([[1, 2, 48]]))
    seq = res.tokens[0, 3:3 + 13].tolist()
    assert all(4 <= t <= 47 for t in seq[:12]), seq
    assert seq[12] == 49, seq


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax.random.PRNGKey(0), TINY_CHAMELEON)


@pytest.mark.parametrize("mode", MODES)
def test_tiny_anole_engine_greedy_equals_jax(jax_params, mode):
    """Each mode through anole_engine (16-token images, int8 KV, max_len
    40): the same tokens, NFE and accept_hist; in image-only mode the image
    is 16 image tokens and then <eoi>."""
    kw = dict(greedy=True, multimodal_generation_mode=mode, image_seq_length=16, max_len=40,
              image_top_k=64, text_top_k=64)
    jeng = janole.anole_engine(model_cfg=dataclasses.replace(TINY_CHAMELEON, kv_quant=True),
                               **kw)
    eng = panole.anole_engine(model_cfg=decoder_config_from_jax(TINY_CHAMELEON), kv_quant=True,
                              device="cpu", **kw)
    params = params_from_jax(np_tree(jax_params), eng.model_cfg, device="cpu")
    ids = list(range(9000, 9010)) + ([panole.BOI_ID] if mode == "image-only" else [])
    key = jax.random.PRNGKey(5)
    want = jeng.generate(jax_params, key, jnp.asarray([ids], jnp.int32))
    W = eng.config.window
    seeds = _replayed_seeds(key, 1, W, eng.spec.image_vocab_start, eng.spec.image_vocab_end)
    eng._draws = lambda st: StepDraws(next(seeds), None, torch.rand(1, W - 1), None)
    got = eng.generate(params, 0, torch.tensor([ids]))
    n = int(want.length[0])
    toks = got.tokens[0, :n].tolist()
    assert int(got.length[0]) == n and toks == np.asarray(want.tokens[0, :n]).tolist()
    assert got.nfe == int(want.nfe)
    np.testing.assert_array_equal(got.accept_hist.numpy(), np.asarray(want.accept_hist))
    gen = toks[len(ids):]
    if mode == "image-only":
        assert all(4 <= t <= 8195 for t in gen[:16]) and gen[16] == panole.EOI_ID, gen
    if mode == "text-only":
        assert not any(4 <= t <= 8197 for t in gen), gen


@pytest.fixture(scope="module")
def anole_files(tmp_path_factory):
    from safetensors.numpy import save_file

    root = tmp_path_factory.mktemp("anole")
    sd = synth_hf_llama_state_dict(TINY_CHAMELEON, seed=5, qk_layout="per_head")
    ckpt_dir = str(root / "anole")
    save_torch_pt(sd, os.path.join(ckpt_dir, "consolidated.pt"), nest="module")
    vq_path = str(root / "anole_vq.safetensors")
    save_file(synth_vqgan_state_dict(TINY_CHAMELEON_VQ, seed=6), vq_path)
    return ckpt_dir, vq_path


def test_anole_disk_drill_equals_jax(anole_files):
    """tests/test_checkpoint_drill.py:111 through both loaders: a .pt with
    DDP "module" nesting (per-head qk-norm layout) and a safetensors VQ:
    smoke False, the same trees, prompt ids and mapping, the same greedy
    tokens, NFE and accept_hist, and images within 1 of each other."""
    ckpt_dir, vq_path = anole_files
    tok = ChameleonFakeTokenizer()
    kw = dict(ckpt_dir=ckpt_dir, vq_ckpt=vq_path, tokenizer=tok, image_seq_length=16)
    jm = jax_loader.load_anole(model_cfg=TINY_CHAMELEON, vq_cfg=TINY_CHAMELEON_VQ, **kw)
    pcfg = decoder_config_from_jax(TINY_CHAMELEON)
    vcfg = vq_config_from_jax(TINY_CHAMELEON_VQ)
    pm = load_anole(model_cfg=pcfg, vq_cfg=vcfg, device="cpu", **kw)
    assert jm.smoke is False and pm.smoke is False, pm.extras["smoke_reasons"]
    assert_trees_equal(pm.params, params_from_jax(np_tree(jm.params), pm.engine.model_cfg,
                                                  device="cpu"))
    assert_trees_equal(pm.extras["vq_params"], vq_params_from_jax(
        np_tree(jm.extras["vq_params"]), vcfg, device="cpu"))
    ids = pm.extras["prompt_ids_fn"]("an apple")
    assert ids == jm.extras["prompt_ids_fn"]("an apple") and ids[-1] == panole.BOI_ID
    np.testing.assert_array_equal(pm.extras["mapping"].bpe2img, jm.extras["mapping"].bpe2img)

    jeng = janole.anole_engine(model_cfg=TINY_CHAMELEON, image_seq_length=16, greedy=True)
    eng = panole.anole_engine(model_cfg=pcfg, image_seq_length=16, greedy=True,
                              kv_quant=False, device="cpu")
    key = jax.random.PRNGKey(3)
    want = jeng.generate(jm.params, key, jnp.asarray([ids], jnp.int32))
    W = eng.config.window
    seeds = _replayed_seeds(key, 1, W, eng.spec.image_vocab_start, eng.spec.image_vocab_end)
    eng._draws = lambda st: StepDraws(next(seeds), None, torch.rand(1, W - 1), None)
    got = eng.generate(pm.params, 0, torch.tensor([ids]))
    n = int(want.length[0])
    toks = got.tokens[0, :n].tolist()
    assert int(got.length[0]) == n and toks == np.asarray(want.tokens[0, :n]).tolist()
    assert got.nfe == int(want.nfe)
    np.testing.assert_array_equal(got.accept_hist.numpy(), np.asarray(want.accept_hist))
    img = pm.extras["decode_image_fn"](toks)
    jimg = np.asarray(jm.extras["decode_image_fn"](toks))
    assert img.shape == jimg.shape == (64, 64, 3) and img.dtype == np.uint8
    assert np.abs(img.astype(int) - jimg.astype(int)).max() <= 1
    assert pm.sample_fn("an apple", 0).shape == (64, 64, 3)


def test_load_anole_default_engine_equals_jax(anole_files):
    """Both loaders' own engines with no kv_quant passed on either side: a
    cache of the model's dtype with no scales on both, and, made greedy,
    the same tokens, NFE and accept_hist."""
    ckpt_dir, vq_path = anole_files
    kw = dict(ckpt_dir=ckpt_dir, vq_ckpt=vq_path, tokenizer=ChameleonFakeTokenizer(),
              image_seq_length=16)
    jm = jax_loader.load_anole(model_cfg=TINY_CHAMELEON, vq_cfg=TINY_CHAMELEON_VQ, **kw)
    pm = load_anole(model_cfg=decoder_config_from_jax(TINY_CHAMELEON),
                    vq_cfg=vq_config_from_jax(TINY_CHAMELEON_VQ), device="cpu", **kw)
    assert jm.engine.model_cfg.kv_quant is False and pm.engine.model_cfg.kv_quant is False
    kv = pm.engine.model.init_cache(2, 8)
    assert kv.k.dtype == torch.float32 and kv.k_scale is None
    for m in (jm, pm):
        m.engine.sampling = dataclasses.replace(m.engine.sampling, greedy=True)
    jeng, eng = jm.engine, pm.engine
    ids = pm.extras["prompt_ids_fn"]("an apple")
    key = jax.random.PRNGKey(4)
    want = jeng.generate(jm.params, key, jnp.asarray([ids], jnp.int32))
    W = eng.config.window
    seeds = _replayed_seeds(key, 1, W, eng.spec.image_vocab_start, eng.spec.image_vocab_end)
    eng._draws = lambda st: StepDraws(next(seeds), None, torch.rand(1, W - 1), None)
    got = eng.generate(pm.params, 0, torch.tensor([ids]))
    n = int(want.length[0])
    assert int(got.length[0]) == n
    assert got.tokens[0, :n].tolist() == np.asarray(want.tokens[0, :n]).tolist()
    assert got.nfe == int(want.nfe)
    np.testing.assert_array_equal(got.accept_hist.numpy(), np.asarray(want.accept_hist))


def test_encode_image_fn_equals_jax():
    """tests/test_image_input.py:125 on both loaders: pixels -> VQ codes ->
    the tokenizer's BPE permutation; the same ids (taming VQ at tiny
    widths, random seed-1 weights in both), each an image token."""
    vq = VQConfig(ch=32, ch_mult=(1, 1, 1, 1, 1), num_res_blocks=1, z_channels=32,
                  embed_dim=32, n_embed=8192)
    tok = ChameleonFakeTokenizer()
    jm = jax_loader.load_anole(model_cfg=TINY_CHAMELEON, vq_cfg=vq, tokenizer=tok)
    pm = load_anole(model_cfg=decoder_config_from_jax(TINY_CHAMELEON),
                    vq_cfg=vq_config_from_jax(vq), tokenizer=tok, device="cpu")
    # the same random VQ through the converter, so the encoders agree
    pm.extras["vq_params"].update(vq_params_from_jax(np_tree(jm.extras["vq_params"]),
                                                     vq_config_from_jax(vq), device="cpu"))
    img = (np.random.RandomState(5).rand(32, 32, 3).astype(np.float32) * 2) - 1
    got = pm.extras["encode_image_fn"](img)
    want = jm.extras["encode_image_fn"](img)
    assert len(got) == 4 and got == want
    allowed = set(pm.extras["mapping"].image_bpe_ids.tolist())
    assert all(t in allowed for t in got)


def test_registry_dispatches_and_refuses_llamagen():
    """Anole by name; LlamaGen by name too (ported), refused only where its
    device is (CUDA, by default, on a machine without it) or its head width
    is not to be had; an unknown name refused."""
    m = load_pretrained_model("Anole-7b", model_cfg=decoder_config_from_jax(TINY_CHAMELEON),
                              vq_cfg=vq_config_from_jax(TINY_CHAMELEON_VQ),
                              image_seq_length=16, device="cpu")
    assert m.name == "anole" and m.smoke and len(m.extras["smoke_reasons"]) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_pretrained_model("LlamaGen-XL")
    with pytest.raises(KeyError):
        load_pretrained_model("LlamaGen-XL", name="GPT-9B", device="cpu")
    with pytest.raises(ValueError):
        load_pretrained_model("dalle")
