"""Emu3 in the port (sjd_tpu_torch: the emu3 grammar kind, models/emu3.py,
data/emu3_processor.py, loader.load_emu3, the blocked prefill attention)
against sjd_tpu on the same inputs:

  * the emu3 grammar, exactly: masks, forced tokens, the residual row and
    the state, including arming at the <|image token|> marker without
    counting it (the cases of tests/test_grammar.py:104, :161,
    tests/test_grammar_seed.py:73, tests/test_engine_edges.py:131);
  * the RoPE table at theta 1e6 over positions 0-9215, atol 1e-6 (the two
    inverse frequencies differ by an ulp);
  * a tiny Emu3-shaped decoder (2 layers, 4 query heads over 1 KV head,
    the real 184622 vocab) through emu3_engine: greedy tokens, NFE and
    accept_hist equal at a 4 x 4 grid with a negative prompt of another
    length (the JAX engine's draft seeds replayed);
  * the load_emu3 checkpoint drill (tests/test_checkpoint_drill.py:77)
    through both loaders;
  * the plain path's attention over query-row blocks equal to the one
    block at T = 2500.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ckpt_synth import Emu3FakeTokenizer, save_sharded_safetensors, save_torch_bins
from ckpt_synth import synth_hf_llama_state_dict
from sjd_tpu import loader as jax_loader
from sjd_tpu.core import grammar as jg
from sjd_tpu.data import emu3_processor as jproc
from sjd_tpu.models import DecoderConfig
from sjd_tpu.models import emu3 as jemu3
from sjd_tpu.models import init_params as jax_init_params
from sjd_tpu.models.transformer import rope_table_1d as jax_rope_table_1d
from sjd_tpu.models.vq.emu3_port import synth_emu3_vq_state_dict as jax_synth_vq
from sjd_tpu.models.vq.emu3_vq import Emu3VQConfig as JaxEmu3VQConfig
from sjd_tpu_torch.convert import (
    decoder_config_from_jax, emu3_vq_config_from_jax, emu3_vq_params_from_jax, params_from_jax)
from sjd_tpu_torch.core import grammar as pg
from sjd_tpu_torch.core.engine import StepDraws
from sjd_tpu_torch.data import emu3_processor as pproc
from sjd_tpu_torch.loader import load_emu3
from sjd_tpu_torch.models import emu3 as pemu3
from sjd_tpu_torch.models import transformer as pt
from test_torch_checkpoint import assert_trees_equal, np_tree
from test_torch_lumina_slice import _replayed_seeds

V = 64
# the toy layout of tests/test_grammar.py:104 (marker 56)
TOY = dict(kind="emu3", image_end_id=58, newline_id=57, eof_id=59, eos_id=60, pad_id=61,
           image_vocab_start=4, image_vocab_end=47, img_token_id=56)
TINY_EMU3 = DecoderConfig(
    vocab_size=184622, hidden_size=16, intermediate_size=32, num_layers=2, num_heads=4,
    num_kv_heads=1, head_dim=8, qk_norm=False, rope_theta=1_000_000.0, dtype=jnp.float32,
    max_position_embeddings=512)
TINY_EMU3_VQ = JaxEmu3VQConfig(ch=32, ch_mult=(1, 1), num_res_blocks=1, z_channels=4,
                               embed_dim=4, attn_levels=(1,))


def _t(x):
    return torch.from_numpy(np.array(x))


def _states(counts, h, w, in_image=True, size_known=True):
    B = len(counts)
    arrs = dict(in_image=np.full(B, in_image), size_known=np.full(B, size_known),
                h_lat=np.full(B, h, np.int32), w_lat=np.full(B, w, np.int32),
                img_count=np.asarray(counts, np.int32), header_seen=np.full(B, 2, np.int32))
    return (jg.GrammarState(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            pg.GrammarState(**{k: _t(v) for k, v in arrs.items()}))


@pytest.mark.parametrize("h,w", [(2, 3), (3, 2), (2, 1), (2, 2), (4, 4), (1, 1)])
@pytest.mark.parametrize("in_image", [True, False])
def test_emu3_masks_forced_and_residual_equal_jax(h, w, in_image):
    """Every offset from before the first row to past the <pad> rows, for
    the window, the forced-token table and the residual row."""
    jspec, pspec = jg.GrammarSpec(**TOY), pg.GrammarSpec(**TOY)
    counts = list(range(0, (w + 1) * h + 8))
    jst, pst = _states(counts, h, w, in_image=in_image)
    W = 8
    scores = np.random.default_rng(h * 10 + w).standard_normal(
        (len(counts), W, V)).astype(np.float32)
    want = np.asarray(jg.apply_grammar(jspec, jst, jnp.asarray(scores)))
    got = pg.apply_grammar(pspec, pst, torch.from_numpy(scores)).numpy()
    np.testing.assert_array_equal(got, want)
    o = np.asarray(counts, np.int32)[:, None] + np.arange(W, dtype=np.int32)[None]
    jf, jt = jg.forced_token_at(jspec, jst, jnp.asarray(o))
    pf, ptok = pg.forced_token_at(pspec, pst, torch.from_numpy(o))
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(jt))
    k = np.random.default_rng(1).integers(0, W, len(counts)).astype(np.int32)
    want1 = np.asarray(jg.apply_grammar_single(jspec, jst, jnp.asarray(scores[:, 0]),
                                               jnp.asarray(k)))
    got1 = pg.apply_grammar_single(pspec, pst, torch.from_numpy(scores[:, 0]),
                                   torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got1, want1)


def test_emu3_offsets_of_the_reference():
    """tests/test_grammar.py:104 on the port: <eol> at p % (w+1) == 0 (also
    past the grid), then <eof>, <eoi>, <eos>, <pad> at their offsets."""
    spec = pg.GrammarSpec(**dict(TOY, img_token_id=-1))
    _, st = _states([0], 2, 3)
    out = pg.apply_grammar(spec, st, torch.zeros((1, 13, V)))[0]
    expected = {3: [57], 7: [57], 8: [59], 9: [58], 10: [60], 11: [57], 12: [61]}
    for i in range(13):
        allowed = torch.nonzero(out[i] > pg.NEG_INF / 2).flatten().tolist()
        if i in expected:
            assert allowed == expected[i], (i, allowed)
        else:
            assert min(allowed) >= 4 and max(allowed) <= 47, (i, allowed)


@pytest.mark.parametrize("mask_mode", [False, True])
def test_emu3_state_arms_at_the_marker_without_counting(mask_mode):
    """tests/test_grammar.py:161 on both packages: the prompt scan arms at the
    marker and counts nothing up to it; then random committed windows, some
    partial, advance both states alike."""
    jspec, pspec = jg.GrammarSpec(**TOY), pg.GrammarSpec(**TOY)
    h = jnp.asarray([2, 3], jnp.int32)
    jst = jg.init_state(2, h_lat=h, w_lat=h + 1)
    pst = pg.init_state(2, h_lat=_t(np.asarray(h)), w_lat=_t(np.asarray(h + 1)))
    prompt = np.asarray([[1] + list(range(30, 39)) + [55, 12, 56],
                         [0, 0, 1, 30, 31, 32, 33, 34, 35, 36, 55, 12, 56]], np.int32)
    mask = prompt != 0
    jst = jg.update_state(jspec, jst, jnp.asarray(prompt), jnp.asarray(mask))
    pst = pg.update_state(pspec, pst, _t(prompt), _t(mask))
    for a, b in zip(pst, jst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert pst.in_image.tolist() == [True, True] and pst.img_count.tolist() == [0, 0]
    rng = np.random.default_rng(5)
    for _ in range(6):
        toks = rng.integers(0, V, (2, 5)).astype(np.int32)
        if mask_mode:
            n = rng.random((2, 5)) < 0.7
        else:
            n = rng.integers(0, 6, 2).astype(np.int32)
        jst = jg.update_state(jspec, jst, jnp.asarray(toks), jnp.asarray(n))
        pst = pg.update_state(pspec, pst, _t(toks), _t(n))
        for a, b in zip(pst, jst):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_rope_table_at_theta_1e6_equals_jax():
    """The 8B's table over every position it has (atol 1e-6: inv_freq
    differs by an ulp between the packages)."""
    jcfg = jemu3.emu3_config(jnp.float32)
    pcfg = pemu3.emu3_config(torch.float32)
    want = np.asarray(jax_rope_table_1d(jcfg, 9216))
    got = pt.rope_table_1d(pcfg, 9216, device="cpu").numpy()
    assert got.shape == want.shape == (9216, 2, 128)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_emu3_config_and_ids_equal_jax():
    pcfg = decoder_config_from_jax(jemu3.emu3_config())
    assert pcfg == pemu3.emu3_config()
    for name in ("VOCAB_SIZE", "PAD_ID", "EOL_ID", "EOF_ID", "BOS_ID", "EOS_ID", "IMG_ID",
                 "BOI_ID", "EOI_ID", "VISUAL_START", "VISUAL_END"):
        assert getattr(pemu3, name) == getattr(jemu3, name), name
    for f in dataclasses.fields(pg.GrammarSpec):
        assert getattr(pemu3.EMU3_GRAMMAR, f.name) == getattr(jemu3.EMU3_GRAMMAR, f.name)


def test_processor_equals_jax():
    rng = np.random.default_rng(0)
    tok = Emu3FakeTokenizer()
    for ratio, area in (("1:1", 720 * 720), ("16:9", 518400), ("3:4", 512 * 512)):
        assert (pproc.calculate_generate_size(ratio, area)
                == jproc.calculate_generate_size(ratio, area))
    assert (pproc.build_gen_prompt([5, 6], 90, 90, tok.encode)
            == jproc.build_gen_prompt([5, 6], 90, 90, tok.encode))
    grid = rng.integers(0, 32768, (3, 5))
    assert (pproc.build_understanding_prompt("what is it", grid, tok.encode)
            == jproc.build_understanding_prompt("what is it", grid, tok.encode))
    toks = jproc.build_gen_prompt([5], 3, 5, tok.encode) + jproc.image_ids_from_grid(grid) + [
        jemu3.EOF_ID, jemu3.EOI_ID, jemu3.EOS_ID]
    np.testing.assert_array_equal(pproc.extract_image_grid(toks), jproc.extract_image_grid(toks))
    np.testing.assert_array_equal(pproc.extract_image_grid(toks), grid)
    assert pproc.codebook_to_visual_id(7) == jproc.codebook_to_visual_id(7)
    assert pproc.visual_id_to_codebook(jemu3.VISUAL_END) == 32767


def _engines(kv_quant, **kw):
    jcfg = dataclasses.replace(TINY_EMU3, kv_quant=kv_quant)
    jeng = jemu3.emu3_engine(model_cfg=jcfg, **kw)
    eng = pemu3.emu3_engine(model_cfg=decoder_config_from_jax(TINY_EMU3), kv_quant=kv_quant,
                            device="cpu", **kw)
    return jeng, eng


def _greedy_pair(jeng, eng, jparams, params, ids, neg, key, **pkw):
    want = jeng.generate(jparams, key, jnp.asarray([ids], jnp.int32),
                         neg_prompt=jnp.asarray([neg], jnp.int32),
                         gstate=jemu3.emu3_grammar_state(1, 4, 4))
    W = eng.config.window
    seeds = _replayed_seeds(key, 1, W, eng.spec.image_vocab_start, eng.spec.image_vocab_end)
    eng._draws = lambda st: StepDraws(next(seeds), None, torch.rand(1, W - 1), None)
    got = eng.generate(params, 0, torch.tensor([ids]), neg_prompt=torch.tensor([neg]), **pkw)
    return want, got


@pytest.mark.parametrize("kv_quant", [True, False], ids=["int8_kv", "bf16_kv"])
def test_tiny_emu3_engine_greedy_equals_jax(kv_quant):
    """A 4 x 4 grid with a shorter negative prompt: the same tokens, NFE and
    accept_hist; the port's engine arms its grid itself (default_gstate),
    and the grammar's offsets hold: 4 rows of 4 visual tokens and <eol>,
    then <eof>, <eoi>, <eos>."""
    kw = dict(h=4, w=4, window=6, greedy=True, image_top_k=64)
    jeng, eng = _engines(kv_quant, **kw)
    jparams = jax_init_params(jax.random.PRNGKey(0), TINY_EMU3)
    params = params_from_jax(np_tree(jparams), eng.model_cfg, device="cpu")
    ids = jproc.build_gen_prompt(list(range(1000, 1012)), 4, 4, lambda s: [1500])
    neg = jproc.build_gen_prompt([1200, 1201], 4, 4, lambda s: [1500])
    want, got = _greedy_pair(jeng, eng, jparams, params, ids, neg, jax.random.PRNGKey(3))
    n = int(want.length[0])
    assert int(got.length[0]) == n
    toks = got.tokens[0, :n].tolist()
    assert toks == np.asarray(want.tokens[0, :n]).tolist()
    assert got.nfe == int(want.nfe)
    np.testing.assert_array_equal(got.accept_hist.numpy(), np.asarray(want.accept_hist))
    gen = toks[len(ids):]
    assert [gen[5 * r + 4] for r in range(4)] == [pemu3.EOL_ID] * 4
    assert gen[20:23] == [pemu3.EOF_ID, pemu3.EOI_ID, pemu3.EOS_ID]
    assert all(pemu3.VISUAL_START <= t <= pemu3.VISUAL_END
               for r in range(4) for t in gen[5 * r: 5 * r + 4])
    assert pproc.extract_image_grid(toks).shape == (4, 4)


def test_emu3_engine_offsets_after_a_prompt():
    """tests/test_engine_edges.py:131 on the port: offsets count from the
    marker at the end of the prompt, not from the prompt's start."""
    spec = pg.GrammarSpec(kind="emu3", image_end_id=49, newline_id=50, eof_id=51, eos_id=62,
                          pad_id=0, image_vocab_start=4, image_vocab_end=47, img_token_id=61)
    from helpers import TINY, tiny_params
    from sjd_tpu_torch.core.engine import EngineConfig, SJDEngine
    from sjd_tpu_torch.core.processors import SamplingParams
    from sjd_tpu_torch.models.adapter import decoder_model_fns

    cfg = decoder_config_from_jax(TINY)
    eng = SJDEngine(decoder_model_fns(cfg, max_positions=512, device="cpu"),
                    EngineConfig(window=6, max_len=40, eos_id=62), spec,
                    SamplingParams(do_cfg=False, image_top_k=40, text_top_k=40))
    params = params_from_jax(np_tree(tiny_params()), cfg, device="cpu")
    gstate = pg.init_state(1, h_lat=torch.tensor([2], dtype=torch.int32),
                           w_lat=torch.tensor([4], dtype=torch.int32))
    res = eng.generate(params, 2, torch.tensor([[1, 2, 3, 7, 61]]), gstate=gstate)
    seq = res.tokens[0, 5:5 + 13].tolist()
    assert seq[4] == 50 and seq[9] == 50, seq
    assert seq[10:13] == [51, 49, 62], seq
    assert all(4 <= t <= 47 for t in seq[:4] + seq[5:9]), seq


def test_blocked_prefill_attention_equals_one_block(monkeypatch):
    """A 2500-token prefill of a tiny GQA decoder on the plain path (int8
    and bf16 caches): the attention over blocks of 1024 query rows against
    one block of all 2500 rows. Each row's softmax is its own, so only the
    products' summation order may move: logits within atol 1e-5."""
    jcfg = dataclasses.replace(TINY_EMU3, vocab_size=256, max_position_embeddings=4096)
    for kv_quant in (True, False):
        cfg = dataclasses.replace(decoder_config_from_jax(jcfg), kv_quant=kv_quant)
        params = params_from_jax(np_tree(jax_init_params(jax.random.PRNGKey(1), jcfg)), cfg,
                                 device="cpu")
        rope = pt.make_rope_table(cfg, 4096, device="cpu")
        T, L = 2500, 2560
        ids = torch.randint(0, 256, (1, T), generator=torch.Generator().manual_seed(0))
        pos = torch.arange(T)[None]
        valid = torch.ones((1, L), dtype=torch.bool)
        valid[0, :7] = False  # a left-padded prompt
        out = {}
        for rows in (pt.ATTEND_BLOCK_ROWS, 4096):
            monkeypatch.setattr(pt, "ATTEND_BLOCK_ROWS", rows)
            kv = pt.init_kv_cache(cfg, 1, L, device="cpu")
            out[rows] = pt.forward(params, cfg, ids, pos, kv, torch.zeros(1, dtype=torch.int32),
                                   valid, rope).logits
        assert pt.ATTEND_BLOCK_ROWS == 4096 and out[1024].shape == (1, T, 256)
        np.testing.assert_allclose(out[1024].numpy(), out[4096].numpy(), atol=1e-5, rtol=0)
        monkeypatch.setattr(pt, "ATTEND_BLOCK_ROWS", 1024)


@pytest.fixture(scope="module")
def emu3_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("emu3")
    sd = synth_hf_llama_state_dict(dataclasses.replace(TINY_EMU3, num_kv_heads=2), seed=3)
    ckpt_dir = str(root / "emu3")
    save_torch_bins(sd, ckpt_dir, shards=2)
    vq_dir = str(root / "emu3_vq")
    save_sharded_safetensors(jax_synth_vq(4, TINY_EMU3_VQ), vq_dir, shards=2)
    return ckpt_dir, vq_dir


def test_emu3_disk_drill_equals_jax(emu3_files):
    """tests/test_checkpoint_drill.py:77 through both loaders: sharded .bin
    decoder (GQA, no qk-norm) and sharded-safetensors VisionVQ, the duck
    tokenizer: smoke False, the same trees and prompt ids, the same greedy
    tokens, NFE and accept_hist, and images within 1 of each other."""
    ckpt_dir, vq_dir = emu3_files
    jcfg = dataclasses.replace(TINY_EMU3, num_kv_heads=2)
    tok = Emu3FakeTokenizer()
    kw = dict(ckpt_dir=ckpt_dir, vq_ckpt_dir=vq_dir, h=2, w=2, quantize=False, tokenizer=tok)
    jm = jax_loader.load_emu3(model_cfg=jcfg, vq_cfg=TINY_EMU3_VQ, **kw)
    pcfg, vcfg = decoder_config_from_jax(jcfg), emu3_vq_config_from_jax(TINY_EMU3_VQ)
    pm = load_emu3(model_cfg=pcfg, vq_cfg=vcfg, device="cpu", **kw)
    assert jm.smoke is False and pm.smoke is False, pm.extras["smoke_reasons"]
    assert_trees_equal(pm.params, params_from_jax(np_tree(jm.params), pm.engine.model_cfg,
                                                  device="cpu"))
    assert_trees_equal(pm.extras["vq_params"], emu3_vq_params_from_jax(
        np_tree(jm.extras["vq_params"]), vcfg, device="cpu"))
    ids = pm.extras["prompt_ids_fn"]("a landscape")
    neg = pm.extras["neg_ids_fn"]()
    assert ids == jm.extras["prompt_ids_fn"]("a landscape")
    assert neg == jm.extras["neg_ids_fn"]()

    jeng = jemu3.emu3_engine(model_cfg=jcfg, h=2, w=2, greedy=True)
    eng = pemu3.emu3_engine(model_cfg=pcfg, h=2, w=2, greedy=True, kv_quant=False,
                            device="cpu")
    key = jax.random.PRNGKey(3)
    want = jeng.generate(jm.params, key, jnp.asarray([ids], jnp.int32),
                         neg_prompt=jnp.asarray([neg], jnp.int32),
                         gstate=jemu3.emu3_grammar_state(1, 2, 2))
    W = eng.config.window
    seeds = _replayed_seeds(key, 1, W, eng.spec.image_vocab_start, eng.spec.image_vocab_end)
    eng._draws = lambda st: StepDraws(next(seeds), None, torch.rand(1, W - 1), None)
    got = eng.generate(pm.params, 0, torch.tensor([ids]), neg_prompt=torch.tensor([neg]),
                       gstate=pm.extras["make_gstate"]([None]))
    n = int(want.length[0])
    toks = got.tokens[0, :n].tolist()
    assert int(got.length[0]) == n and toks == np.asarray(want.tokens[0, :n]).tolist()
    assert got.nfe == int(want.nfe)
    np.testing.assert_array_equal(got.accept_hist.numpy(), np.asarray(want.accept_hist))
    img = pm.extras["decode_image_fn"](toks)
    jimg = np.asarray(jm.extras["decode_image_fn"](toks))
    side = 2 * TINY_EMU3_VQ.spatial_factor
    assert img.shape == jimg.shape == (side, side, 3) and img.dtype == np.uint8
    assert np.abs(img.astype(int) - jimg.astype(int)).max() <= 1
    # the loader's own sample_fn runs the whole path
    assert pm.sample_fn("a landscape", 0).shape == (side, side, 3)


def _greedy(model):
    model.engine.sampling = dataclasses.replace(model.engine.sampling, greedy=True)
    return model.engine


def test_load_emu3_default_engine_equals_jax(emu3_files):
    """Both loaders' own engines with no kv_quant passed on either side: a
    cache of the model's dtype with no scales on both (the JAX
    DecoderConfig default), and, made greedy, the same tokens, NFE and
    accept_hist."""
    ckpt_dir, vq_dir = emu3_files
    jcfg = dataclasses.replace(TINY_EMU3, num_kv_heads=2)
    kw = dict(ckpt_dir=ckpt_dir, vq_ckpt_dir=vq_dir, h=2, w=2, quantize=False,
              tokenizer=Emu3FakeTokenizer())
    jm = jax_loader.load_emu3(model_cfg=jcfg, vq_cfg=TINY_EMU3_VQ, **kw)
    pm = load_emu3(model_cfg=decoder_config_from_jax(jcfg),
                   vq_cfg=emu3_vq_config_from_jax(TINY_EMU3_VQ), device="cpu", **kw)
    assert jm.engine.model_cfg.kv_quant is False and pm.engine.model_cfg.kv_quant is False
    kv = pm.engine.model.init_cache(2, 8)
    assert kv.k.dtype == torch.float32 and kv.k_scale is None
    jeng, eng = _greedy(jm), _greedy(pm)
    ids, neg = pm.extras["prompt_ids_fn"]("a landscape"), pm.extras["neg_ids_fn"]()
    key = jax.random.PRNGKey(4)
    want = jeng.generate(jm.params, key, jnp.asarray([ids], jnp.int32),
                         neg_prompt=jnp.asarray([neg], jnp.int32))
    W = eng.config.window
    seeds = _replayed_seeds(key, 1, W, eng.spec.image_vocab_start, eng.spec.image_vocab_end)
    eng._draws = lambda st: StepDraws(next(seeds), None, torch.rand(1, W - 1), None)
    got = eng.generate(pm.params, 0, torch.tensor([ids]), neg_prompt=torch.tensor([neg]))
    n = int(want.length[0])
    assert int(got.length[0]) == n
    assert got.tokens[0, :n].tolist() == np.asarray(want.tokens[0, :n]).tolist()
    assert got.nfe == int(want.nfe)
    np.testing.assert_array_equal(got.accept_hist.numpy(), np.asarray(want.accept_hist))
    # the int8 cache stays an explicit choice
    q = load_emu3(model_cfg=decoder_config_from_jax(jcfg), h=2, w=2, quantize=False,
                  kv_quant=True, vq_cfg=emu3_vq_config_from_jax(TINY_EMU3_VQ), device="cpu")
    assert q.engine.model_cfg.kv_quant is True


def test_load_emu3_understand_fn_runs_the_bucketed_prompt():
    """understand_fn: the image through the VQ encoder into the left-padded
    understanding prompt, no CFG, no grammar; the answer stays in budget."""
    vcfg = emu3_vq_config_from_jax(TINY_EMU3_VQ)
    m = load_emu3(h=2, w=2, quantize=False, model_cfg=decoder_config_from_jax(TINY_EMU3),
                  vq_cfg=vcfg, tokenizer=Emu3FakeTokenizer(), device="cpu")
    img = np.random.default_rng(0).uniform(-1, 1, (4, 4, 3)).astype(np.float32)
    ans = m.extras["understand_fn"]("what is it", img, 0, max_new_tokens=6)
    res = m.extras["last_understand_result"]
    assert 1 <= len(ans) <= 6 + m.engine.config.window
    assert int(res.length[0]) - len(ans) == 2 * 3 + 128  # the bucket
    with pytest.raises(ValueError, match="tokenizer"):
        load_emu3(h=2, w=2, quantize=False, model_cfg=decoder_config_from_jax(TINY_EMU3),
                  vq_cfg=vcfg, device="cpu").extras["understand_fn"]("q", img)


def test_emu3_tokenizer_equals_jax(tmp_path):
    """The tiktoken tokenizer of both packages on a small vocabulary written
    here (where tiktoken is installed)."""
    pytest.importorskip("tiktoken")
    import base64

    from sjd_tpu.utils.emu3_tokenizer import Emu3Tokenizer as JaxTok
    from sjd_tpu_torch.utils.emu3_tokenizer import Emu3Tokenizer

    words = [bytes([b]) for b in range(256)] + [b"ca", b"cat", b" a", b"ph"]
    (tmp_path / "v.tiktoken").write_bytes(b"\n".join(
        base64.b64encode(t) + b" " + str(i).encode() for i, t in enumerate(words)))
    (tmp_path / "vis.txt").write_text("<|image start|>\n<|image end|>\n<|image token|>\n"
                                      "<|visual token 000000|>\n<|visual token 000001|>\n")
    a = Emu3Tokenizer(str(tmp_path / "v.tiktoken"), str(tmp_path / "vis.txt"))
    b = JaxTok(str(tmp_path / "v.tiktoken"), str(tmp_path / "vis.txt"))
    text = "a cat<|image start|>90*90<|image token|>"
    assert a.encode(text) == b.encode(text)
    assert a.decode(a.encode(text)) == b.decode(b.encode(text))
    for name in ("bos_id", "eos_id", "pad_id", "boi_id", "eoi_id", "eol_id", "eof_id",
                 "img_id", "vocab_size"):
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("family", ["emu3", "anole_image_only", "anole_interleaved"])
def test_step_reads_nothing_on_the_host(family):
    """The decode step of an Emu3 (neg_prompt CFG, the grid armed by
    default_gstate) and an Anole engine (mask_prompt CFG, with the <boi>
    room and eos-at-begin constraints) under the dispatch mode of
    tests/test_torch_core.py: no device value read on the host, which is
    what lets the engine capture the step as a CUDA graph."""
    from sjd_tpu_torch.models import anole as panole
    from test_torch_core import _NoHostReads

    pcfg = decoder_config_from_jax(TINY_EMU3 if family == "emu3" else dataclasses.replace(
        TINY_EMU3, vocab_size=65536, num_kv_heads=4, qk_norm=True, rope_theta=10000.0))
    params = pt.init_params(0, pcfg, device="cpu")
    if family == "emu3":
        eng = pemu3.emu3_engine(model_cfg=pcfg, h=3, w=3, window=5, device="cpu")
        ids = pproc.build_gen_prompt([1000, 1001], 3, 3, lambda s: [1500])
        kw = dict(neg_prompt=torch.tensor([ids[:1] + ids[-3:]]))
    else:
        mode = family.split("_", 1)[1].replace("_", "-")
        eng = panole.anole_engine(model_cfg=pcfg, window=5, image_seq_length=9, max_len=30,
                                  multimodal_generation_mode=mode, device="cpu")
        ids = [9000, 9001] + ([panole.BOI_ID] if mode == "image-only" else [])
        kw = {}
    _, st = eng.generate(params, 0, torch.tensor([ids]), max_steps=2, return_state=True, **kw)
    draws = eng._draws(st)
    before = st.length.clone()
    with torch.no_grad(), _NoHostReads():
        eng._step_into(params, st, draws)
    assert bool((st.length > before).all())


@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "w4a16"])
def test_params_from_jax_on_emu3_and_anole_trees(quantize):
    """params_from_jax on the 8B's attention layout at a narrow width: GQA
    wk/wv of 1024 rows under a 4096-row wq, no qk-norm leaves, and an
    Anole (Chameleon 7B layout) tree with them; bf16 and the JAX package's
    W4A16 bytes (packed int4, int8 head)."""
    from sjd_tpu.models.chameleon import chameleon_config
    from sjd_tpu.models.transformer import quantize_weights

    narrow = dict(hidden_size=64, intermediate_size=128, num_layers=2, vocab_size=512)
    for jcfg in (dataclasses.replace(jemu3.emu3_config(), **narrow),
                 dataclasses.replace(chameleon_config("7B"), **narrow)):
        tree = jax_init_params(jax.random.PRNGKey(2), jcfg)
        if quantize:
            tree = quantize_weights(tree, bits=4, head_bits=8, equilibrate=False, config=jcfg)
        pcfg = decoder_config_from_jax(jcfg)
        got = params_from_jax(np_tree(tree), pcfg, device="cpu")
        lay = got["layers"]
        wk = lay["wk"]["q4p"] if quantize else lay["wk"]
        assert wk.shape[:2] == (2, jcfg.num_kv_heads * 128)
        assert ("q_norm_scale" in lay) == jcfg.qk_norm
        for name, leaf in tree["layers"].items():
            want = leaf if isinstance(leaf, dict) else {"w": leaf}
            have = lay[name] if isinstance(lay[name], dict) else {"w": lay[name]}
            for k in want:
                np.testing.assert_array_equal(have[k].float().numpy(),
                                              np.asarray(want[k]).astype(np.float32))
