"""LlamaGen in the port (sjd_tpu_torch/models/llamagen.py, the engine's
prompt embeddings, the 2-D RoPE table, loader.load_llamagen and
StreamingBatcher's embedding mode) against sjd_tpu on the same inputs:

  * the 2-D RoPE table, atol 1e-6;
  * the class and caption embedders, f32, rtol 1e-5;
  * llamagen_config for all 8 GPT sizes, exactly;
  * greedy c2i and t2i (a full and a masked caption) on a 2-layer GPT at
    a 4 x 4 latent: tokens, NFE and accept_hist equal (the JAX engine's
    draft seeds replayed);
  * refill with embedding prompts (tests/test_continuous_batching.py:209),
    greedy: every slot's tokens equal;
  * a caption of n < 120 real rows: both engines number positions by real
    rows, so the first image tokens of the cond half sit below
    rope_2d_cls_len with zero rotation (the JAX package's behaviour,
    pinned here);
  * the load_llamagen checkpoint drill (tests/test_checkpoint_drill.py:139)
    through both loaders, and the t2i prompt path through a T5 directory;
  * StreamingBatcher in embedding mode: greedy tokens equal sjd_tpu's per
    request, sampled ones equal the port's own solo runs;
  * a head width the kernels do not take (GPT-3B's 100) refused on CUDA.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ckpt_synth import save_torch_pt, synth_llamagen_state_dict, synth_vqgan_state_dict
from sjd_tpu import loader as jax_loader
from sjd_tpu.core.serving import StreamingBatcher as JaxStreamingBatcher
from sjd_tpu.models import DecoderConfig
from sjd_tpu.models import init_params as jax_init_params
from sjd_tpu.models import llamagen as jl
from sjd_tpu.models import t5 as jt5
from sjd_tpu.models.transformer import make_rope_table as jax_make_rope_table
from sjd_tpu.models.vq import VQConfig
from sjd_tpu_torch.convert import (
    cond_params_from_jax, decoder_config_from_jax, params_from_jax,
    vq_config_from_jax, vq_params_from_jax)
from sjd_tpu_torch.core.engine import StepDraws
from sjd_tpu_torch.core.serving import StreamingBatcher, seed_generators
from sjd_tpu_torch.loader import load_llamagen, load_pretrained_model
from sjd_tpu_torch.models import llamagen as pl
from sjd_tpu_torch.models import transformer as pt
from test_torch_checkpoint import assert_trees_equal, np_tree
from test_torch_lumina_slice import _replayed_seeds
from test_torch_t5 import TINY_T5, StubT5Tokenizer, write_t5_dir

LATENT = 4
CAPTION_DIM = 16
WAIT_S = 120


def tiny_cfg(cls_len):
    return DecoderConfig(
        vocab_size=16384, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
        num_kv_heads=4, head_dim=8, rope_style="2d", rope_2d_cls_len=cls_len,
        rope_2d_grid_side=LATENT, dtype=jnp.float32, max_position_embeddings=64)


def np_cond(cond):
    return {k: v if k == "kind" else np.asarray(v) for k, v in cond.items()}


@pytest.mark.parametrize("cls_len,side,head_dim,theta", [
    (120, 32, 64, 10000.0), (1, 16, 64, 10000.0), (6, 4, 8, 10000.0), (3, 5, 16, 500.0)])
def test_rope_table_2d_equals_jax(cls_len, side, head_dim, theta):
    jcfg = dataclasses.replace(tiny_cfg(cls_len), head_dim=head_dim, rope_theta=theta,
                               rope_2d_grid_side=side)
    n = cls_len + side * side + 40
    want = np.asarray(jax_make_rope_table(jcfg, n))
    got = pt.make_rope_table(decoder_config_from_jax(jcfg), n, device="cpu")
    assert got.shape == (n, 2, head_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # the conditioning rows do not rotate
    assert (got[:cls_len, 0] == 1).all() and (got[:cls_len, 1] == 0).all()


@pytest.mark.parametrize("model_type", ["c2i", "t2i"])
def test_cond_embedders_equal_jax(model_type):
    cfg = tiny_cfg(6)
    cond = jl.init_cond_params(jax.random.PRNGKey(1), cfg, num_classes=10,
                               caption_dim=CAPTION_DIM, model_type=model_type)
    pc = cond_params_from_jax(np_cond(cond), device="cpu")
    assert pc["kind"] == model_type
    if model_type == "c2i":
        labels = np.asarray([3, 0, 9], np.int32)
        pairs = [(jl.embed_class(cond, jnp.asarray(labels), jnp.float32),
                  pl.embed_class(pc, torch.from_numpy(labels), torch.float32)),
                 (jl.embed_uncond_class(cond, 3, jnp.float32),
                  pl.embed_uncond_class(pc, 3, torch.float32))]
    else:
        feats = np.random.RandomState(0).randn(2, 6, CAPTION_DIM).astype(np.float32)
        pairs = [(jl.embed_caption(cond, jnp.asarray(feats), jnp.float32),
                  pl.embed_caption(pc, torch.from_numpy(feats), torch.float32)),
                 (jl.embed_uncond_caption(cond, 2, jnp.float32),
                  pl.embed_uncond_caption(pc, 2, torch.float32))]
    for want, got in pairs:
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    # the random init: the JAX package's tree, shapes and scales
    mine = pl.init_cond_params(1, decoder_config_from_jax(cfg), num_classes=10,
                               caption_dim=CAPTION_DIM, model_type=model_type, device="cpu")
    assert set(mine) == set(cond)
    for k in cond:
        if k != "kind":
            assert tuple(mine[k].shape) == cond[k].shape
            assert mine[k].std().item() == pytest.approx(float(np.std(cond[k])), rel=0.5)


@pytest.mark.parametrize("name", list(pl.SIZES))
def test_llamagen_config_equals_jax(name):
    for block, cls_len in ((256, 1), (1024, 120)):
        want = jl.llamagen_config(name, block_size=block, cls_token_num=cls_len)
        got = pl.llamagen_config(name, block_size=block, cls_token_num=cls_len)
        assert got == decoder_config_from_jax(want)
        assert got.rope_style == "2d" and got.rope_2d_grid_side ** 2 == block


def _engines(cls_len, **kw):
    cfg = tiny_cfg(cls_len)
    kw = dict(latent_size=LATENT, cls_token_num=cls_len, window=4, greedy=True,
              image_top_k=64, **kw)
    jeng = jl.llamagen_engine(model_cfg=cfg, **kw)
    eng = pl.llamagen_engine(model_cfg=decoder_config_from_jax(cfg), device="cpu", **kw)
    return cfg, jeng, eng


def _models(cfg, model_type, num_classes=10):
    jparams = jax_init_params(jax.random.PRNGKey(0), cfg)
    cond = jl.init_cond_params(jax.random.PRNGKey(1), cfg, num_classes=num_classes,
                               caption_dim=CAPTION_DIM, model_type=model_type)
    params = params_from_jax(np_tree(jparams), decoder_config_from_jax(cfg), device="cpu")
    return jparams, cond, params, cond_params_from_jax(np_cond(cond), device="cpu")


def _caption(B, cls_len, n_real, seed=0):
    """Left-padded caption features [B, cls_len, CAPTION_DIM] and their mask."""
    feats = np.random.RandomState(seed).randn(B, cls_len, CAPTION_DIM).astype(np.float32)
    mask = np.zeros((B, cls_len), bool)
    mask[:, cls_len - n_real:] = True
    return feats * mask[..., None], mask


def _prompts(model_type, cond, pc, B, cls_len, n_real):
    """The JAX and the port's (embeds, neg embeds, mask) of B prompts."""
    if model_type == "c2i":
        labels = np.arange(3, 3 + B, dtype=np.int32)
        return ((jl.embed_class(cond, jnp.asarray(labels), jnp.float32),
                 jl.embed_uncond_class(cond, B, jnp.float32), None),
                (pl.embed_class(pc, torch.from_numpy(labels), torch.float32),
                 pl.embed_uncond_class(pc, B, torch.float32), None))
    feats, mask = _caption(B, cls_len, n_real)
    return ((jl.embed_caption(cond, jnp.asarray(feats), jnp.float32),
             jl.embed_uncond_caption(cond, B, jnp.float32), jnp.asarray(mask)),
            (pl.embed_caption(pc, torch.from_numpy(feats), torch.float32),
             pl.embed_uncond_caption(pc, B, torch.float32), torch.from_numpy(mask)))


CASES = {"c2i": ("c2i", 1, 1), "t2i": ("t2i", 6, 6), "t2i_masked": ("t2i", 6, 2)}


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_generation_equals_jax(case):
    """One image on both engines: the same tokens, NFE and accept_hist; the
    token row is the prompt's zero placeholders, then 16 image tokens."""
    model_type, cls_len, n_real = CASES[case]
    cfg, jeng, eng = _engines(cls_len)
    jparams, cond, params, pc = _models(cfg, model_type)
    (jpe, jne, jm), (ppe, pne, pm) = _prompts(model_type, cond, pc, 1, cls_len, n_real)
    key = jax.random.PRNGKey(3)
    want = jeng.generate(jparams, key, prompt_embeds=jpe, neg_prompt_embeds=jne,
                         prompt_mask=jm)
    W = eng.config.window
    seeds = _replayed_seeds(key, 1, W, eng.spec.image_vocab_start, eng.spec.image_vocab_end)
    eng._draws = lambda st: StepDraws(next(seeds), None, torch.rand(1, W - 1), None)
    got = eng.generate(params, 0, prompt_embeds=ppe, neg_prompt_embeds=pne, prompt_mask=pm)
    n = int(want.length[0])
    assert n == int(got.length[0]) == cls_len + LATENT ** 2
    toks = got.tokens[0, :n].tolist()
    assert toks == np.asarray(want.tokens[0, :n]).tolist()
    assert toks[:cls_len] == [0] * cls_len and all(0 <= t < 16384 for t in toks[cls_len:])
    assert got.nfe == int(want.nfe)
    np.testing.assert_array_equal(got.accept_hist.numpy(), np.asarray(want.accept_hist))


def test_masked_caption_positions_equal_jax():
    """A caption of 2 real rows in a 6-row prefix: both engines leave the same
    left padding (4 rows in the cond half, none in the uncond half, whose
    rows are all attended) and lengths, so the cond half's first image token
    sits at position 2, below rope_2d_cls_len = 6, where the 2-D table does
    not rotate, and its grid starts 4 tokens late; the uncond half's sits at
    6. The LlamaGen reference counts positions from 120 in both halves:
    this pins the JAX package's numbering, which the port keeps."""
    cls_len, n_real = 6, 2
    cfg, jeng, eng = _engines(cls_len)
    jparams, cond, params, pc = _models(cfg, "t2i")
    (jpe, jne, jm), (ppe, pne, pm) = _prompts("t2i", cond, pc, 1, cls_len, n_real)
    _, jst = jeng.generate(jparams, jax.random.PRNGKey(3), prompt_embeds=jpe,
                           neg_prompt_embeds=jne, prompt_mask=jm, max_steps=1,
                           return_state=True)
    _, st = eng.generate(params, 0, prompt_embeds=ppe, neg_prompt_embeds=pne, prompt_mask=pm,
                         max_steps=1, return_state=True)
    assert st.n_pad.tolist() == np.asarray(jst.n_pad).tolist() == [cls_len - n_real, 0]
    assert st.length.tolist() == np.asarray(jst.length).tolist() == [cls_len + 1]
    first = (torch.cat([st.length, st.length]) - 1 - st.n_pad).tolist()
    assert first == [n_real, cls_len]
    table = pt.make_rope_table(eng.model_cfg, 64, device="cpu")
    assert (table[n_real:cls_len, 0] == 1).all() and (table[n_real:cls_len, 1] == 0).all()
    assert not (table[cls_len + 1, 1] == 0).all()  # the grid's second column turns


def test_refill_with_embedding_prompts_equals_jax():
    """tests/test_continuous_batching.py:209 on both engines, greedy: slot 0
    re-armed mid-flight from new class embeddings while slot 1 runs on;
    every slot's tokens equal sjd_tpu's, slot 1's those of a run without
    the refill."""
    cfg, jeng, eng = _engines(1, guidance_scale=4.0)
    jparams, cond, params, pc = _models(cfg, "c2i")
    (jpe, jne, _), (ppe, pne, _) = _prompts("c2i", cond, pc, 2, 1, 1)
    jpe2 = jl.embed_class(cond, jnp.asarray([5, 5], jnp.int32), jnp.float32)
    ppe2 = pl.embed_class(pc, torch.tensor([5, 5]), torch.float32)
    alone = eng.generate(params, 1, prompt_embeds=ppe, neg_prompt_embeds=pne)

    _, jst = jeng.generate(jparams, jax.random.PRNGKey(1), prompt_embeds=jpe,
                           neg_prompt_embeds=jne, max_steps=3, return_state=True)
    _, st = eng.generate(params, 1, prompt_embeds=ppe, neg_prompt_embeds=pne, max_steps=3,
                         return_state=True)
    jst = jeng.refill(jparams, jst, None, np.asarray([True, False]), prompt_embeds=jpe2,
                      neg_prompt_embeds=jne)
    st = eng.refill(params, st, None, [True, False], prompt_embeds=ppe2, neg_prompt_embeds=pne)
    assert st.nfe == 4
    for _ in range(40):
        if bool(np.asarray(jst.finished).all()) and bool(st.finished.all()):
            break
        _, jst = jeng.resume(jparams, jst, max_steps=4, return_state=True)
        _, st = eng.resume(params, st, max_steps=4, return_state=True)
    for b in range(2):
        n = int(jst.length[b])
        assert int(st.length[b]) == n
        np.testing.assert_array_equal(st.tokens[b, :n].numpy(), np.asarray(jst.tokens[b, :n]))
    n = int(alone.length[1])
    assert torch.equal(st.tokens[1, :n], alone.tokens[1, :n])
    solo = eng.generate(params, 1, prompt_embeds=ppe2[:1], neg_prompt_embeds=pne[:1])
    assert torch.equal(st.tokens[0, :int(st.length[0])], solo.tokens[0, :int(solo.length[0])])


@pytest.fixture(scope="module")
def llamagen_files(tmp_path_factory):
    from safetensors.numpy import save_file

    root = tmp_path_factory.mktemp("llamagen")
    sd = synth_llamagen_state_dict(tiny_cfg(1), seed=7, num_classes=10)
    gpt_path = str(root / "llamagen" / "GPT-tiny.pt")
    save_torch_pt(sd, gpt_path, nest="model")
    vq_sd = synth_vqgan_state_dict(TINY_VQ16, seed=8, style="llamagen")
    vq_path = str(root / "llamagen_vq.safetensors")
    save_file(vq_sd, vq_path)
    return gpt_path, vq_path


TINY_VQ16 = VQConfig(ch=32, ch_mult=(1, 1, 1, 1, 1), num_res_blocks=1, z_channels=32,
                     embed_dim=8, n_embed=16384, l2_norm_codebook=True)


def test_llamagen_disk_drill_equals_jax(llamagen_files):
    """tests/test_checkpoint_drill.py:139 through both loaders: a .pt with
    the "model" nesting (fused wqkv, interleaved RoPE rows, the c2i label
    table) and a safetensors VQ-16 in LlamaGen's naming: smoke False, the
    same decoder, condition and VQ trees, the same greedy tokens, NFE and
    accept_hist for class 3, and images within 1 of each other."""
    gpt_path, vq_path = llamagen_files
    jcfg = tiny_cfg(1)
    kw = dict(gpt_ckpt=gpt_path, vq_ckpt=vq_path, latent_size=LATENT, model_type="c2i")
    jm = jax_loader.load_llamagen(model_cfg=jcfg, vq_cfg=TINY_VQ16, **kw)
    pcfg, vcfg = decoder_config_from_jax(jcfg), vq_config_from_jax(TINY_VQ16)
    pm = load_llamagen(model_cfg=pcfg, vq_cfg=vcfg, device="cpu", **kw)
    assert jm.smoke is False and pm.smoke is False, pm.extras["smoke_reasons"]
    assert pm.name == jm.name == "llamagen-GPT-XL"
    assert_trees_equal(pm.params, params_from_jax(np_tree(jm.params), pcfg, device="cpu"))
    pcond = dict(pm.extras["cond"])
    jcond = cond_params_from_jax(np_cond(jm.extras["cond"]), device="cpu")
    assert pcond.pop("kind") == jcond.pop("kind") == "c2i"
    assert_trees_equal(pcond, jcond)
    assert_trees_equal(pm.extras["vq_params"], vq_params_from_jax(
        np_tree(jm.extras["vq_params"]), vcfg, device="cpu"))
    assert pm.extras["prompt_width"] == jm.extras["prompt_width"] == 1
    assert pm.extras["embed_dim"] == jm.extras["embed_dim"] == 32

    jpe, jne, jmask = jm.extras["embed_prompt_fn"](3)
    ppe, pne, pmask = pm.extras["embed_prompt_fn"](3)
    assert jmask is None and pmask is None
    np.testing.assert_array_equal(ppe.numpy(), np.asarray(jpe))
    np.testing.assert_array_equal(pne.numpy(), np.asarray(jne))
    _, jeng, eng = _engines(1)
    key = jax.random.PRNGKey(3)
    want = jeng.generate(jm.params, key, prompt_embeds=jpe, neg_prompt_embeds=jne)
    W = eng.config.window
    seeds = _replayed_seeds(key, 1, W, eng.spec.image_vocab_start, eng.spec.image_vocab_end)
    eng._draws = lambda st: StepDraws(next(seeds), None, torch.rand(1, W - 1), None)
    got = eng.generate(pm.params, 0, prompt_embeds=ppe, neg_prompt_embeds=pne)
    n = int(want.length[0])
    toks = got.tokens[0, :n].tolist()
    assert int(got.length[0]) == n and toks == np.asarray(want.tokens[0, :n]).tolist()
    assert got.nfe == int(want.nfe)
    np.testing.assert_array_equal(got.accept_hist.numpy(), np.asarray(want.accept_hist))
    img = pm.extras["decode_image_fn"](toks)
    jimg = np.asarray(jm.extras["decode_image_fn"](toks))
    assert img.shape == jimg.shape == (64, 64, 3) and img.dtype == np.uint8
    assert np.abs(img.astype(int) - jimg.astype(int)).max() <= 1
    # the loader's own sample_fn runs the whole path
    assert pm.sample_fn("3", 0).shape == (64, 64, 3)
    assert pm.extras["last_result"].gen_count.tolist() == [LATENT ** 2]


def test_load_llamagen_t2i_caption_path_equals_jax(tmp_path):
    """load_llamagen(model_type="t2i") with a T5 directory and the stub
    tokenizer: embed_prompt_fn's rows equal the JAX encoder and caption
    embedder run by hand on the same token ids (f32, rtol 1e-5), the mask is
    the caption's, and sample_fn gives an image."""
    sd = write_t5_dir(str(tmp_path / "t5"), TINY_T5)
    tok = StubT5Tokenizer(TINY_T5.vocab_size)
    pcfg = decoder_config_from_jax(tiny_cfg(12))
    pm = load_llamagen(latent_size=LATENT, model_type="t2i", cls_token_num=12, model_cfg=pcfg,
                       vq_cfg=vq_config_from_jax(TINY_VQ16), t5_dir=str(tmp_path / "t5"),
                       t5_tokenizer=tok, device="cpu")
    assert pm.extras["smoke_reasons"] == ["random GPT weights (no gpt_ckpt)",
                                          "random VQ decoder (no vq_ckpt)"]
    assert pm.extras["cond"]["fc1"].shape == (TINY_T5.d_model, 32)
    pe, ne, mask = pm.extras["embed_prompt_fn"]("a red fox in the snow")
    ids, mask0 = pm.extras["t5"].tokenize(["a red fox in the snow"])
    out = np.asarray(jt5.t5_encode(jt5.port_t5_encoder(sd, TINY_T5), TINY_T5,
                                   jnp.asarray(ids, jnp.int32), jnp.asarray(mask0)))
    feats, want_mask = jt5.flip_padding_to_left(out * mask0[:, :, None], mask0)
    jcond = {k: v if k == "kind" else jnp.asarray(v.numpy())
             for k, v in pm.extras["cond"].items()}
    want = jl.embed_caption(jcond, jnp.asarray(feats), jnp.float32)
    want_ne = jl.embed_uncond_caption(jcond, 1, jnp.float32)
    assert pe.dtype == torch.float32 and tuple(pe.shape) == (1, 12, 32)
    np.testing.assert_array_equal(mask.numpy(), want_mask.astype(bool))
    assert mask.sum().item() == 7  # six words and </s>
    np.testing.assert_allclose(pe.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ne.numpy(), np.asarray(want_ne), rtol=1e-5, atol=1e-7)
    img = pm.sample_fn("a red fox in the snow", 0)
    assert img.shape == (64, 64, 3) and img.dtype == np.uint8
    res = pm.extras["last_result"]
    assert res.gen_count.tolist() == [LATENT ** 2] and res.length.tolist() == [12 + 16]


def test_registry_loads_llamagen_on_the_device_asked_for(tmp_path):
    """load_pretrained_model("llamagen") gives a LoadedModel in c2i and t2i
    when the CPU is asked for; without it, it runs on CUDA, which this
    machine lacks."""
    pcfg = decoder_config_from_jax(tiny_cfg(1))
    m = load_pretrained_model("LlamaGen-XL", model_cfg=pcfg, latent_size=LATENT,
                              vq_cfg=vq_config_from_jax(TINY_VQ16), device="cpu")
    assert m.name == "llamagen-GPT-XL" and m.smoke and m.extras["cond"]["kind"] == "c2i"
    assert m.sample_fn(7, 1).shape == (64, 64, 3)
    write_t5_dir(str(tmp_path / "t5"), TINY_T5)
    t = load_pretrained_model("llamagen", model_type="t2i", cls_token_num=6,
                              model_cfg=decoder_config_from_jax(tiny_cfg(6)),
                              latent_size=LATENT, vq_cfg=vq_config_from_jax(TINY_VQ16),
                              t5_dir=str(tmp_path / "t5"), t5_tokenizer=StubT5Tokenizer(96),
                              device="cpu")
    assert not any("T5" in r for r in t.extras["smoke_reasons"])
    assert t.sample_fn("a cat", 0).shape == (64, 64, 3)
    with pytest.raises(ValueError, match="t5_tokenizer"):
        load_pretrained_model("llamagen", model_type="t2i", t5_dir=str(tmp_path / "t5"),
                              device="cpu")
    no_t5 = load_pretrained_model("llamagen", model_type="t2i", cls_token_num=6,
                                  model_cfg=decoder_config_from_jax(tiny_cfg(6)),
                                  latent_size=LATENT, vq_cfg=vq_config_from_jax(TINY_VQ16),
                                  device="cpu")
    with pytest.raises(ValueError, match="T5"):
        no_t5.extras["embed_prompt_fn"]("a cat")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_pretrained_model("llamagen", model_cfg=pcfg, latent_size=LATENT)


def test_head_width_the_kernels_do_not_take_is_refused_on_cuda(monkeypatch):
    """Both kernels take GPT-3B's heads of 100 (and every other published
    size's 64 or 128), so no LlamaGen size is refused on CUDA. A width they
    still do not take (96) is: on CUDA with attn_impl="auto" the engine and
    the loader refuse it before any weight is drawn, naming the explicit
    plain path; the plain path and the CPU pass."""
    cfg3b = pl.llamagen_config("GPT-3B")
    assert cfg3b.head_dim == 100
    assert pt.KERNEL_HEAD_DIMS == (64, 100, 128)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name in pl.SIZES:
        pt.check_kernel_head_dim(pl.llamagen_config(name), "cuda")
    cfg96 = dataclasses.replace(cfg3b, hidden_size=32 * 96, head_dim=96)
    with pytest.raises(ValueError, match='attn_impl="plain"'):
        pl.llamagen_engine(model_cfg=cfg96, latent_size=16, device="cuda")
    with pytest.raises(ValueError, match='attn_impl="plain"'):
        load_llamagen(model_cfg=cfg96, latent_size=16, device="cuda")
    pt.check_kernel_head_dim(dataclasses.replace(cfg96, attn_impl="plain"), "cuda")
    pt.check_kernel_head_dim(cfg96, "cpu")


def _stream_requests(cond, pc, n=3, cls_len=6):
    """n caption requests of 2, 6 and 4 real rows: the JAX and the port's
    per-request (embeds [P, d], neg embeds, mask [P])."""
    out = []
    for i, n_real in enumerate((2, 6, 4)[:n]):
        feats, mask = _caption(1, cls_len, n_real, seed=10 + i)
        je = (jl.embed_caption(cond, jnp.asarray(feats), jnp.float32)[0],
              jl.embed_uncond_caption(cond, 1, jnp.float32)[0], mask[0])
        pe = (pl.embed_caption(pc, torch.from_numpy(feats), torch.float32)[0],
              pl.embed_uncond_caption(pc, 1, torch.float32)[0], torch.from_numpy(mask[0]))
        out.append((je, pe))
    return out


def test_streaming_batcher_embedding_mode_equals_jax():
    """3 caption requests through 2 slots in chunks of 4: each request's
    greedy tokens equal sjd_tpu's StreamingBatcher's in embedding mode."""
    cfg, jeng, eng = _engines(6)
    jparams, cond, params, pc = _models(cfg, "t2i")
    reqs = _stream_requests(cond, pc)
    jsb = JaxStreamingBatcher(jeng, jparams, batch=2, chunk_steps=4, prompt_width=6,
                              embed_dim=32)
    sb = StreamingBatcher(eng, params, batch=2, chunk_steps=4, prompt_width=6, embed_dim=32)
    jh = [jsb.submit(prompt_embeds=je[0], neg_prompt_embeds=je[1], prompt_mask=je[2], seed=i)
          for i, (je, _) in enumerate(reqs)]
    ph = [sb.submit(prompt_embeds=p[0], neg_prompt_embeds=p[1], prompt_mask=p[2], seed=i)
          for i, (_, p) in enumerate(reqs)]
    want = [h.wait(timeout=WAIT_S) for h in jh]
    got = [h.wait(timeout=WAIT_S) for h in ph]
    jsb.close()
    sb.close()
    assert sb.stats()["refills"] >= 1
    for g, w in zip(got, want):
        assert g.prompt_index == w.prompt_index and g.gen_count == w.gen_count == 16
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


def test_streaming_batcher_embedding_mode_equals_solo_runs():
    """Sampled: each request through the batcher (2 slots, 3 requests, the
    embeddings left-padded into an 8-row bucket) equals its solo run with
    the same seed and padding."""
    cls_len, width = 6, 8
    cfg = tiny_cfg(cls_len)
    eng = pl.llamagen_engine(model_cfg=decoder_config_from_jax(cfg), latent_size=LATENT,
                             cls_token_num=cls_len, window=4, image_top_k=64, device="cpu")
    _, cond, params, pc = _models(cfg, "t2i")
    reqs = [p for _, p in _stream_requests(cond, pc)]
    sb = StreamingBatcher(eng, params, batch=2, chunk_steps=4, prompt_width=width,
                          embed_dim=32)
    handles = [sb.submit(prompt_embeds=pe, neg_prompt_embeds=ne, prompt_mask=m, seed=20 + i)
               for i, (pe, ne, m) in enumerate(reqs)]
    got = [h.wait(timeout=WAIT_S) for h in handles]
    sb.close()
    for i, (pe, ne, m) in enumerate(reqs):
        pad = width - cls_len
        z = torch.zeros((pad, 32))
        res = eng.generate(params, seed_generators([20 + i], "cpu"),
                           prompt_embeds=torch.cat([z, pe])[None],
                           neg_prompt_embeds=torch.cat([z, ne])[None],
                           prompt_mask=torch.cat([torch.zeros(pad, dtype=torch.bool), m])[None])
        np.testing.assert_array_equal(got[i].tokens, res.tokens[0, :int(res.length[0])].numpy())
