"""LlamaGen GPT-3B's head width, 100, through the port, against sjd_tpu on
the same numpy inputs: a tiny LlamaGen (2 layers, 2 heads of 100, the 2-D
RoPE) forward and its greedy class-to-image generation, and the plain
versions of both TPU kernels at D = 100 against the Pallas kernels run in
interpret mode, as tests/test_pallas_ops.py runs them (both lower at
D = 100 there).

Tolerances: f32 logits rtol 1e-5 (the two frameworks sum in another
order); greedy tokens, NFE and accept_hist exact; the epilogue's int8 codes
and bf16 outputs bit-equal and its f32 outputs to 1e-6, as
tests/test_torch_fused_epilogue.py holds them at D = 8; the attention to
2e-5 in f32 and one bf16 rounding (1e-2) over an int8 cache, as
tests/test_torch_decode_attention.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sjd_tpu.models import DecoderConfig
from sjd_tpu.models import init_params as jax_init_params
from sjd_tpu.models import llamagen as jl
from sjd_tpu.models import transformer as jt
from sjd_tpu.models.transformer import _quantize_rows as jax_quantize_rows
from sjd_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from sjd_tpu.ops.fused_epilogue import fused_epilogue as jax_fused_epilogue
from sjd_tpu_torch.convert import cond_params_from_jax, decoder_config_from_jax, params_from_jax
from sjd_tpu_torch.core.engine import StepDraws
from sjd_tpu_torch.models import llamagen as pl
from sjd_tpu_torch.models import transformer as pt
from sjd_tpu_torch.ops.decode_attention import decode_attention
from sjd_tpu_torch.ops.fused_epilogue import fused_epilogue
from test_torch_lumina_slice import _replayed_seeds

LATENT = 4
D = 100


def tiny_3b_cfg(cls_len=1):
    """GPT-3B's head width and the 2-D table at a tiny depth and width."""
    return DecoderConfig(
        vocab_size=16384, hidden_size=2 * D, intermediate_size=256, num_layers=2,
        num_heads=2, num_kv_heads=2, head_dim=D, rope_style="2d", rope_2d_cls_len=cls_len,
        rope_2d_grid_side=LATENT, dtype=jnp.float32, max_position_embeddings=64)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_gpt_3b_config_takes_the_kernels():
    """The published GPT-3B: 24 layers of 32 heads of 100, d 3200, ff 8704,
    equal to the JAX registry's; its head width is one the kernels take."""
    cfg = pl.llamagen_config("GPT-3B", block_size=576, cls_token_num=1)
    assert cfg == decoder_config_from_jax(jl.llamagen_config("GPT-3B", block_size=576))
    assert (cfg.num_layers, cfg.num_heads, cfg.head_dim, cfg.hidden_size,
            cfg.intermediate_size, cfg.rope_2d_grid_side) == (24, 32, 100, 3200, 8704, 24)
    assert cfg.head_dim in pt.KERNEL_HEAD_DIMS


@pytest.mark.parametrize("kv_quant", [False, True])
def test_forward_at_head_width_100_equals_jax(kv_quant):
    """A class row's prefill, then a 4-row window, through both forwards:
    f32 logits within rtol 1e-5, the cache rows within the same (int8
    codes equal)."""
    jcfg = dataclasses.replace(tiny_3b_cfg(), kv_quant=kv_quant)
    cfg = decoder_config_from_jax(jcfg)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(_np_tree(jparams), cfg, device="cpu")
    S, L, T = 2, 24, 4
    rng = np.random.default_rng(1)
    embeds = (0.02 * rng.standard_normal((S, 1, 2 * D))).astype(np.float32)
    window = rng.integers(0, 16384, (S, T)).astype(np.int32)
    valid = np.ones((S, L), bool)
    jrope = jt.make_rope_table(jcfg, 32)
    rope = pt.make_rope_table(cfg, 32, device="cpu")
    jkv = jt.init_kv_cache(jcfg, S, L)
    kv = pt.init_kv_cache(cfg, S, L, device="cpu")
    steps = ((np.zeros((S, 1), np.int32), np.zeros((S, 1), np.int32), 0, embeds),
             (window, np.tile(np.arange(1, T + 1, dtype=np.int32), (S, 1)), 1, None))
    for ids, pos, end, emb in steps:
        ce = np.full((S,), end, np.int32)
        jout = jt.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos), jkv,
                          jnp.asarray(ce), jnp.asarray(valid), jrope,
                          inputs_embeds=None if emb is None else jnp.asarray(emb))
        out = pt.forward(params, cfg, torch.from_numpy(ids), torch.from_numpy(pos), kv,
                         torch.from_numpy(ce), torch.from_numpy(valid), rope,
                         inputs_embeds=None if emb is None else torch.from_numpy(emb))
        jkv, kv = jout.kv, out.kv
        np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits),
                                   rtol=1e-5, atol=1e-5)
    got = kv.k.float().numpy()
    want = np.asarray(jkv.k, np.float32)
    if kv_quant:
        assert np.abs(got - want).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_greedy_c2i_at_head_width_100_equals_jax():
    """One class-to-image generation (4 x 4 latents, CFG 7.5 against the
    unconditional class, window 4) on both engines, the JAX draft seeds
    replayed: the same tokens, NFE and accept_hist."""
    jcfg = tiny_3b_cfg()
    kw = dict(latent_size=LATENT, cls_token_num=1, window=4, greedy=True, image_top_k=64)
    jeng = jl.llamagen_engine(model_cfg=jcfg, **kw)
    eng = pl.llamagen_engine(model_cfg=decoder_config_from_jax(jcfg), device="cpu", **kw)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    cond = jl.init_cond_params(jax.random.PRNGKey(1), jcfg, num_classes=10, model_type="c2i")
    params = params_from_jax(_np_tree(jparams), eng.model_cfg, device="cpu")
    pc = cond_params_from_jax({k: v if k == "kind" else np.asarray(v)
                               for k, v in cond.items()}, device="cpu")
    labels = np.asarray([7], np.int32)
    key = jax.random.PRNGKey(3)
    want = jeng.generate(jparams, key,
                         prompt_embeds=jl.embed_class(cond, jnp.asarray(labels), jnp.float32),
                         neg_prompt_embeds=jl.embed_uncond_class(cond, 1, jnp.float32))
    W = eng.config.window
    seeds = _replayed_seeds(key, 1, W, 0, pl.VOCAB_SIZE - 1)
    eng._draws = lambda st: StepDraws(next(seeds), None, torch.rand(1, W - 1), None)
    got = eng.generate(params, 0,
                       prompt_embeds=pl.embed_class(pc, torch.from_numpy(labels), torch.float32),
                       neg_prompt_embeds=pl.embed_uncond_class(pc, 1, torch.float32))
    n = int(want.length[0])
    assert n == int(got.length[0]) == 1 + LATENT ** 2
    assert got.tokens[0, :n].tolist() == np.asarray(want.tokens[0, :n]).tolist()
    assert got.nfe == int(want.nfe)
    np.testing.assert_array_equal(got.accept_hist.numpy(), np.asarray(want.accept_hist))


def _epilogue_inputs(seed, S, T, H, Hkv, dtype):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    arrs = dict(qp=f(S, T, H * D), kp=f(S, T, Hkv * D), vp=3.0 * f(S, T, Hkv * D),
                qns=1.0 + 0.1 * f(H, D), qnb=0.1 * f(H, D),
                kns=1.0 + 0.1 * f(Hkv, D), knb=0.1 * f(Hkv, D))
    ang = rng.uniform(0, 3.0, (S, T, D)).astype(np.float32)
    arrs["cos"], arrs["sin"] = np.cos(ang), np.sin(ang)
    jx = {k: jnp.asarray(v, jnp.float32 if k in ("cos", "sin") else dtype)
          for k, v in arrs.items()}
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tx = {k: torch.from_numpy(v).to(torch.float32 if k in ("cos", "sin") else tdt)
          for k, v in arrs.items()}
    return jx, tx


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("qk_norm,quantize", [(False, False), (False, True), (True, True)])
def test_plain_epilogue_at_head_width_100_equals_pallas(dtype, qk_norm, quantize):
    """The plain epilogue (RoPE's partners (j, j + 50), the per-(row,
    head) LayerNorm and int8 code) against the Pallas kernel in interpret
    mode, at GPT-3B's head width with the group of its MHA (H = Hkv)."""
    S, T, H, Hkv = 2, 4, 2, 2
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jx, tx = _epilogue_inputs(5, S, T, H, Hkv, jdt)
    names = ("qns", "qnb", "kns", "knb")
    kw = dict(num_heads=H, num_kv_heads=Hkv, head_dim=D, qk_norm=qk_norm, quantize=quantize)
    got = fused_epilogue(tx["qp"], tx["kp"], tx["vp"], *[tx[n] if qk_norm else None
                                                         for n in names],
                         tx["cos"], tx["sin"], **kw)
    want = jax_fused_epilogue(jx["qp"], jx["kp"], jx["vp"], *[jx[n] if qk_norm else None
                                                              for n in names],
                              jx["cos"], jx["sin"], interpret=True, **kw)
    for g, w in zip(got, want):
        if g is None:  # no scales without quantize (the JAX kernel returns placeholders)
            assert not quantize
            continue
        gn = g.float().numpy()
        wn = np.asarray(w.astype(jnp.float32))
        if g.dtype in (torch.int8, torch.bfloat16) and not (g.dtype == torch.bfloat16
                                                             and gn.ndim == 3):
            np.testing.assert_array_equal(gn, wn)
        elif g.dtype == torch.bfloat16:  # the scales: one bf16 rounding
            np.testing.assert_allclose(gn, wn, rtol=1e-2, atol=0)
        else:
            np.testing.assert_allclose(gn, wn, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["f32", "int8", "int8_stacked_multichunk"])
def test_plain_attention_at_head_width_100_equals_pallas(case):
    """The plain decode attention against the Pallas kernel in interpret
    mode at D = 100: an f32 cache, an int8 one with bf16 queries, and a
    stacked 3-layer int8 cache read in chunks of 16 rows, a masked prefix
    in each."""
    S, W, H, Hkv, L = 2, 4, 4, 4, 64
    rng = np.random.default_rng(9)
    stacked = case == "int8_stacked_multichunk"
    shape = (S, 3, L, Hkv, D) if stacked else (S, L, Hkv, D)
    q = rng.standard_normal((S, W, H, D)).astype(np.float32)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    cache_end = np.asarray([9, 37], np.int32)
    valid = np.ones((S, L), bool)
    valid[1, :5] = False
    quantize = case != "f32"
    jq = jnp.asarray(q, jnp.bfloat16 if quantize else jnp.float32)
    jk, jv, jks, jvs = jnp.asarray(k), jnp.asarray(v), None, None
    if quantize:
        jk, jks = jax_quantize_rows(jk)
        jv, jvs = jax_quantize_rows(jv)
    layer = 1 if stacked else None
    want = jax_decode_attention(jq, jk, jv, jks, jvs, jnp.asarray(cache_end),
                                jnp.asarray(valid), window=W, layer=layer,
                                chunk=16 if stacked else 512, interpret=True)

    def t(x):
        if x is None:
            return None
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
        return torch.from_numpy(np.array(x))

    got = decode_attention(t(jq), t(jk), t(jv), t(jks), t(jvs), torch.from_numpy(cache_end),
                           torch.from_numpy(valid), window=W, layer=layer)
    tol = dict(rtol=1e-2, atol=1e-2) if quantize else dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **tol)
