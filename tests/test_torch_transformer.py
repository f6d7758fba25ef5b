"""Port of the decoder forward (sjd_tpu_torch/models/transformer.py)
against sjd_tpu.models.transformer.forward: a prefill and then a window,
with an unquantized and an int8 cache, at tests/helpers.py:TINY (D=8, GQA)
and at a 2-layer D=128 config, same params through params_from_jax.

Both run f32 on the CPU (the port's plain chain, JAX's XLA chain); they sum
in another order, so f32 logits and caches are held to 1e-4, int8 codes to
one step where a value sits on a rounding edge, and bf16 scales to one bf16
rounding."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import TINY
from sjd_tpu.models import transformer as jt
from sjd_tpu_torch.convert import decoder_config_from_jax, params_from_jax
from sjd_tpu_torch.models import transformer as pt

WIDE = dataclasses.replace(TINY, hidden_size=256, intermediate_size=256,
                           num_heads=2, num_kv_heads=2, head_dim=128)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _kv_np(kv):
    return [None if t is None else np.asarray(t.float() if isinstance(t, torch.Tensor)
                                              else t.astype(jnp.float32))
            for t in (kv.k, kv.v, kv.k_scale, kv.v_scale)]


@pytest.mark.parametrize("base", [TINY, WIDE], ids=["tiny", "d128"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp_cache", "int8_cache"])
def test_forward_matches_jax_prefill_then_window(base, kv_quant):
    jcfg = dataclasses.replace(base, kv_quant=kv_quant)
    cfg = decoder_config_from_jax(jcfg)
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(_np_tree(jparams), cfg, device="cpu")
    S, P, W, L = 2, 7, 4, 32
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, jcfg.vocab_size, (S, P)).astype(np.int32)
    window = rng.integers(0, jcfg.vocab_size, (S, W)).astype(np.int32)
    valid = np.ones((S, L), bool)
    valid[1, :P - 1] = False  # the CFG uncond half: prompt masked to its last token
    pos_p = np.maximum(np.cumsum(valid[:, :P], 1) - 1, 0).astype(np.int32)
    pos_w = (pos_p[:, -1:] + 1 + np.arange(W)).astype(np.int32)
    jrope = jt.make_rope_table(jcfg, 64)
    rope = pt.make_rope_table(cfg, 64, device="cpu")

    jkv = jt.init_kv_cache(jcfg, S, L)
    kv = pt.init_kv_cache(cfg, S, L, device="cpu")
    for ids, pos, end in ((prompt, pos_p, 0), (window, pos_w, P)):
        ce = np.full((S,), end, np.int32)
        jout = jt.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos), jkv,
                          jnp.asarray(ce), jnp.asarray(valid), jrope)
        out = pt.forward(params, cfg, torch.from_numpy(ids), torch.from_numpy(pos), kv,
                         torch.from_numpy(ce), torch.from_numpy(valid), rope)
        jkv, kv = jout.kv, out.kv
        np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits),
                                   rtol=1e-4, atol=1e-4)
        got, want = _kv_np(kv), _kv_np(jkv)
        if kv_quant:
            assert np.abs(got[0] - want[0]).max() <= 1
            assert np.abs(got[1] - want[1]).max() <= 1
            assert np.mean(got[0] != want[0]) < 1e-3
            for g, w in zip(got[2:], want[2:]):
                np.testing.assert_allclose(g, w, rtol=1e-2)
        else:
            for g, w in zip(got[:2], want[:2]):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp_cache", "int8_cache"])
def test_forward_from_embeddings_with_2d_rope_matches_jax(kv_quant):
    """A LlamaGen-shaped prefill whose rows enter as embeddings (a 3-row
    condition prefix, the 2-D table's zero-angle rows), then a window of ids
    at grid positions: logits and caches as the JAX forward's."""
    jcfg = dataclasses.replace(TINY, num_kv_heads=4, rope_style="2d", rope_2d_cls_len=3,
                               rope_2d_grid_side=4, kv_quant=kv_quant)
    cfg = decoder_config_from_jax(jcfg)
    jparams = jt.init_params(jax.random.PRNGKey(2), jcfg)
    params = params_from_jax(_np_tree(jparams), cfg, device="cpu")
    S, P, W, L = 2, 3, 4, 32
    rng = np.random.default_rng(1)
    embeds = rng.standard_normal((S, P, jcfg.hidden_size)).astype(np.float32)
    window = rng.integers(0, jcfg.vocab_size, (S, W)).astype(np.int32)
    valid = np.ones((S, L), bool)
    valid[0, :1] = False  # a masked condition row
    pos_p = np.maximum(np.cumsum(valid[:, :P], 1) - 1, 0).astype(np.int32)
    pos_w = (pos_p[:, -1:] + 1 + np.arange(W)).astype(np.int32)
    jrope, rope = jt.make_rope_table(jcfg, 64), pt.make_rope_table(cfg, 64, device="cpu")
    jkv, kv = jt.init_kv_cache(jcfg, S, L), pt.init_kv_cache(cfg, S, L, device="cpu")
    placeholder = np.zeros((S, P), np.int32)
    for ids, pos, end, emb in ((placeholder, pos_p, 0, embeds), (window, pos_w, P, None)):
        ce = np.full((S,), end, np.int32)
        jout = jt.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos), jkv,
                          jnp.asarray(ce), jnp.asarray(valid), jrope,
                          inputs_embeds=None if emb is None else jnp.asarray(emb))
        out = pt.forward(params, cfg, torch.from_numpy(ids), torch.from_numpy(pos), kv,
                         torch.from_numpy(ce), torch.from_numpy(valid), rope,
                         inputs_embeds=None if emb is None else torch.from_numpy(emb))
        jkv, kv = jout.kv, out.kv
        np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits),
                                   rtol=1e-4, atol=1e-4)
        got, want = _kv_np(kv), _kv_np(jkv)
        if kv_quant:
            assert np.abs(got[0] - want[0]).max() <= 1 and np.abs(got[1] - want[1]).max() <= 1
        else:
            for g, w in zip(got[:2], want[:2]):
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_decoder_config_from_jax_refuses_a_field_it_would_drop():
    """Every JAX DecoderConfig field has its counterpart in the port: the
    2-D RoPE fields and attn_buckets are carried over; attn_impl, which
    names TPU paths, is not. A field with no counterpart (a JAX config
    grown by one) passes only at its default."""
    jcfg = dataclasses.replace(TINY, rope_style="2d", rope_2d_cls_len=3, rope_2d_grid_side=5)
    cfg = decoder_config_from_jax(jcfg)
    assert (cfg.rope_style, cfg.rope_2d_cls_len, cfg.rope_2d_grid_side) == ("2d", 3, 5)
    lacking = ({f.name for f in dataclasses.fields(jt.DecoderConfig)}
               - {f.name for f in dataclasses.fields(pt.DecoderConfig)})
    assert lacking == set()
    assert cfg.attn_buckets == 0
    assert decoder_config_from_jax(dataclasses.replace(jcfg, attn_buckets=8)).attn_buckets == 8

    @dataclasses.dataclass(frozen=True)
    class Grown(jt.DecoderConfig):
        new_knob: int = 0

    grown = Grown(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    assert decoder_config_from_jax(grown) == cfg
    with pytest.raises(ValueError, match="new_knob"):
        decoder_config_from_jax(dataclasses.replace(grown, new_knob=1))
    assert decoder_config_from_jax(dataclasses.replace(jcfg, attn_impl="xla")).attn_impl == "auto"
    assert decoder_config_from_jax(jcfg, attn_impl="plain").attn_impl == "plain"


@pytest.mark.parametrize("rank", [5, 4], ids=["kv_rows", "scales"])
def test_write_kv_layer_clamps_as_dynamic_update_slice(rank):
    """write_kv_layer against the JAX package's on a stacked [S, NL, L, H(, D)]
    buffer, with per-sample offsets of which one overruns L - T and one is
    negative: both clamp the start row into [0, L - T]; bit-equal buffers."""
    S, NL, L, H, D, T, layer = 3, 3, 10, 2, 4, 4, 2
    rng = np.random.default_rng(5)
    shape = (S, NL, L, H, D)[:rank]
    buf = rng.standard_normal(shape).astype(np.float32)
    new = rng.standard_normal((S, T) + shape[3:]).astype(np.float32)
    offsets = np.array([2, L - T + 3, -2], np.int32)
    want = jt.write_kv_layer(jnp.asarray(buf), jnp.asarray(new), jnp.int32(layer),
                             jnp.asarray(offsets))
    got = pt.write_kv_layer(torch.from_numpy(buf.copy()), torch.from_numpy(new), layer,
                            torch.from_numpy(offsets))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
