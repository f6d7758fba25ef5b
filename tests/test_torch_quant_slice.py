"""Quantized weights at the level of the model: the port's quant_eval
(sjd_tpu_torch/models/quant_eval.py) against sjd_tpu's, including the
outlier claims of tests/test_quant_fidelity.py; the Lumina slice on W4A16
and W4A8 weights against sjd_tpu (greedy tokens, NFE and accept_hist, with
the JAX engine's draft seeds replayed, as tests/test_torch_lumina_slice.py);
and load_lumina_mgpt(quantize=...)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sjd_tpu.models import DecoderConfig, init_params as jax_init_params
from sjd_tpu.models import quant_eval as jq_eval
from sjd_tpu.models import transformer as jt
from sjd_tpu.models.chameleon import lumina_engine as jax_lumina_engine
from sjd_tpu_torch.convert import decoder_config_from_jax, params_from_jax, vq_config_from_jax
from sjd_tpu_torch.core.engine import StepDraws
from sjd_tpu_torch.loader import load_lumina_mgpt
from sjd_tpu_torch.models import quant_eval
from sjd_tpu_torch.models import transformer as pt
from sjd_tpu_torch.models.chameleon import lumina_engine
from test_torch_lumina_slice import (
    PROMPT, TARGET, TINY_CHAMELEON, TINY_CHAMELEON_VQ, _replayed_seeds)

# tests/test_quant_fidelity.py's configuration
CFG = DecoderConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=3,
                    num_heads=4, num_kv_heads=2, head_dim=16, qk_norm=True,
                    dtype=jnp.float32, max_position_embeddings=64)


def outlier_params(seed=0, scale=25.0, n_outlier=4):
    """tests/test_quant_fidelity.py's outlier_params: dominant input columns."""
    params = jax_init_params(jax.random.PRNGKey(seed), CFG)
    rs = np.random.RandomState(seed + 1)
    lay = dict(params["layers"])
    for k in ("wq", "wk", "wv", "w_gate", "w_up", "w_down", "wo"):
        w = np.array(lay[k], np.float32)
        cols = rs.choice(w.shape[-1], n_outlier, replace=False)
        w[..., cols] *= scale
        lay[k] = jnp.asarray(w, lay[k].dtype)
    return dict(params, layers=lay)


@pytest.fixture(scope="module")
def ids():
    return np.array(jax.random.randint(jax.random.PRNGKey(9), (2, 24), 0, 128))


@pytest.fixture(scope="module")
def variants(ids):
    """Both packages' compare_quant_variants on the same outlier weights."""
    jp = outlier_params()
    want = jq_eval.compare_quant_variants(jp, CFG, jnp.asarray(ids))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), decoder_config_from_jax(CFG),
                         device="cpu")
    got = quant_eval.compare_quant_variants(tp, decoder_config_from_jax(CFG),
                                            torch.from_numpy(ids).long())
    return want, got


def test_layer_outputs_equals_jax(ids):
    jp = jax_init_params(jax.random.PRNGKey(0), CFG)
    jh, jlogits = jq_eval.layer_outputs(jp, CFG, jnp.asarray(ids))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), decoder_config_from_jax(CFG),
                         device="cpu")
    h, logits = quant_eval.layer_outputs(tp, decoder_config_from_jax(CFG),
                                         torch.from_numpy(ids).long())
    assert tuple(h.shape) == (3, 2, 24, 64)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", ["int8", "int4_equil", "int4_raw", "int4_a8"])
def test_compare_quant_variants_equals_jax(variants, variant):
    """Each default variant's metrics within 2% of sjd_tpu's (the weights
    are the same bytes; the f32 forwards sum in another order) and the same
    top-1 agreement."""
    want, got = (v[variant] for v in variants)
    assert got["top1_agree"] == pytest.approx(want["top1_agree"], abs=1 / 48 + 1e-9)
    assert got["kl"] == pytest.approx(want["kl"], rel=2e-2, abs=1e-7)
    np.testing.assert_allclose(got["rel_mse_per_layer"], want["rel_mse_per_layer"],
                               rtol=2e-2, atol=1e-9)


def test_port_equilibration_strictly_improves_int4(variants):
    """tests/test_quant_fidelity.py:78-104 on the port's own metrics."""
    _, res = variants
    assert res["int4_equil"]["kl"] < res["int4_raw"]["kl"], res
    assert res["int4_equil"]["rel_mse_last"] < res["int4_raw"]["rel_mse_last"]
    assert res["int8"]["kl"] <= res["int4_equil"]["kl"]
    raw = res["int4_raw"]["rel_mse_per_layer"]
    assert raw[-1] >= raw[0]
    assert res["int4_equil"]["top1_agree"] >= res["int4_raw"]["top1_agree"]
    assert res["int8"]["top1_agree"] >= 0.85
    assert res["int4_a8"]["kl"] < res["int4_raw"]["kl"], res
    assert res["int4_a8"]["top1_agree"] >= res["int4_raw"]["top1_agree"] - 0.05
    assert res["int4_a8"]["kl"] <= 5.0 * max(res["int4_equil"]["kl"], 1e-6), res


@pytest.mark.parametrize("quantize", [4, "w4a8"], ids=["w4a16", "w4a8"])
def test_greedy_quantized_slice_equals_jax(quantize):
    """The Lumina slice on the JAX loader's quantized weights (packed int4,
    int8 head, no equilibration on random weights, quantized under jit) in
    both packages: greedy tokens, NFE and accept_hist equal."""
    act = "int8" if quantize == "w4a8" else "bf16"
    jp = jax.jit(lambda k: jt.quantize_weights(
        jax_init_params(k, TINY_CHAMELEON), bits=4, head_bits=8, config=TINY_CHAMELEON,
        equilibrate=False))(jax.random.PRNGKey(0))
    kw = dict(target_size=TARGET, greedy=True)
    jeng = jax_lumina_engine(model_cfg=TINY_CHAMELEON, act_quant=act, **kw)
    eng = lumina_engine(model_cfg=decoder_config_from_jax(TINY_CHAMELEON), act_quant=act,
                        device="cpu", **kw)
    assert eng.model_cfg.act_quant == act
    params = params_from_jax(jax.tree.map(np.asarray, jp), eng.model_cfg, device="cpu")
    assert set(params["layers"]["wq"]) == {"q4p", "s"} and set(params["lm_head"]) == {"q", "s"}
    key = jax.random.PRNGKey(3)
    want = jeng.generate(jp, key, jnp.asarray([PROMPT], jnp.int32))

    W = eng.config.window
    seeds = _replayed_seeds(key, 1, W, eng.spec.image_vocab_start, eng.spec.image_vocab_end)
    eng._draws = lambda st: StepDraws(next(seeds), None, torch.rand(1, W - 1), None)
    got = eng.generate(params, 0, torch.tensor([PROMPT]))
    n = int(want.length[0])
    assert int(got.length[0]) == n
    np.testing.assert_array_equal(got.tokens[0, :n].numpy(), np.asarray(want.tokens[0, :n]))
    assert got.nfe == int(want.nfe)
    np.testing.assert_array_equal(got.accept_hist.numpy(), np.asarray(want.accept_hist))


@pytest.mark.parametrize("quantize,embed_bits", [(4, None), ("w4a8", 8), (True, None)],
                         ids=["w4a16", "w4a8_embed8", "w8a16"])
def test_loader_quantizes_the_bf16_draws(quantize, embed_bits):
    """load_lumina_mgpt(quantize=...) holds quantize_weights of the bf16
    load's weights (the same draws, no equilibration, an int8 head), sets
    act_quant, and its sample_fn still gives an image."""
    cfg = decoder_config_from_jax(dataclasses.replace(TINY_CHAMELEON, dtype=jnp.bfloat16))
    kw = dict(target_size=TARGET, model_cfg=cfg, vq_cfg=vq_config_from_jax(TINY_CHAMELEON_VQ),
              device="cpu")
    bf16 = load_lumina_mgpt(**kw).params
    model = load_lumina_mgpt(quantize=quantize, embed_bits=embed_bits, **kw)
    bits = 8 if quantize is True else 4
    want = pt.quantize_weights(bf16, bits=bits, head_bits=8, equilibrate=False,
                               embed_bits=embed_bits)

    def check(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                check(a[k], b[k])
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)

    check(want, model.params)
    assert model.engine.model_cfg.act_quant == ("int8" if quantize == "w4a8" else "bf16")
    assert pt.weight_bytes(model.params) < pt.weight_bytes(bf16)
    img = model.sample_fn("a photo of a cat", 0)
    assert img.shape == (TARGET, TARGET, 3) and img.dtype == np.uint8


def test_loader_refuses_unknown_modes():
    cfg = decoder_config_from_jax(TINY_CHAMELEON)
    with pytest.raises(ValueError, match="quantize"):
        load_lumina_mgpt(target_size=TARGET, model_cfg=cfg, device="cpu", quantize="int3")
    with pytest.raises(ValueError, match="embed_bits"):
        load_lumina_mgpt(target_size=TARGET, model_cfg=cfg, device="cpu", embed_bits=8)
