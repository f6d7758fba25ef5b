"""The port's T5 caption encoder (sjd_tpu_torch/models/t5.py) against
sjd_tpu/models/t5.py on the same inputs:

  * clean_caption string-equal on every case of tests/test_t5_clean_caption.py,
    in both import branches of each module (bs4 where it imports, the
    stdlib HTML parser where it does not; ftfy is absent here, so both
    sides take the ftfy stand-in, which is compared on its own);
  * relative_position_bucket exactly;
  * t5_encode on a tiny encoder (3 layers, d 32, 4 heads of 8) with a full
    and a padded mask, f32, rtol 1e-5;
  * port_t5_encoder on a synthetic HF state dict, from arrays and tensors;
  * flip_padding_to_left exactly;
  * T5Embedder from a checkpoint directory (config.json and a safetensors
    shard) against the JAX encoder run by hand on the same token ids.
"""

import ast
import importlib.util
import json
import os
import sys
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sjd_tpu.models import t5 as jt5
from sjd_tpu_torch.convert import t5_config_from_jax, t5_params_from_jax
from sjd_tpu_torch.models import t5 as pt5


def _cases():
    """CASES of tests/test_t5_clean_caption.py, read without importing that
    module (it installs an ftfy stub and imports the reference package)."""
    path = os.path.join(os.path.dirname(__file__), "test_t5_clean_caption.py")
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "CASES":
            return ast.literal_eval(node.value)
    raise AssertionError("no CASES in test_t5_clean_caption.py")


CASES = _cases()


def _without_bs4(module):
    """A fresh copy of ``module`` imported while bs4 cannot be: its other
    import branch, leaving the imported module as it is."""
    saved = sys.modules.get("bs4", False)
    sys.modules["bs4"] = None
    try:
        spec = importlib.util.spec_from_file_location(module.__name__ + "_no_bs4",
                                                      module.__file__)
        copy = importlib.util.module_from_spec(spec)
        copy.__package__ = module.__package__
        sys.modules[spec.name] = copy  # its dataclasses look their module up
        spec.loader.exec_module(copy)
    finally:
        if saved is False:
            del sys.modules["bs4"]
        else:
            sys.modules["bs4"] = saved
    return copy


BRANCHES = {"bs4": (jt5, pt5)}
BRANCHES["no_bs4"] = (_without_bs4(jt5), _without_bs4(pt5))


def test_the_two_branches_differ_in_their_html_stripping():
    assert pt5._strip_html is not pt5._strip_html_fallback
    assert BRANCHES["no_bs4"][1]._strip_html is BRANCHES["no_bs4"][1]._strip_html_fallback
    assert BRANCHES["no_bs4"][0]._strip_html is BRANCHES["no_bs4"][0]._strip_html_fallback


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("text", CASES)
def test_clean_caption_equals_jax(text, branch):
    jmod, pmod = BRANCHES[branch]
    once = pmod.clean_caption(text)
    assert once == jmod.clean_caption(text)
    assert pmod.clean_caption(once) == jmod.clean_caption(jmod.clean_caption(text))


def test_fix_text_fallback_equals_jax():
    for text in CASES + ["ﬁne ＡＢＣ “quoted” ‘x’ \x1b[31mred\x1b[0m &amp; a\r\nb c\x07"]:
        assert pt5.fix_text_fallback(text) == jt5.fix_text_fallback(text)


@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (16, 64), (8, 20)])
def test_relative_position_bucket_equals_jax(buckets, max_distance):
    rel = np.arange(-300, 301, dtype=np.int32)[None, :] - np.arange(0, 3, dtype=np.int32)[:, None]
    want = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel), buckets, max_distance))
    got = pt5.relative_position_bucket(torch.from_numpy(rel), buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), want)


TINY_T5 = jt5.T5EncoderConfig(vocab_size=96, d_model=32, d_kv=8, num_heads=4, d_ff=48,
                              num_layers=3, dtype=jnp.float32)


@pytest.fixture(scope="module")
def t5_pair():
    jparams = jt5.init_t5_params(jax.random.PRNGKey(0), TINY_T5)
    cfg = t5_config_from_jax(TINY_T5)
    params = t5_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jparams, cfg, params


@pytest.mark.parametrize("padded", [False, True], ids=["full_mask", "padded"])
def test_t5_encode_equals_jax(t5_pair, padded):
    jparams, cfg, params = t5_pair
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 96, size=(2, 17)).astype(np.int32)
    mask = np.ones((2, 17), np.int32)
    if padded:
        mask[0, 11:] = 0
        mask[1, 5:] = 0
        ids[mask == 0] = 0
    want = np.asarray(jt5.t5_encode(jparams, TINY_T5, jnp.asarray(ids), jnp.asarray(mask)))
    got = pt5.t5_encode(params, cfg, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (2, 17, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_t5_position_bias_equals_jax(t5_pair):
    jparams, cfg, params = t5_pair
    want = np.asarray(jt5.t5_position_bias(jparams["rel_bias"], 40, TINY_T5))
    got = pt5.t5_position_bias(params["rel_bias"], 40, cfg)
    np.testing.assert_array_equal(got.numpy(), want)


def synth_t5_state_dict(cfg, seed=0):
    """An HF T5EncoderModel state dict (numpy, f32) with ``cfg``'s widths."""
    rs = np.random.RandomState(seed)
    d, hd, ff = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff

    def r(*shape):
        return (rs.randn(*shape) / np.sqrt(shape[-1])).astype(np.float32)

    sd = {"shared.weight": rs.randn(cfg.vocab_size, d).astype(np.float32),
          "encoder.final_layer_norm.weight": (1 + 0.1 * rs.randn(d)).astype(np.float32),
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
              r(cfg.rel_buckets, cfg.num_heads)}
    for i in range(cfg.num_layers):
        b = f"encoder.block.{i}.layer"
        sd[f"{b}.0.layer_norm.weight"] = (1 + 0.1 * rs.randn(d)).astype(np.float32)
        for w in "qkv":
            sd[f"{b}.0.SelfAttention.{w}.weight"] = r(hd, d)
        sd[f"{b}.0.SelfAttention.o.weight"] = r(d, hd)
        sd[f"{b}.1.layer_norm.weight"] = (1 + 0.1 * rs.randn(d)).astype(np.float32)
        sd[f"{b}.1.DenseReluDense.wi_0.weight"] = r(ff, d)
        sd[f"{b}.1.DenseReluDense.wi_1.weight"] = r(ff, d)
        sd[f"{b}.1.DenseReluDense.wo.weight"] = r(d, ff)
    return sd


def test_port_t5_encoder_equals_jax():
    sd = synth_t5_state_dict(TINY_T5, seed=1)
    cfg = t5_config_from_jax(TINY_T5)
    want = jt5.port_t5_encoder(sd, TINY_T5)
    got = pt5.port_t5_encoder(sd, cfg, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # and from torch tensors, as the checkpoint reader gives them
    got_t = pt5.port_t5_encoder({k: torch.from_numpy(v) for k, v in sd.items()}, cfg,
                                device="cpu")
    for k in want:
        assert torch.equal(got_t[k], got[k]), k


def test_flip_padding_to_left_equals_jax():
    rng = np.random.default_rng(2)
    embs = rng.standard_normal((3, 7, 4)).astype(np.float32)
    mask = np.zeros((3, 7), np.int64)
    for b, n in enumerate((7, 3, 0)):
        mask[b, :n] = 1
    want = jt5.flip_padding_to_left(embs, mask)
    got = pt5.flip_padding_to_left(embs, mask)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][1, 4:], embs[1, :3])
    assert not got[0][1, :4].any() and not got[0][2].any() and got[1][1, 4:].all()


class StubT5Tokenizer:
    """A stand-in for HF's T5 tokenizer: one id per word (a hash, in [2,
    vocab)), then </s> (1), right-padded with 0 to ``max_length``, as HF's
    ``padding="max_length"`` returns."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, texts, max_length, padding, truncation, return_tensors):
        assert padding == "max_length" and truncation and return_tensors == "np"
        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for b, text in enumerate(texts):
            toks = [2 + zlib.crc32(w.encode()) % (self.vocab_size - 2) for w in text.split()]
            toks = toks[:max_length - 1] + [1]
            ids[b, :len(toks)] = toks
            mask[b, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def write_t5_dir(path, cfg, seed=3):
    """config.json (HF T5 keys) and one safetensors shard of a synthetic
    encoder; returns the state dict written."""
    from safetensors.numpy import save_file

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"vocab_size": cfg.vocab_size, "d_model": cfg.d_model, "d_kv": cfg.d_kv,
                   "num_heads": cfg.num_heads, "d_ff": cfg.d_ff,
                   "num_layers": cfg.num_layers, "relative_attention_num_buckets": 32,
                   "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-6}, f)
    sd = synth_t5_state_dict(cfg, seed)
    save_file(sd, os.path.join(path, "model.safetensors"))
    return sd


def test_t5_embedder_from_a_directory_equals_jax(tmp_path):
    """Captions through the port's T5Embedder (cleaned twice, tokenized,
    encoded, masked, flipped to the end) against the JAX encoder on the same
    ids: f32 features within rtol 1e-5, the same masks."""
    sd = write_t5_dir(str(tmp_path / "t5"), TINY_T5)
    tok = StubT5Tokenizer(TINY_T5.vocab_size)
    emb = pt5.T5Embedder(str(tmp_path / "t5"), tok, max_length=12, device="cpu")
    assert emb.config == t5_config_from_jax(TINY_T5)
    texts = ["A photo of a <b>red</b> fox", "one two three four five six seven eight nine "
             "ten eleven twelve thirteen"]
    feats, mask = emb.get_text_embeddings(texts)
    ids, mask0 = emb.tokenize(texts)
    cleaned = [jt5.clean_caption(jt5.clean_caption(t)) for t in texts]
    want_ids = tok(cleaned, max_length=12, padding="max_length", truncation=True,
                   return_tensors="np")
    np.testing.assert_array_equal(ids, want_ids["input_ids"])
    jparams = jt5.port_t5_encoder(sd, TINY_T5)
    out = np.asarray(jt5.t5_encode(jparams, TINY_T5, jnp.asarray(ids, jnp.int32),
                                   jnp.asarray(mask0)))
    want_feats, want_mask = jt5.flip_padding_to_left(out * mask0[:, :, None], mask0)
    np.testing.assert_array_equal(mask, want_mask)
    np.testing.assert_allclose(feats, want_feats, rtol=1e-5, atol=1e-5)
    # six words and </s>, moved to the end; the second caption fills the row
    assert mask[0].sum() == 7 and mask[0, -7:].all() and mask[1].all()


def test_t5_embedder_without_a_directory_is_random_at_the_given_widths():
    tok = StubT5Tokenizer(TINY_T5.vocab_size)
    cfg = t5_config_from_jax(TINY_T5)
    a = pt5.T5Embedder(None, tok, max_length=8, config=cfg, device="cpu")
    b = pt5.T5Embedder(None, tok, max_length=8, config=cfg, device="cpu")
    feats, mask = a.get_text_embeddings(["a small cat"])
    assert feats.shape == (1, 8, 32) and mask.tolist() == [[0, 0, 0, 0, 1, 1, 1, 1]]
    assert np.isfinite(feats).all() and (feats[0, :4] == 0).all()
    np.testing.assert_array_equal(feats, b.get_text_embeddings(["a small cat"])[0])
    assert pt5.T5EncoderConfig() == pt5.T5EncoderConfig(
        vocab_size=32128, d_model=2048, d_kv=64, num_heads=32, d_ff=5120, num_layers=24)
