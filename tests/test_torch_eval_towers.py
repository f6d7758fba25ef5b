"""The port's evaluation towers (sjd_tpu_torch/eval/inception.py, clip.py)
against sjd_tpu's on the same numpy inputs:

  * InceptionV3 pool3 features from one seeded torchvision-named state dict
    (tests/test_inception_port.py's trunk), with pytorch_fid's pools on and
    off, within rtol 2e-3 / atol 2e-4 (test_inception_port.py's tolerance:
    f32 convolutions summed in another order), through the port's own
    BN fold and through ``convert.inception_params_from_jax``; the stage
    shapes against torchvision's published trace; the checkpoint-file
    extractor (``torch.save``, bilinear resize to 299) against the JAX one;
    the seeded random state dict of ``synth_inception_state_dict`` against
    torchvision's names and shapes;
  * the CLIP towers at tests/test_clip_port.py's tiny sizes, f32 within
    1e-5, through ``port_clip`` and ``convert.clip_params_from_jax``, and
    ``NativeCLIP`` from a checkpoint directory with a duck-typed tokenizer;
  * CLIP's preprocessing within the uint8 bicubic bound (at most 2 LSB,
    on at most 0.5% of the values)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sjd_tpu.eval import clip as jclip
from sjd_tpu.eval.inception import make_inception_extractor_from_ckpt as jax_extractor
from sjd_tpu.eval.inception import pool3_features as jax_pool3
from sjd_tpu.eval.inception import port_inception_v3 as jax_port_inception
from sjd_tpu_torch.convert import (
    clip_config_from_jax, clip_params_from_jax, inception_params_from_jax)
from sjd_tpu_torch.eval import clip as pclip
from sjd_tpu_torch.eval.inception import (
    make_inception_extractor_from_ckpt, pool3_features, port_inception_v3,
    synth_inception_state_dict, trunk)
from test_inception_port import TORCHVISION_SHAPE_TRACE, Inception3Trunk, _randomize

RTOL, ATOL = 2e-3, 2e-4


@pytest.fixture(scope="module")
def inception_sd():
    return _randomize(Inception3Trunk(), seed=5).eval().state_dict()


@pytest.mark.parametrize("fid_pools", [False, True], ids=["torchvision", "fid_pools"])
@pytest.mark.parametrize("n,side", [(1, 299), (2, 128)])
def test_pool3_features_equal_jax(inception_sd, fid_pools, n, side):
    imgs = np.random.RandomState(side).rand(n, side, side, 3).astype(np.float32)
    jparams = jax_port_inception(inception_sd)
    want = np.asarray(jax_pool3(jparams, jnp.asarray(imgs), fid_pools=fid_pools))
    x = torch.from_numpy(imgs)
    got = pool3_features(port_inception_v3(inception_sd, device="cpu"), x, fid_pools=fid_pools)
    assert got.shape == (n, 2048)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    carried = inception_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    np.testing.assert_allclose(pool3_features(carried, x, fid_pools=fid_pools).numpy(), want,
                               rtol=RTOL, atol=ATOL)


def test_synth_state_dict_has_torchvision_names_and_shapes(inception_sd):
    """The seeded state dict that the card's smoke run writes: torchvision's
    trunk names and shapes (and its fc and AuxLogits heads), finite pool3
    features of a usable spread."""
    sd = synth_inception_state_dict(0)
    want = {k: tuple(v.shape) for k, v in inception_sd.items()}
    assert {k: tuple(sd[k].shape) for k in want} == want
    assert {k for k in sd if k not in want} == {
        "fc.weight", "fc.bias", "AuxLogits.fc.weight", "AuxLogits.fc.bias"} | {
        f"AuxLogits.conv{i}.{p}" for i in (0, 1) for p in (
            "conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var",
            "bn.num_batches_tracked")}
    imgs = torch.from_numpy(np.random.RandomState(0).rand(2, 299, 299, 3).astype(np.float32))
    feats = pool3_features(port_inception_v3(sd, device="cpu"), imgs)
    assert torch.isfinite(feats).all() and 1e-3 < feats.std().item() < 1e3


def test_trunk_shape_trace_matches_torchvision(inception_sd):
    params = port_inception_v3(inception_sd, device="cpu")
    seen = {name: tuple(x.shape[1:]) for name, x in trunk(params, torch.zeros(1, 299, 299, 3))}
    assert seen == TORCHVISION_SHAPE_TRACE


def test_extractor_from_ckpt_file_equals_jax(inception_sd, tmp_path):
    path = str(tmp_path / "inception.pt")
    torch.save(inception_sd, path)
    imgs = np.random.RandomState(2).rand(3, 64, 64, 3).astype(np.float32)
    want = jax_extractor(path, batch=2)(imgs)
    got = make_inception_extractor_from_ckpt(path, batch=2, device="cpu")(imgs)
    assert got.shape == (3, 2048) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# CLIP
# --------------------------------------------------------------------------

HF_CONFIG = {
    "vision_config": {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4,
                      "intermediate_size": 64, "image_size": 32, "patch_size": 8},
    "text_config": {"hidden_size": 24, "num_hidden_layers": 2, "num_attention_heads": 4,
                    "intermediate_size": 48, "vocab_size": 64,
                    "max_position_embeddings": 16},
    "projection_dim": 20,
}


def text_ids(B=4, T=12, seed=1):
    """Token rows with one eot (= the largest id, 63) each, zeros after it."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(3, 62, size=(B, T))
    for b, end in enumerate(rs.randint(2, T, size=B)):
        ids[b, end] = 63
        ids[b, end + 1:] = 0
    return ids.astype(np.int32)


@pytest.fixture(scope="module")
def clip_pair():
    sd = pclip.synth_clip_state_dict(pclip.CLIPConfig.from_hf_config(HF_CONFIG), 0)
    jcfg = jclip.CLIPConfig.from_hf_config(HF_CONFIG)
    jparams = jclip.port_clip(sd, jcfg)
    cfg = pclip.CLIPConfig.from_hf_config(HF_CONFIG)
    return sd, jcfg, jparams, cfg


@pytest.mark.parametrize("route", ["port_clip", "clip_params_from_jax"])
def test_clip_towers_equal_jax(clip_pair, route):
    sd, jcfg, jparams, cfg = clip_pair
    assert pclip.hf_config(cfg) == HF_CONFIG
    if route == "port_clip":
        params = pclip.port_clip(sd, cfg, device="cpu")
    else:
        assert clip_config_from_jax(jcfg) == cfg
        params = clip_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    px = np.random.RandomState(0).randn(3, 32, 32, 3).astype(np.float32)
    want = np.asarray(jclip.clip_image_features(jparams, jcfg, jnp.asarray(px)))
    got = pclip.clip_image_features(params, cfg, torch.from_numpy(px))
    assert got.shape == (3, 20)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    ids = text_ids()
    want = np.asarray(jclip.clip_text_features(jparams, jcfg, jnp.asarray(ids)))
    got = pclip.clip_text_features(params, cfg, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


class DuckCLIPTokenizer:
    """HF's call signature: words -> ids 3.., then the eot (63), zeros after."""

    def __call__(self, texts, padding, max_length, truncation, return_tensors):
        assert (padding, return_tensors, truncation) == ("max_length", "np", True)
        rows = []
        for t in texts:
            ids = [3 + sum(map(ord, w)) % 59 for w in t.split()][: max_length - 1] + [63]
            rows.append(ids + [0] * (max_length - len(ids)))
        return {"input_ids": np.asarray(rows, np.int64)}


def test_native_clip_from_checkpoint_dir(clip_pair, tmp_path):
    sd, jcfg, jparams, _ = clip_pair
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(json.dumps(HF_CONFIG))
    clip = pclip.NativeCLIP(str(tmp_path), tokenizer=DuckCLIPTokenizer(), device="cpu")
    # 32 px images need no resize, so both preprocessings are exact
    imgs = np.random.RandomState(3).rand(5, 32, 32, 3).astype(np.float32)
    got = clip.image_embeds(imgs, batch=2)
    px = jclip.preprocess_images(imgs, 32)
    want = np.asarray(jclip.clip_image_features(jparams, jcfg, jnp.asarray(px)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    texts = ["a red fox", "three green apples on a table", "dusk"]
    ids = DuckCLIPTokenizer()(texts, "max_length", 16, True, "np")["input_ids"]
    want = np.asarray(jclip.clip_text_features(jparams, jcfg, jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(clip.text_embeds(texts, batch=2), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(256, 256), (512, 512), (256, 320), (300, 240)])
def test_preprocess_images_within_the_bicubic_bound(shape):
    rs = np.random.RandomState(sum(shape))
    smooth = np.add.outer(np.arange(shape[0]), np.arange(shape[1]))[..., None] * [1, 2, 3]
    imgs = np.stack([rs.rand(*shape, 3), (smooth % 256) / 255.0]).astype(np.float32)
    want = jclip.preprocess_images(imgs)
    got = pclip.preprocess_images(imgs)
    assert got.shape == want.shape == (2, 224, 224, 3)
    lsb = np.abs(np.rint((got - want) * pclip.CLIP_STD * 255))
    assert lsb.max() <= 2 and (lsb > 0).mean() <= 0.005, (lsb.max(), (lsb > 0).mean())
