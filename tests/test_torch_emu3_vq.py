"""Emu3VisionVQ in the port (sjd_tpu_torch/models/vq/emu3_vq.py, emu3_port.py,
convert.emu3_vq_params_from_jax) against sjd_tpu's on the same inputs:

  * the synthetic state dict and its port bit-equal to the JAX package's
    (through the converter: HWIO -> OIHW, DHWIO -> OIDHW), at a tiny config
    and at Emu3's own structure (ch_mult (1, 2, 2, 4), 2 res blocks,
    attention at level 3, temporal factor 4) at a narrow width;
  * the primitives (causal 3-D convolution with its paddings and strides,
    frozen BatchNorm, SpatialNorm, the temporal blocks) within atol 1e-5;
  * decode pixels within atol 2e-4 of JAX in f32, and encode codes equal
    (the codes' nearest-entry margins are checked to be clear of ties).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sjd_tpu.models.vq import emu3_port as jport
from sjd_tpu.models.vq import emu3_vq as jvq
from sjd_tpu_torch.convert import emu3_vq_config_from_jax, emu3_vq_params_from_jax
from sjd_tpu_torch.models.vq import emu3_port as pport
from sjd_tpu_torch.models.vq import emu3_vq as pvq
from test_torch_checkpoint import assert_trees_equal, np_tree

TINY = jvq.Emu3VQConfig(ch=32, ch_mult=(1, 1), num_res_blocks=1, z_channels=4, embed_dim=4,
                        attn_levels=(1,))
NARROW = dataclasses.replace(jvq.EMU3_VQ, ch=32, codebook_size=1024)


@pytest.mark.parametrize("cfg", [TINY, NARROW], ids=["tiny", "emu3_structure"])
def test_port_equals_jax_port(cfg):
    pcfg = emu3_vq_config_from_jax(cfg)
    sd = pport.synth_emu3_vq_state_dict(4, pcfg)
    jsd = jport.synth_emu3_vq_state_dict(4, cfg)
    assert sorted(sd) == sorted(jsd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], jsd[k])
    got = pport.port_emu3_vq(sd, pcfg, device="cpu")
    want = emu3_vq_params_from_jax(np_tree(jport.port_emu3_vq(jsd, cfg)), pcfg, device="cpu")
    assert_trees_equal(got, want)
    assert_trees_equal(pport.init_emu3_vq_params(4, pcfg, device="cpu"), got)
    if cfg is NARROW:  # the real structure: shortcuts, attention, 2 time convs
        assert "nin_w" in got["decoder"]["up"][1]["res"][0]
        assert len(got["decoder"]["up"][0]["attn"]) == 3 and "attn" not in got["decoder"]["up"][1]
        assert len(got["decoder"]["time_conv"]) == len(got["encoder"]["time_conv"]) == 2


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kernel,stride", [((3, 3, 3), (1, 1, 1)), ((4, 3, 3), (2, 1, 1)),
                                           ((3, 1, 1), (1, 1, 1)), ((3, 4, 2), (1, 2, 2))])
def test_causal_conv3d_equals_jax(kernel, stride):
    rng = np.random.default_rng(sum(kernel) + sum(stride))
    x = _rand(rng, 2, 5, 7, 6, 3)  # [B, T, H, W, C]
    w = _rand(rng, *kernel, 3, 4)  # DHWIO
    b = _rand(rng, 4)
    want = np.asarray(jvq.causal_conv3d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                        stride=stride))
    got = pvq.causal_conv3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                            torch.from_numpy(w).permute(4, 3, 0, 1, 2), torch.from_numpy(b),
                            stride=stride).permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_norms_and_temporal_blocks_equal_jax():
    rng = np.random.default_rng(2)
    C = 4
    bn = {k: _rand(rng, C) for k in ("scale", "bias", "mean")}
    bn["var"] = np.abs(_rand(rng, C)) + 0.5
    x = _rand(rng, 2, 3, 5, 6, C)
    want = np.asarray(jvq.batch_norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in bn.items()}))
    got = pvq.batch_norm(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                         {k: torch.from_numpy(v) for k, v in bn.items()})
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want, atol=1e-5, rtol=0)

    # SpatialNorm: x [B, H, W, 32] modulated by a 3 x 2 latent resized to 6 x 5
    sp = {"norm_scale": _rand(rng, 32), "norm_bias": _rand(rng, 32),
          "conv_y_w": _rand(rng, 1, 1, C, 32), "conv_y_b": _rand(rng, 32),
          "conv_b_w": _rand(rng, 1, 1, C, 32), "conv_b_b": _rand(rng, 32)}
    x2, zq = _rand(rng, 2, 6, 5, 32), _rand(rng, 2, 3, 2, C)
    want = np.asarray(jvq.spatial_norm(jnp.asarray(x2), jnp.asarray(zq),
                                       {k: jnp.asarray(v) for k, v in sp.items()}))
    psp = {k: torch.from_numpy(v).permute(3, 2, 0, 1) if v.ndim == 4 else torch.from_numpy(v)
           for k, v in sp.items()}
    got = pvq.spatial_norm(torch.from_numpy(x2).permute(0, 3, 1, 2),
                           torch.from_numpy(zq).permute(0, 3, 1, 2), psp)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5, rtol=0)

    cfg = emu3_vq_config_from_jax(TINY)
    jp = jport.init_emu3_vq_params(4, TINY)["decoder"]
    pp = pport.init_emu3_vq_params(4, cfg, device="cpu")["decoder"]
    z = _rand(rng, 2, 1, 3, 4, C)
    jz, pz = jnp.asarray(z), torch.from_numpy(z).permute(0, 4, 1, 2, 3)
    jz = jvq.temporal_res_block(jp["time_res_stack"][0], jz)
    pz = pvq.temporal_res_block(pp["time_res_stack"][0], pz)
    jz = jvq.temporal_upsample(jp["time_conv"][0], jz)
    pz = pvq.temporal_upsample(pp["time_conv"][0], pz)
    np.testing.assert_allclose(pz.permute(0, 2, 3, 4, 1).numpy(), np.asarray(jz), atol=1e-5,
                               rtol=0)
    je = jport.init_emu3_vq_params(4, TINY)["encoder"]["time_conv"][0]
    pe = pport.init_emu3_vq_params(4, cfg, device="cpu")["encoder"]["time_conv"][0]
    np.testing.assert_allclose(
        pvq.temporal_downsample(pe, pz).permute(0, 2, 3, 4, 1).numpy(),
        np.asarray(jvq.temporal_downsample(je, jz)), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def tiny_params():
    jp = jport.init_emu3_vq_params(4, TINY)
    cfg = emu3_vq_config_from_jax(TINY)
    return jp, cfg, emu3_vq_params_from_jax(np_tree(jp), cfg, device="cpu")


@pytest.mark.parametrize("h,w", [(3, 5), (4, 4)])
def test_decode_equals_jax(tiny_params, h, w):
    jp, cfg, pp = tiny_params
    ids = np.random.default_rng(h * w).integers(0, 32768, (2, h, w)).astype(np.int32)
    want = np.asarray(jvq.decode(jp, TINY, jnp.asarray(ids)))
    got = pvq.decode(pp, cfg, torch.from_numpy(ids)).numpy()
    f = TINY.spatial_factor
    assert got.shape == want.shape == (2, h * f, w * f, 3)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_encode_codes_equal_jax(tiny_params):
    """The same codes, and a margin between each latent's nearest and
    second-nearest codebook entries that no f32 reassociation could cross
    (a tie would show here, not be hidden)."""
    jp, cfg, pp = tiny_params
    px = np.random.default_rng(1).uniform(-1, 1, (2, 8, 12, 3)).astype(np.float32)
    want = np.asarray(jvq.encode(jp, TINY, jnp.asarray(px)))
    got = pvq.encode(pp, cfg, torch.from_numpy(px)).numpy()
    assert got.shape == want.shape == (2, 4, 6)
    np.testing.assert_array_equal(got, want)
    # the decoder's own codes round-trip through the codebook distance
    cb = pp["codebook"]
    rows = torch.randperm(cb.shape[0], generator=torch.Generator().manual_seed(0))[:64]
    z = cb[rows]
    dist = z.pow(2).sum(1, keepdim=True) - 2 * z @ cb.T + cb.pow(2).sum(1)[None]
    two = dist.topk(2, dim=1, largest=False)
    assert torch.equal(two.indices[:, 0], rows)
    assert (two.values[:, 1] - two.values[:, 0]).min() > 1e-6
