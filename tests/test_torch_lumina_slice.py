"""The Lumina text-to-image slice as a whole: the port against sjd_tpu on
the same parameters (through params_from_jax / vq_params_from_jax), at the
tiny Chameleon shapes of tests/test_checkpoint_drill.py:33-42 with the real
vocab layout.

Greedy decoding makes the sampled tokens independent of the random draws,
but NFE and the acceptance histogram still depend on the fresh draft seeds,
so the port's engine is handed the JAX engine's seeds, replayed from its
key schedule (engine.py:641-642, 715-718; drafts.py:76-79). Then tokens,
NFE and accept_hist must be equal. The VQ decode is held to atol 1e-4 in
f32 (convolutions sum in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sjd_tpu.core.sampling import split_rows
from sjd_tpu.models import DecoderConfig, init_params as jax_init_params
from sjd_tpu.models.chameleon import lumina_engine as jax_lumina_engine
from sjd_tpu.models.vq import VQConfig, decode as jax_vq_decode
from sjd_tpu.models.vq import init_vq_params as jax_init_vq_params
from sjd_tpu_torch.convert import (
    decoder_config_from_jax, params_from_jax, vq_config_from_jax, vq_params_from_jax)
from sjd_tpu_torch.core.engine import StepDraws
from sjd_tpu_torch.data.item_processor import image_grid_from_block, split_generation
from sjd_tpu_torch.data.vocab_translation import identity_mapping
from sjd_tpu_torch.loader import load_lumina_mgpt
from sjd_tpu_torch.models.chameleon import IMAGE_START_ID, SIZE_TOKEN_BASE, lumina_engine
from sjd_tpu_torch.models.vq import decode as vq_decode

TINY_CHAMELEON = DecoderConfig(
    vocab_size=65536, hidden_size=16, intermediate_size=32, num_layers=2,
    num_heads=2, num_kv_heads=2, head_dim=8, qk_norm=True, dtype=jnp.float32,
    max_position_embeddings=512,
)
TINY_CHAMELEON_VQ = VQConfig(
    ch=32, ch_mult=(1, 1, 1, 1, 1), num_res_blocks=1, z_channels=32,
    embed_dim=16, n_embed=8192,
)
TARGET = 64
PROMPT = list(range(9000, 9012)) + [IMAGE_START_ID, SIZE_TOKEN_BASE + TARGET // 32,
                                    SIZE_TOKEN_BASE + TARGET // 32]


def _replayed_seeds(key, B, W, lo, hi):
    """The fresh draft seeds the JAX engine draws at each decode step."""
    rng = split_rows(jax.random.split(key, B), 2)[:, 0]  # prefill split
    while True:
        ks = split_rows(rng, 4)
        rng = ks[:, 0]
        yield torch.from_numpy(np.array(jax.vmap(
            lambda k: jax.random.randint(k, (W - 1,), lo, hi + 1, jnp.int32))(ks[:, 1])))


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax.random.PRNGKey(0), TINY_CHAMELEON)


@pytest.mark.parametrize("scheme", ["speculative_jacobi", "jacobi"])
def test_greedy_slice_equals_jax(jax_params, scheme):
    kw = dict(target_size=TARGET, greedy=True, scheme=scheme)
    jeng = jax_lumina_engine(model_cfg=TINY_CHAMELEON, **kw)
    eng = lumina_engine(model_cfg=decoder_config_from_jax(TINY_CHAMELEON),
                        device="cpu", **kw)
    params = params_from_jax(jax.tree.map(np.asarray, jax_params), eng.model_cfg,
                             device="cpu")
    key = jax.random.PRNGKey(3)
    want = jeng.generate(jax_params, key, jnp.asarray([PROMPT], jnp.int32))

    W = eng.config.window
    lo, hi = eng.spec.image_vocab_start, eng.spec.image_vocab_end
    seeds = _replayed_seeds(key, 1, W, lo, hi)
    eng._draws = lambda st: StepDraws(next(seeds), None, torch.rand(1, W - 1), None)
    got = eng.generate(params, 0, torch.tensor([PROMPT]))

    n = int(want.length[0])
    assert int(got.length[0]) == n
    np.testing.assert_array_equal(got.tokens[0, :n].numpy(), np.asarray(want.tokens[0, :n]))
    assert got.nfe == int(want.nfe)
    np.testing.assert_array_equal(got.accept_hist.numpy(), np.asarray(want.accept_hist))
    # the image span is a whole grid: 4 rows of 4 tokens + <eol>
    spans = [s for k, s in split_generation(got.tokens[0, :n].tolist()) if k == "image"]
    assert image_grid_from_block(spans[0][:-1], mapping=identity_mapping()).shape == (4, 4)


def test_vq_decode_equals_jax():
    jvq = jax_init_vq_params(jax.random.PRNGKey(1), TINY_CHAMELEON_VQ)
    cfg = vq_config_from_jax(TINY_CHAMELEON_VQ)
    vq = vq_params_from_jax(jax.tree.map(np.asarray, jvq), cfg, device="cpu")
    ids = np.random.default_rng(0).integers(0, 8192, (1, 16)).astype(np.int32)
    want = jax_vq_decode(jvq, TINY_CHAMELEON_VQ, jnp.asarray(ids), (4, 4))
    got = vq_decode(vq, cfg, torch.from_numpy(ids), (4, 4))
    assert tuple(got.shape) == (1, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_loader_sample_fn_returns_image():
    model = load_lumina_mgpt(
        target_size=TARGET, model_cfg=decoder_config_from_jax(TINY_CHAMELEON),
        vq_cfg=vq_config_from_jax(TINY_CHAMELEON_VQ), device="cpu")
    assert model.smoke and len(model.extras["smoke_reasons"]) == 3
    img = model.sample_fn("a photo of a cat", 0)
    assert img.shape == (TARGET, TARGET, 3) and img.dtype == np.uint8
    assert model.extras["last_result"].nfe >= 2
