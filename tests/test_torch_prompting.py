"""Prompting in the port (sjd_tpu_torch/data, utils/tokenizer.py and the VQ
encoder of models/vq/taming.py) against sjd_tpu on the same inputs:

  * the conversation text and the text-to-image prompt ids, exactly;
  * the vocabulary mapping from a tokenizer's IMGIMG names, exactly;
  * the VQ encoder's latents within 1e-4 in f32 (the convolutions sum in
    another order), and its codebook ids equal wherever JAX's two nearest
    distances differ by more than 1e-5;
  * process_image and multimodal_prompt_ids on arrays and PIL images
    (tests/test_image_input.py:59, :85, :161), exactly;
  * the tokenizer wrapper on a tokenizer.json built here."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ckpt_synth import ChameleonFakeTokenizer
from sjd_tpu.data import image_processing as jip
from sjd_tpu.data import item_processor as jitem
from sjd_tpu.data import vocab_translation as jvocab
from sjd_tpu.models.vq import VQConfig, init_vq_params as jax_init_vq_params
from sjd_tpu.models.vq import taming as jtaming
from sjd_tpu_torch.convert import vq_config_from_jax, vq_params_from_jax
from sjd_tpu_torch.data import image_processing as ip
from sjd_tpu_torch.data import item_processor as item
from sjd_tpu_torch.data import vocab_translation as vocab
from sjd_tpu_torch.models.vq import taming
from test_torch_lumina_slice import TINY_CHAMELEON_VQ

# tests/test_image_input.py's VQ: the real downsample factor, tiny widths
TINY_VQ = VQConfig(ch=32, ch_mult=(1, 1, 1, 1, 1), num_res_blocks=1, z_channels=32,
                   embed_dim=32, n_embed=64)
CAPTIONS = ["a photo of a cat", "", "Ünïcode, 日本語 and\nnew lines"]


class FakeTokenizer:
    """tests/test_image_input.py's: text -> deterministic ids."""

    def encode(self, text):
        return [9000 + (ord(c) % 50) for c in text[:8]]


def shuffled_vocab(n_img=64, bpe_base=4, seed=7):
    perm = np.random.RandomState(seed).permutation(n_img)
    return {jvocab.image_token_name(i): int(bpe_base + s) for i, s in enumerate(perm)}


def vq_pair(cfg, seed=0):
    """The JAX VQ params and the port's copy of them."""
    jp = jax_init_vq_params(jax.random.PRNGKey(seed), cfg)
    return jp, vq_params_from_jax(jax.tree.map(np.asarray, jp), vq_config_from_jax(cfg),
                                  device="cpu")


def processors(input_patches=1024):
    mp = vocab.mapping_from_vocab(shuffled_vocab())
    jm = jvocab.mapping_from_vocab(shuffled_vocab())
    jp, pp = vq_pair(TINY_VQ)
    want = jitem.FlexARItemProcessor(FakeTokenizer(), mapping=jm, vq_params=jp, vq_cfg=TINY_VQ,
                                     input_patches=input_patches)
    got = item.FlexARItemProcessor(FakeTokenizer(), mapping=mp, vq_params=pp,
                                   vq_cfg=vq_config_from_jax(TINY_VQ),
                                   input_patches=input_patches)
    return want, got


def pixels(seed, h=32, w=32):
    return (np.random.RandomState(seed).rand(h, w, 3).astype(np.float32) * 2) - 1


@pytest.mark.parametrize("caption", CAPTIONS)
def test_conversation_and_t2i_prompt_ids_equal_jax(caption):
    assert item.t2i_question(caption, 512, 768) == jitem.t2i_question(caption, 512, 768)
    qas = [["describe <|image|>", "a red square"], [caption, None]]
    assert item.conversation_prompt(qas) == jitem.conversation_prompt(qas)
    tok = ChameleonFakeTokenizer()
    want = jitem.FlexARItemProcessor(tok).t2i_prompt_ids(caption, 768)
    assert item.FlexARItemProcessor(tok).t2i_prompt_ids(caption, 768) == want
    assert item.size_token_id(768) == jitem.size_token_id(768)
    assert item.grid_dims(512, 768) == jitem.grid_dims(512, 768)


def test_mapping_from_tokenizer_equals_jax():
    tok = ChameleonFakeTokenizer()
    got, want = vocab.mapping_from_tokenizer(tok), jvocab.mapping_from_tokenizer(tok)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    ids = np.random.RandomState(0).randint(0, 8192, (4, 6))
    np.testing.assert_array_equal(vocab.img_to_bpe(got, ids), jvocab.img_to_bpe(want, ids))
    bpe = vocab.img_to_bpe(got, ids)
    np.testing.assert_array_equal(vocab.bpe_to_img(got, bpe), ids)
    for name in ("IMGIMGBCDZ", "IMGIMGAZ", vocab.image_token_name(8191)):
        assert vocab.codebook_id_from_name(name) == jvocab.codebook_id_from_name(name)
    with pytest.raises(ValueError, match="out of range"):
        vocab.img_to_bpe(got, [8192])
    with pytest.raises(ValueError, match="not LM image tokens"):
        vocab.bpe_to_img(got, [8710])
    with pytest.raises(ValueError, match="no IMGIMG"):
        vocab.mapping_from_vocab({"hello": 3})


def test_image_processing_equals_jax():
    from PIL import Image

    assert ip.generate_crop_size_list(64, 32) == jip.generate_crop_size_list(64, 32)
    assert ip.generate_crop_size_list() == jip.generate_crop_size_list()
    for hw in ((500, 700), (64, 64), (3000, 1000)):
        assert ip.smart_resize(*hw) == jip.smart_resize(*hw)
    img = Image.fromarray((np.random.RandomState(0).rand(300, 200, 3) * 255).astype(np.uint8))
    np.testing.assert_array_equal(ip.preprocess(img), jip.preprocess(img))
    px = pixels(1)
    np.testing.assert_array_equal(np.asarray(ip.postprocess(px)), np.asarray(jip.postprocess(px)))


def _jax_latents(params, cfg, px):
    """sjd_tpu's encode up to the codebook (taming.encode's body)."""
    e = params["encoder"]
    h = jtaming.conv2d(px.astype(cfg.dtype), e["conv_in_w"], e["conv_in_b"])
    for level in e["down"]:
        for j in range(cfg.num_res_blocks):
            h = jtaming.resnet_block(level["res"][j], h)
            if level.get("attn"):
                h = jtaming.attn_block(level["attn"][j], h)
        if "downsample" in level:
            h = jtaming.downsample(level["downsample"], h)
    h = jtaming.resnet_block(e["mid_block1"], h)
    h = jtaming.attn_block(e["mid_attn"], h)
    h = jtaming.resnet_block(e["mid_block2"], h)
    h = jtaming.group_norm(h, e["norm_out_scale"], e["norm_out_bias"])
    h = jtaming.conv2d(jtaming.swish(h), e["conv_out_w"], e["conv_out_b"])
    return jtaming.conv2d(h, params["quant_conv_w"], params["quant_conv_b"])


@pytest.mark.parametrize("cfg", [TINY_VQ, TINY_CHAMELEON_VQ], ids=["n64", "n8192"])
def test_encode_equals_jax(cfg):
    jp, pp = vq_pair(cfg, seed=3)
    pcfg = vq_config_from_jax(cfg)
    px = np.stack([pixels(4, 64, 32), pixels(5, 64, 32)])
    jz = np.asarray(_jax_latents(jp, cfg, jnp.asarray(px)))
    z = taming.encode_latents(pp, pcfg, torch.from_numpy(px))
    assert tuple(z.shape) == jz.shape == (2, 4, 2, cfg.embed_dim)
    np.testing.assert_allclose(z.numpy(), jz, atol=1e-4, rtol=0)

    want = np.asarray(jtaming.encode(jp, cfg, jnp.asarray(px)))
    got = taming.encode(pp, pcfg, torch.from_numpy(px)).numpy()
    assert got.shape == want.shape == (2, 8) and got.dtype == np.int32
    # where JAX's two nearest codebook entries are within 1e-5 the pick
    # rests on rounding: hold the ids everywhere else
    cb = np.asarray(jp["codebook"], np.float32)
    flat = jz.reshape(-1, cfg.embed_dim)
    d = (flat ** 2).sum(1, keepdims=True) - 2 * flat @ cb.T + (cb ** 2).sum(1)[None]
    two = np.sort(d, axis=1)[:, :2]
    clear = (two[:, 1] - two[:, 0]) > 1e-5
    assert clear.any()
    np.testing.assert_array_equal(got.reshape(-1)[clear], want.reshape(-1)[clear])
    # codebook rows give back their own ids
    rows = pp["codebook"][torch.tensor([5, 0, 63 if cfg.n_embed == 64 else 8191])]
    own = taming.codebook_encode(pcfg, pp["codebook"], rows.reshape(1, 1, 3, -1))
    assert own.tolist() == [[5, 0, 63 if cfg.n_embed == 64 else 8191]]


def test_process_image_equals_jax_on_an_array():
    want, got = processors()
    px = pixels(1)
    block = got.process_image(px)
    assert block == want.process_image(px)
    assert block[0] == item.IMAGE_START_ID and block[5] == item.NEW_LINE_ID
    grid = item.image_grid_from_block(block, mapping=got.mapping)
    direct = taming.encode(got.vq_params, got.vq_cfg, torch.from_numpy(px[None]))
    np.testing.assert_array_equal(grid.reshape(-1), direct[0].numpy())
    assert [g.tolist() for g in got.decode_images(block)] == [grid.tolist()]
    with pytest.raises(ValueError, match="multiples"):
        got.process_image(pixels(1, 48, 32))


def test_process_image_equals_jax_on_a_pil_image():
    """A 500 x 500 PIL input fitted to a crop size first."""
    from PIL import Image

    want, got = processors(input_patches=64)
    img = Image.fromarray((np.random.RandomState(0).rand(500, 500, 3) * 255).astype(np.uint8))
    block = got.process_image(img)
    assert block == want.process_image(img)
    grid = item.image_grid_from_block(block, mapping=got.mapping)
    assert all((s * 16) % 32 == 0 for s in grid.shape)


@pytest.mark.parametrize("qas,n_images", [
    ([["edit <|image|> like <|image|>", None]], 2),
    ([["describe <|image|>", "a red square"], ["now redraw it", None]], 1),
], ids=["two_images", "multiturn"])
def test_multimodal_prompt_ids_equal_jax(qas, n_images):
    want, got = processors()
    images = [pixels(2 + i) for i in range(n_images)]
    ids = got.multimodal_prompt_ids(qas, images)
    assert ids == want.multimodal_prompt_ids(qas, images)
    assert sum(t == item.IMAGE_START_ID for t in ids) == n_images


def _tokenizer_dir(tmp_path):
    """A word-level tokenizer.json with text words, IMGIMG names and the
    separator, as a HuggingFace fast tokenizer directory."""
    import json

    from tokenizers import Tokenizer as HFTokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    words = ["<unk>", "<s>", "</s>", "a", "photo", "of", "cat", "red", "square"]
    vocab_map = {w: i for i, w in enumerate(words)}
    vocab_map.update({vocab.image_token_name(i): 100 + (7 * i) % 16 for i in range(16)})
    tok = HFTokenizer(WordLevel(vocab_map, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    d = tmp_path / "tok"
    d.mkdir()
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>",
        "eos_token": "</s>", "unk_token": "<unk>"}))
    return str(d)


def test_tokenizer_wrapper_equals_jax(tmp_path):
    from sjd_tpu.utils.tokenizer import Tokenizer as JaxTokenizer
    from sjd_tpu_torch.utils.tokenizer import Tokenizer

    d = _tokenizer_dir(tmp_path)
    got, want = Tokenizer(d), JaxTokenizer(d)
    assert got.backend == want.backend == "huggingface"
    for text in ("a photo of a cat", "red square unknownword", ""):
        for bos, eos in ((False, False), (True, True)):
            assert got.encode(text, bos=bos, eos=eos) == want.encode(text, bos=bos, eos=eos)
    ids = got.encode("a red cat")
    assert got.decode(ids) == want.decode(ids)
    assert got.vocab_size == want.vocab_size
    assert got.token_to_id("cat") == want.token_to_id("cat")
    # the image-token mapping from the wrapper, as the loader builds it
    m = vocab.mapping_from_tokenizer(got)
    jm = jvocab.mapping_from_vocab(want.tok.get_vocab())
    for a, b in zip(m, jm):
        np.testing.assert_array_equal(a, b)
    # a tokenizer.json path works as the directory does
    assert Tokenizer(d + "/tokenizer.json").encode("a cat") == ids[:1] + ids[2:]
