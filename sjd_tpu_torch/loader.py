"""Model loading (sjd_tpu/loader.py): ``load_lumina_mgpt``, ``load_emu3``,
``load_anole``, ``load_llamagen`` and the ``load_pretrained_model``
registry.

The decoder comes from a checkpoint directory (``ckpt_dir``: sharded
``.safetensors``, ``pytorch_model*.bin``, ``.pt`` or ``.pth``, HF naming)
and the VQGAN from one file (``vq_ckpt``, taming naming; Emu3VisionVQ from
a directory, ``vq_ckpt_dir``), read by
``utils/port.py`` with no package beyond torch; prompts go through a
tokenizer (``tokenizer``: any object with ``encode`` and, for the image
tokens' mapping, ``get_vocab``). Each part that is not given falls back:
random decoder weights (seed 0), a random VQGAN (seed 1), placeholder
prompt ids with the offset-only image mapping. Every stage then runs for
real, but the images are noise; ``extras["smoke"]`` and
``extras["smoke_reasons"]`` say which fallbacks are in play. Weights are
bf16 or quantized (``quantize=``, ``embed_bits=``): random weights leaf by
leaf as they are drawn, checkpoint weights on the card after the port,
W4A16 equilibrated first.
"""

from __future__ import annotations

import dataclasses
import logging
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from . import resolve_device

_log = logging.getLogger("sjd_tpu_torch.loader")

_INT4_OPTS = (4, "4", "int4", "w4a8", "int4_a8")
_QUANT_OPTS = (False, None, True, 8, "8", "int8") + _INT4_OPTS


def _act_quant_of(quantize) -> str:
    """"w4a8"/"int4_a8": int4 weights with per-token int8 activations and
    int32 sums (W4A8); everything else multiplies bf16 activations."""
    return "int8" if quantize in ("w4a8", "int4_a8") else "bf16"


def _check_quant(model_cfg, quantize, embed_bits) -> int:
    """The projections' bits (0 for bf16), after checking the options."""
    if quantize not in _QUANT_OPTS:
        raise ValueError(f"quantize={quantize!r}: expected one of {_QUANT_OPTS}")
    if embed_bits and not quantize:
        raise ValueError("embed_bits needs quantize")
    if not quantize:
        return 0
    if embed_bits not in (None, 8):
        raise ValueError("embedding quantization supports int8 only")
    if embed_bits and model_cfg.tie_word_embeddings:
        raise ValueError("embed_bits requires untied embeddings")
    return 4 if quantize in _INT4_OPTS else 8


def quantize_ported_params(params, model_cfg, quantize, embed_bits=None):
    """Quantize a ported (checkpoint) tree where it lies, as the JAX
    checkpoint path does: int8 projections (W8A16) or packed int4 ones with
    the column equilibration (W4A16), an int8 head, the int8 embedding with
    ``embed_bits=8``. The equilibration folds tie every bf16 projection
    together, so the whole bf16 tree is live while it runs."""
    from .models.transformer import quantize_weights

    bits = _check_quant(model_cfg, quantize, embed_bits)
    if not bits:
        return params
    return quantize_weights(params, bits=bits, head_bits=8, equilibrate=True,
                            config=model_cfg, embed_bits=embed_bits)


def _build_decoder_params(model_cfg, ckpt_dir, quantize, embed_bits, device):
    """The decoder's weights: ported from ``ckpt_dir`` (then quantized on
    the device) or random (seed 0), quantized as they are drawn when
    ``quantize``: False = bf16; True or 8 = int8 projections (W8A16); 4,
    "int4" = packed int4 projections with an int8 head (W4A16); "w4a8" =
    the same weights for int8 activations. Random weights skip the
    equilibration, as the JAX loader does (a no-op without outlier columns;
    its folds would need every bf16 weight at once): each stacked bf16
    weight is quantized and released before the next is drawn, so at most
    one (the largest, w_gate: 2.9 GB for the 7B) is live beside the
    quantized tree; the draws equal the bf16 load's."""
    from .models.transformer import init_params, quantize_leaf

    bits = _check_quant(model_cfg, quantize, embed_bits)
    if ckpt_dir:
        from .utils.port import load_sharded_state, port_hf_llama_like

        params = port_hf_llama_like(load_sharded_state(ckpt_dir), model_cfg, device=device)
        return quantize_ported_params(params, model_cfg, quantize, embed_bits)
    if not bits:
        return init_params(0, model_cfg, device=device)

    def leaf_fn(name, w):
        return quantize_leaf(name, w, bits=bits, head_bits=8, embed_bits=embed_bits)

    return init_params(0, model_cfg, device=device, leaf_fn=leaf_fn)


@dataclasses.dataclass
class LoadedModel:
    name: str
    engine: Any
    params: Any
    sample_fn: Callable[..., np.ndarray]  # prompt -> uint8 [H, W, 3]
    extras: dict

    @property
    def smoke(self) -> bool:
        """True when any fallback (random weights, placeholder prompt ids)
        is in play: outputs exercise the pipeline but are not real images."""
        return bool(self.extras.get("smoke"))


def _mark_smoke(extras: dict, family: str, reasons: list) -> dict:
    extras["smoke"] = bool(reasons)
    extras["smoke_reasons"] = list(reasons)
    if reasons:
        _log.warning("%s loaded in SMOKE mode (%s): generations exercise the "
                     "full pipeline but are not real model outputs",
                     family, "; ".join(reasons))
    return extras


def pixels_to_uint8(pixels: torch.Tensor) -> np.ndarray:
    """[H, W, 3] in [-1, 1] -> uint8 (the JAX loader's PIL conversion)."""
    arr = pixels.detach().float().cpu().numpy()
    return ((np.clip(arr, -1, 1) + 1) * 127.5).astype(np.uint8)


def load_lumina_mgpt(
    ckpt_dir: Optional[str] = None,
    vq_ckpt: Optional[str] = None,
    *,
    size: str = "7B",
    target_size: int = 768,
    window: int = 16,
    guidance_scale: float = 3.0,
    image_top_k: int = 2000,
    scheme: str = "speculative_jacobi",
    init: str = "random",
    seed: int = 42,
    tokenizer=None,  # any object with encode (and get_vocab for the image tokens)
    quantize=False,  # True/8: W8A16; 4/"int4": W4A16 + int8 head; "w4a8": W4A8
    embed_bits: Optional[int] = None,  # 8: the int8 per-row embedding table
    # e.g. torch.bfloat16: the VQ's weights and activations in bf16 (the
    # codebook stays f32), as demo_server --slots > 1 serves it
    vq_dtype: Optional[torch.dtype] = None,
    model_cfg=None,  # DecoderConfig override; must keep the FlexAR vocab layout
    vq_cfg=None,  # VQConfig override
    device=None,
) -> LoadedModel:
    from .data.item_processor import (
        FlexARItemProcessor, image_grid_from_block, size_token_id, split_generation)
    from .data.vocab_translation import identity_mapping, mapping_from_tokenizer
    from .models.chameleon import IMAGE_END_ID, IMAGE_START_ID, lumina_engine
    from .models.vq import CHAMELEON_VQ, decode as vq_decode, init_vq_params, port_vqgan

    dev = resolve_device(device)
    eng = lumina_engine(size=size, target_size=target_size, window=window,
                        guidance_scale=guidance_scale, image_top_k=image_top_k,
                        scheme=scheme, init=init, act_quant=_act_quant_of(quantize),
                        model_cfg=model_cfg, device=dev)
    params = _build_decoder_params(eng.model_cfg, ckpt_dir, quantize, embed_bits, dev)
    vq_cfg = vq_cfg if vq_cfg is not None else CHAMELEON_VQ
    if vq_dtype is not None:
        vq_cfg = dataclasses.replace(vq_cfg, dtype=vq_dtype)
    if vq_ckpt:
        from .utils.port import load_torch_checkpoint

        vq_params = port_vqgan(load_torch_checkpoint(vq_ckpt), vq_cfg, device=dev)
    else:
        vq_params = init_vq_params(1, vq_cfg, device=dev)
    # the LM's image tokens are a name-derived permutation of the codebook
    # ids, which only the tokenizer's IMGIMG names give
    if tokenizer is not None and hasattr(tokenizer, "get_vocab"):
        mapping = mapping_from_tokenizer(tokenizer)
    else:
        mapping = identity_mapping(vq_cfg.n_embed, 4)
    item_proc = (FlexARItemProcessor(tokenizer, mapping=mapping, vq_params=vq_params,
                                     vq_cfg=vq_cfg) if tokenizer is not None else None)
    header = [IMAGE_START_ID, size_token_id(target_size), size_token_id(target_size)]
    extras: dict = {"vq_params": vq_params, "vq_cfg": vq_cfg, "mapping": mapping,
                    "item_processor": item_proc, "last_result": None,
                    "quantize": quantize, "embed_bits": embed_bits}

    def decode_image_fn(toks) -> np.ndarray:
        """Generated token row -> uint8 image of its last image span."""
        spans = [s for k, s in split_generation(toks) if k == "image"]
        if not spans:
            raise ValueError("no image generated")
        span = spans[-1]
        grid = image_grid_from_block(span[:-1] if span[-1] == IMAGE_END_ID else span,
                                     mapping=mapping)
        ids = torch.as_tensor(grid.reshape(1, -1), device=dev)
        with torch.no_grad():
            pixels = vq_decode(vq_params, vq_cfg, ids, grid.shape)
        return pixels_to_uint8(pixels[0])

    def prompt_ids_fn(prompt: str):
        """Text -> the full prompt ids, the image header included. Without a
        tokenizer the text ids are placeholders from a stable hash of the
        prompt (the JAX loader uses Python's per-process ``hash``)."""
        if item_proc is not None:
            return item_proc.t2i_prompt_ids(prompt, target_size) + header
        h = zlib.crc32(prompt.encode())
        return [(h >> (4 * i)) % 4000 + 9000 for i in range(12)] + header

    def generate_ids(ids, rng_seed) -> np.ndarray:
        res = eng.generate(params, seed if rng_seed is None else rng_seed,
                           torch.as_tensor([ids], dtype=torch.int32, device=dev))
        extras["last_result"] = res
        return decode_image_fn(res.tokens[0, : int(res.length[0])].tolist())

    def sample_fn(prompt: str, rng_seed: Optional[int] = None) -> np.ndarray:
        return generate_ids(prompt_ids_fn(prompt), rng_seed)

    def sample_freeform_fn(qas, images=(), rng_seed: Optional[int] = None) -> np.ndarray:
        """A multi-turn conversation ([question, answer or None] turns whose
        text may hold ``<|image|>``, filled from ``images`` in order: PIL
        images or uint8 [H, W, 3] arrays of any size, or float [H, W, 3]
        arrays in [-1, 1]) -> the image it generates."""
        if item_proc is None:
            raise ValueError("image-input prompting needs a tokenizer")
        return generate_ids(item_proc.multimodal_prompt_ids(qas, images) + header, rng_seed)

    def sample_i2i_fn(prompt: str, images, rng_seed: Optional[int] = None) -> np.ndarray:
        """One turn conditioned on ``images``."""
        return sample_freeform_fn([[prompt, None]], images, rng_seed)

    extras.update(prompt_ids_fn=prompt_ids_fn, decode_image_fn=decode_image_fn,
                  sample_freeform_fn=sample_freeform_fn, sample_i2i_fn=sample_i2i_fn)
    smoke = []
    if not ckpt_dir:
        smoke.append("random decoder weights (no ckpt_dir)")
    if not vq_ckpt:
        smoke.append("random VQ decoder (no vq_ckpt)")
    if item_proc is None:
        smoke.append("placeholder prompt ids (no tokenizer)")
    return LoadedModel(name="lumina_mgpt", engine=eng, params=params,
                       sample_fn=sample_fn,
                       extras=_mark_smoke(extras, "lumina_mgpt", smoke))


def _image_to_array(image) -> np.ndarray:
    """A PIL image -> [H, W, 3] float32 in [-1, 1]; arrays pass through (they
    are taken as already normalised)."""
    if hasattr(image, "convert") and not isinstance(image, (np.ndarray, torch.Tensor)):
        return np.asarray(image.convert("RGB"), np.float32) / 127.5 - 1.0
    return np.asarray(image, np.float32)


def load_emu3(
    ckpt_dir: Optional[str] = None,
    vq_ckpt_dir: Optional[str] = None,
    *,
    h: int = 90,
    w: int = 90,
    window: int = 16,
    guidance_scale: float = 3.0,
    image_top_k: int = 2048,
    scheme: str = "speculative_jacobi",
    init: str = "random",
    tokenizer=None,  # any object with encode over the Emu3 vocabulary
    tokenizer_dir: Optional[str] = None,  # emu3.tiktoken + emu3_vision_tokens.txt
    negative_prompt_ids=None,
    negative_prompt: Optional[str] = None,
    positive_suffix: Optional[str] = None,
    quantize=True,  # True/8: W8A16; 4/"int4": W4A16 + int8 head; "w4a8": W4A8
    embed_bits: Optional[int] = None,  # 8: the int8 per-row embedding table
    kv_quant: bool = False,  # the int8 KV cache (the JAX loader's is bf16)
    vq_dtype: Optional[torch.dtype] = None,  # e.g. torch.bfloat16 for the VQ
    model_cfg=None,  # DecoderConfig override; must keep the Emu3 vocab layout
    vq_cfg=None,  # Emu3VQConfig override
    device=None,
) -> LoadedModel:
    """Emu3-Gen (sjd_tpu/loader.py:load_emu3): the decoder from ``ckpt_dir``
    (HF names, GQA) or random, Emu3VisionVQ from ``vq_ckpt_dir`` or random
    (seed 1), prompts from ``tokenizer`` (or ``tokenizer_dir``'s tiktoken
    files) or placeholders. ``sample_fn(prompt)`` -> uint8 [8h, 8w, 3] with
    CFG against ``negative_prompt``; ``understand_fn(question, image)`` ->
    the answer's token ids (no CFG, no grammar)."""
    from .data.emu3_processor import build_gen_prompt, extract_image_grid
    from .models.emu3 import emu3_engine, emu3_grammar_state
    from .models.vq.emu3_port import init_emu3_vq_params, port_emu3_vq
    from .models.vq.emu3_vq import EMU3_VQ, decode as emu3_decode
    from .utils.emu3_tokenizer import (
        DEFAULT_NEGATIVE_PROMPT, DEFAULT_POSITIVE_SUFFIX, Emu3Tokenizer)

    dev = resolve_device(device)
    if tokenizer is None and tokenizer_dir:
        import os

        tokenizer = Emu3Tokenizer(os.path.join(tokenizer_dir, "emu3.tiktoken"),
                                  os.path.join(tokenizer_dir, "emu3_vision_tokens.txt"))
    eng = emu3_engine(h=h, w=w, window=window, guidance_scale=guidance_scale,
                      image_top_k=image_top_k, scheme=scheme, init=init,
                      kv_quant=kv_quant, act_quant=_act_quant_of(quantize),
                      model_cfg=model_cfg, device=dev)
    params = _build_decoder_params(eng.model_cfg, ckpt_dir, quantize, embed_bits, dev)
    vq_cfg = vq_cfg if vq_cfg is not None else EMU3_VQ
    if vq_dtype is not None:
        vq_cfg = dataclasses.replace(vq_cfg, dtype=vq_dtype)
    if vq_ckpt_dir:
        from .utils.port import load_sharded_state

        vq_params = port_emu3_vq(load_sharded_state(vq_ckpt_dir), vq_cfg, device=dev)
    else:
        vq_params = init_emu3_vq_params(1, vq_cfg, device=dev)
    if vq_dtype is not None:  # the codebook too, as the JAX loader casts it
        vq_params["codebook"] = vq_params["codebook"].to(vq_dtype)
    positive_suffix = DEFAULT_POSITIVE_SUFFIX if positive_suffix is None else positive_suffix
    negative_prompt = DEFAULT_NEGATIVE_PROMPT if negative_prompt is None else negative_prompt
    extras: dict = {"vq_params": vq_params, "vq_cfg": vq_cfg, "tokenizer": tokenizer,
                    "negative_prompt": negative_prompt, "last_result": None,
                    "quantize": quantize, "embed_bits": embed_bits}

    def _placeholder_ids(text: str, n: int):
        """Stable placeholder text ids (the JAX loader hashes with Python's
        per-process ``hash``)."""
        c = zlib.crc32(text.encode())
        return [(c >> (4 * i)) % 1000 + 1000 for i in range(n)]

    def prompt_ids_fn(prompt: str):
        """Text -> the full generation prompt: bos + text + boi + "{H}*{W}" +
        the <|image token|> marker (the positive suffix appended to the
        text when a tokenizer is given)."""
        if tokenizer is not None:
            return build_gen_prompt(list(tokenizer.encode(prompt + positive_suffix)), h, w,
                                    lambda s: list(tokenizer.encode(s)))
        return build_gen_prompt(_placeholder_ids(prompt, 12), h, w, lambda s: [1500])

    def neg_ids_fn():
        """The negative prompt, a full generation prompt of its own."""
        if negative_prompt_ids is not None:
            return list(negative_prompt_ids)
        if tokenizer is not None:
            return build_gen_prompt(list(tokenizer.encode(negative_prompt)), h, w,
                                    lambda s: list(tokenizer.encode(s)))
        return build_gen_prompt(_placeholder_ids(negative_prompt, 8), h, w, lambda s: [1500])

    def decode_image_fn(toks) -> np.ndarray:
        """A generated token row (prompt and generation) -> uint8 image."""
        grid = extract_image_grid([int(t) for t in toks])
        with torch.no_grad():
            pixels = emu3_decode(vq_params, vq_cfg, torch.as_tensor(grid[None], device=dev))
        return pixels_to_uint8(pixels[0])

    def sample_fn(prompt: str, rng_seed: int = 42) -> np.ndarray:
        ids = prompt_ids_fn(prompt)
        res = eng.generate(params, rng_seed, torch.tensor([ids], dtype=torch.int32, device=dev),
                           neg_prompt=torch.tensor([neg_ids_fn()], dtype=torch.int32,
                                                   device=dev),
                           gstate=emu3_grammar_state(1, h, w, device=dev))
        extras["last_result"] = res
        return decode_image_fn(res.tokens[0, : int(res.length[0])].tolist())

    u_state: dict = {}

    def _understand_engine(max_new_tokens: int):
        """The understanding engine, built once per answer budget: the
        prompt left-padded to one bucket, so every question reuses one
        state and graph; the rope table covers the bucket and the answer."""
        from .core.engine import SJDEngine
        from .core.grammar import GrammarSpec
        from .core.processors import SamplingParams
        from .models.adapter import decoder_model_fns
        from .models.emu3 import EOS_ID

        key = ("engine", max_new_tokens)
        if key not in u_state:
            p_bucket = h * (w + 1) + 128  # the image's rows + header, template, text
            u_model = decoder_model_fns(
                eng.model_cfg, device=dev,
                max_positions=max(eng.model_cfg.max_position_embeddings or 0,
                                  p_bucket + max_new_tokens + window + 8))
            u_state[key] = (SJDEngine(
                u_model, dataclasses.replace(eng.config, cfg_mode="none",
                                             max_len=max_new_tokens, eos_id=EOS_ID),
                GrammarSpec(kind="none"),
                SamplingParams(do_cfg=False, image_top_k=10, text_top_k=10)), p_bucket)
        return u_state[key]

    def understand_fn(question: str, image, rng_seed: int = 42,
                      max_new_tokens: int = 256) -> list:
        """Image understanding: pixels (PIL, or [H, W, 3] in [-1, 1]) ->
        Emu3VisionVQ codes -> the chat prompt -> the answer's token ids."""
        from .data.emu3_processor import build_understanding_prompt
        from .models.emu3 import PAD_ID
        from .models.vq.emu3_vq import encode as emu3_encode

        if tokenizer is None:
            raise ValueError("understanding mode needs the tokenizer")
        arr = _image_to_array(image)
        with torch.no_grad():
            grid = emu3_encode(vq_params, vq_cfg,
                               torch.from_numpy(arr[None]).to(dev))[0].cpu().numpy()
        ids = build_understanding_prompt(question, grid.astype(np.int32),
                                         lambda s: list(tokenizer.encode(s)))
        u_eng, p_bucket = _understand_engine(max_new_tokens)
        if len(ids) > p_bucket:
            raise ValueError(f"prompt {len(ids)} tokens exceeds the {p_bucket} bucket")
        pad = p_bucket - len(ids)
        prompt = torch.tensor([[PAD_ID] * pad + ids], dtype=torch.int32, device=dev)
        mask = torch.tensor([[False] * pad + [True] * len(ids)], device=dev)
        res = u_eng.generate(params, rng_seed, prompt, prompt_mask=mask)
        extras["last_understand_result"] = res
        return res.tokens[0, p_bucket: int(res.length[0])].tolist()

    def make_gstate(metas):
        """Per-slot grammar state for a batcher: every slot has this grid."""
        return emu3_grammar_state(len(metas), h, w, device=dev)

    extras.update(understand_fn=understand_fn, prompt_ids_fn=prompt_ids_fn,
                  neg_ids_fn=neg_ids_fn, decode_image_fn=decode_image_fn,
                  make_gstate=make_gstate)
    smoke = []
    if not ckpt_dir:
        smoke.append("random decoder weights (no ckpt_dir)")
    if not vq_ckpt_dir:
        smoke.append("random VisionVQ (no vq_ckpt_dir)")
    if tokenizer is None:
        smoke.append("placeholder prompt ids (no tokenizer)")
    return LoadedModel(name="emu3", engine=eng, params=params, sample_fn=sample_fn,
                       extras=_mark_smoke(extras, "emu3", smoke))


def load_anole(
    ckpt_dir: Optional[str] = None,
    vq_ckpt: Optional[str] = None,
    *,
    window: int = 16,
    guidance_scale: float = 7.0,
    image_top_k: int = 2000,
    text_top_k: int = 10,
    scheme: str = "speculative_jacobi",
    init: str = "random",
    multimodal_generation_mode: str = "image-only",
    tokenizer=None,  # any object with encode (and get_vocab for the image tokens)
    quantize=False,
    embed_bits: Optional[int] = None,
    kv_quant: bool = False,  # the int8 KV cache (the JAX loader's is bf16)
    model_cfg=None,  # DecoderConfig override
    vq_cfg=None,  # VQConfig override
    image_seq_length: int = 1024,  # tokens per image (32 x 32 latents)
    device=None,
) -> LoadedModel:
    """Anole-7B (sjd_tpu/loader.py:load_anole): the Chameleon backbone with a
    fixed ``image_seq_length``-token image after <boi>, and the Chameleon
    VQGAN. ``sample_fn(prompt)`` -> uint8 image (token ids in text-only
    mode); ``encode_image_fn(image)`` -> the image's BPE ids."""
    import math

    from .data.vocab_translation import (
        bpe_to_img, identity_mapping, img_to_bpe, mapping_from_tokenizer)
    from .models.anole import BOI_ID, anole_engine, normalize_mode
    from .models.vq import CHAMELEON_VQ, decode as vq_decode, encode as vq_encode
    from .models.vq import init_vq_params, port_vqgan

    dev = resolve_device(device)
    mode = normalize_mode(multimodal_generation_mode)
    eng = anole_engine(window=window, guidance_scale=guidance_scale, image_top_k=image_top_k,
                       text_top_k=text_top_k, scheme=scheme, init=init,
                       multimodal_generation_mode=mode, kv_quant=kv_quant,
                       act_quant=_act_quant_of(quantize), model_cfg=model_cfg,
                       image_seq_length=image_seq_length, device=dev)
    params = _build_decoder_params(eng.model_cfg, ckpt_dir, quantize, embed_bits, dev)
    vq_cfg = vq_cfg if vq_cfg is not None else CHAMELEON_VQ
    if vq_ckpt:
        from .utils.port import load_torch_checkpoint

        vq_params = port_vqgan(load_torch_checkpoint(vq_ckpt), vq_cfg, device=dev)
    else:
        vq_params = init_vq_params(1, vq_cfg, device=dev)
    if tokenizer is not None and hasattr(tokenizer, "get_vocab"):
        mapping = mapping_from_tokenizer(tokenizer)
    else:
        mapping = identity_mapping(vq_cfg.n_embed, 4)
    isl = image_seq_length
    side = math.isqrt(isl)
    if side * side != isl:
        raise ValueError("image_seq_length must be a square grid")
    extras: dict = {"vq_params": vq_params, "vq_cfg": vq_cfg, "mapping": mapping,
                    "multimodal_generation_mode": multimodal_generation_mode,
                    "boi_id": BOI_ID, "last_result": None, "quantize": quantize}

    def prompt_ids_fn(prompt: str):
        """Text -> prompt ids, <boi> appended in image-only mode. Without a
        tokenizer the ids are placeholders from a stable hash."""
        if tokenizer is not None:
            ids = list(tokenizer.encode(prompt))
        else:
            c = zlib.crc32(prompt.encode())
            ids = [(c >> (4 * i)) % 4000 + 9000 for i in range(12)]
        return ids + [BOI_ID] if mode == "image-only" else ids

    def _decode_span(toks, start) -> np.ndarray:
        grid = np.asarray(toks[start: start + isl], np.int32).reshape(side, side)
        ids = torch.as_tensor(bpe_to_img(mapping, grid).reshape(1, -1), device=dev)
        with torch.no_grad():
            pixels = vq_decode(vq_params, vq_cfg, ids, (side, side))
        return pixels_to_uint8(pixels[0])

    def _image_start(toks):
        """The first position after a <boi> that a whole image follows."""
        start = next((k + 1 for k, t in enumerate(toks)
                      if t == BOI_ID and len(toks) - k > isl), None)
        if start is None:
            raise ValueError("no complete image in the generation")
        return start

    def sample_fn(prompt: str, rng_seed: int = 42):
        ids = prompt_ids_fn(prompt)
        res = eng.generate(params, rng_seed, torch.tensor([ids], dtype=torch.int32, device=dev))
        extras["last_result"] = res
        toks = res.tokens[0, : int(res.length[0])].tolist()
        if mode == "text-only":
            return toks[len(ids):]  # token ids: detokenizing is the caller's
        if mode == "image-only":
            return _decode_span(toks, len(ids))  # <boi> ends the prompt
        return _decode_span(toks, len(ids) + _image_start(toks[len(ids):]))

    def decode_image_fn(toks) -> np.ndarray:
        """A token row -> the image of its first whole <boi> span (left
        padding and prompt length do not matter)."""
        toks = [int(t) for t in toks]
        return _decode_span(toks, _image_start(toks))

    def encode_image_fn(image) -> list:
        """Pixels (PIL, or [H, W, 3] in [-1, 1]) -> VQ codes -> BPE image-token
        ids, to splice between <boi> and <eoi>."""
        arr = _image_to_array(image)
        with torch.no_grad():
            ids = vq_encode(vq_params, vq_cfg, torch.from_numpy(arr[None]).to(dev))
        return img_to_bpe(mapping, ids[0].cpu().numpy().astype(np.int32)).tolist()

    extras.update(prompt_ids_fn=prompt_ids_fn, decode_image_fn=decode_image_fn,
                  encode_image_fn=encode_image_fn)
    smoke = []
    if not ckpt_dir:
        smoke.append("random decoder weights (no ckpt_dir)")
    if not vq_ckpt:
        smoke.append("random VQ decoder (no vq_ckpt)")
    if tokenizer is None:
        smoke.append("placeholder prompt ids + offset vocab mapping (no tokenizer)")
    return LoadedModel(name="anole", engine=eng, params=params, sample_fn=sample_fn,
                       extras=_mark_smoke(extras, "anole", smoke))


def load_llamagen(
    gpt_ckpt: Optional[str] = None,
    vq_ckpt: Optional[str] = None,
    *,
    name: str = "GPT-XL",
    latent_size: int = 16,
    model_type: str = "c2i",
    cls_token_num: Optional[int] = None,
    window: int = 16,
    guidance_scale: float = 7.5,
    image_top_k: int = 1000,
    scheme: str = "speculative_jacobi",
    init: str = "random",
    t5_dir: Optional[str] = None,  # the T5 encoder's config.json and shards
    t5_tokenizer=None,  # the T5 tokenizer (t5.T5Embedder): needed for t2i prompts
    quantize=False,  # True/8: W8A16; 4/"int4": W4A16 + int8 head; "w4a8": W4A8
    embed_bits: Optional[int] = None,  # 8: the int8 per-row embedding table
    model_cfg=None,  # DecoderConfig override; rope_2d_grid_side must be latent_size
    vq_cfg=None,  # VQConfig override
    device=None,
) -> LoadedModel:
    """LlamaGen (sjd_tpu/loader.py:load_llamagen): class-conditional
    (``model_type="c2i"``, a class id as the prompt, one condition row) or
    text-conditional (``"t2i"``, a caption through T5 into 120 condition
    rows). The GPT and its condition embedder come from ``gpt_ckpt``
    (gpt-fast naming) or are random (seeds 0 and 1), the VQ-16 decoder from
    ``vq_ckpt`` (LlamaGen naming) or random (seed 2), the T5 encoder from
    ``t5_dir`` or random (seed 3, flan-t5-xl's widths) once
    ``t5_tokenizer`` is given.
    ``sample_fn(prompt)`` -> uint8 [16 latent_size, 16 latent_size, 3];
    ``embed_prompt_fn(prompt)`` -> the prompt's (cond, uncond, mask) rows,
    the serving seam for ``StreamingBatcher(embed_dim=...)``."""
    from .models.llamagen import (
        embed_caption, embed_class, embed_uncond_caption, embed_uncond_class,
        init_cond_params, llamagen_engine)
    from .models.vq import LLAMAGEN_VQ16, decode as vq_decode, init_vq_params, port_vqgan

    if model_type not in ("c2i", "t2i"):
        raise ValueError(f"model_type {model_type!r}: expected 'c2i' or 't2i'")
    if t5_dir and t5_tokenizer is None:
        raise ValueError("t5_dir needs t5_tokenizer: the port reads no sentencepiece model")
    dev = resolve_device(device)
    if cls_token_num is None:
        cls_token_num = 1 if model_type == "c2i" else 120
    eng = llamagen_engine(name=name, latent_size=latent_size, cls_token_num=cls_token_num,
                          window=window, guidance_scale=guidance_scale,
                          image_top_k=image_top_k, scheme=scheme, init=init,
                          act_quant=_act_quant_of(quantize), model_cfg=model_cfg, device=dev)
    cfg = eng.model_cfg
    t5 = None
    if model_type == "t2i" and t5_tokenizer is not None:
        from .models.t5 import T5Embedder

        t5 = T5Embedder(t5_dir, t5_tokenizer, max_length=cls_token_num, device=dev)
    if gpt_ckpt:
        from .utils.port import load_torch_checkpoint, port_llamagen

        params, cond = port_llamagen(load_torch_checkpoint(gpt_ckpt), cfg, device=dev)
        params = quantize_ported_params(params, cfg, quantize, embed_bits)
    else:
        params = _build_decoder_params(cfg, None, quantize, embed_bits, dev)
        cond = init_cond_params(1, cfg, model_type=model_type, device=dev,
                                caption_dim=t5.config.d_model if t5 is not None else 2048)
    vq_cfg = vq_cfg if vq_cfg is not None else LLAMAGEN_VQ16
    if vq_ckpt:
        from .utils.port import load_torch_checkpoint

        vq_params = port_vqgan(load_torch_checkpoint(vq_ckpt), vq_cfg, style="llamagen",
                               device=dev)
    else:
        vq_params = init_vq_params(2, vq_cfg, device=dev)
    extras: dict = {"vq_params": vq_params, "vq_cfg": vq_cfg, "cond": cond, "t5": t5,
                    "prompt_width": cls_token_num, "embed_dim": cfg.hidden_size,
                    "last_result": None, "quantize": quantize}

    def embed_prompt_fn(prompt):
        """A class id (c2i) or a caption (t2i) -> (prompt_embeds [1, P, d],
        neg_prompt_embeds [1, P, d], prompt_mask [1, P] or None). A
        caption's left-padded rows are masked out of the cond half."""
        if model_type == "c2i":
            label = torch.tensor([int(prompt)], device=dev)
            return (embed_class(cond, label, cfg.dtype), embed_uncond_class(cond, 1, cfg.dtype),
                    None)
        if t5 is None:
            raise ValueError("t2i prompts need the T5 encoder: pass t5_tokenizer (and t5_dir)")
        feats, mask = t5.get_text_embeddings([str(prompt)])
        return (embed_caption(cond, torch.from_numpy(feats).to(dev), cfg.dtype),
                embed_uncond_caption(cond, 1, cfg.dtype),
                torch.as_tensor(mask, dtype=torch.bool, device=dev))

    def decode_image_fn(toks) -> np.ndarray:
        """A token row (the prompt's placeholder rows, then the image) ->
        uint8 image."""
        ids = torch.as_tensor([int(t) for t in toks[cls_token_num:
                                                     cls_token_num + latent_size ** 2]],
                              device=dev)[None]
        with torch.no_grad():
            pixels = vq_decode(vq_params, vq_cfg, ids, (latent_size, latent_size))
        return pixels_to_uint8(pixels[0])

    def sample_fn(prompt, rng_seed: int = 42) -> np.ndarray:
        pe, ne, mask = embed_prompt_fn(prompt)
        res = eng.generate(params, rng_seed, prompt_embeds=pe, neg_prompt_embeds=ne,
                           prompt_mask=mask)
        extras["last_result"] = res
        return decode_image_fn(res.tokens[0, : int(res.length[0])].tolist())

    extras.update(embed_prompt_fn=embed_prompt_fn, decode_image_fn=decode_image_fn)
    smoke = []
    if not gpt_ckpt:
        smoke.append("random GPT weights (no gpt_ckpt)")
    if not vq_ckpt:
        smoke.append("random VQ decoder (no vq_ckpt)")
    if model_type == "t2i" and t5 is None:
        smoke.append("no T5 encoder (t2i prompts unusable until t5_tokenizer given)")
    elif model_type == "t2i" and not t5_dir:
        smoke.append("random T5 encoder (no t5_dir)")
    return LoadedModel(name=f"llamagen-{name}", engine=eng, params=params,
                       sample_fn=sample_fn,
                       extras=_mark_smoke(extras, f"llamagen-{name}", smoke))


_REGISTRY = {
    "lumina_mgpt": load_lumina_mgpt,
    "anole": load_anole,
    "emu3": load_emu3,
    "llamagen": load_llamagen,
}


def load_pretrained_model(model_name: str, **kwargs) -> LoadedModel:
    """Dispatch on a substring of the name (the JAX registry's)."""
    for key, fn in _REGISTRY.items():
        if key in model_name.lower():
            return fn(**kwargs)
    raise ValueError(f"unknown model {model_name!r}; known: {list(_REGISTRY)}")
