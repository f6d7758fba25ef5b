"""Model loading (sjd_tpu/loader.py): ``load_lumina_mgpt``.

The decoder comes from a checkpoint directory (``ckpt_dir``: sharded
``.safetensors``, ``pytorch_model*.bin``, ``.pt`` or ``.pth``, HF naming)
and the VQGAN from one file (``vq_ckpt``, taming naming), read by
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
        images or [H, W, 3] arrays in [-1, 1]) -> the image it generates."""
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
