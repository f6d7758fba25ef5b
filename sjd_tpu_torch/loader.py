"""Model loading (sjd_tpu/loader.py): ``load_lumina_mgpt`` on its
random-weight path, in bf16 or with quantized weights (``quantize=``,
``embed_bits=``).

Without checkpoints the decoder and the VQ decoder get random weights from
fixed seeds and the prompt ids are placeholders, so every stage (prompting,
SJD decoding with grammar, VQ detokenization) runs for real but the images
are noise; ``extras["smoke"]`` and ``extras["smoke_reasons"]`` say so.
Checkpoint porting and tokenizer-backed prompting are not ported yet.
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


def _build_decoder_params(model_cfg, quantize, embed_bits, device):
    """Random decoder weights (seed 0), quantized as they are drawn when
    ``quantize``: False = bf16; True or 8 = int8 projections (W8A16); 4,
    "int4" = packed int4 projections with an int8 head (W4A16); "w4a8" =
    the same weights for int8 activations. As the JAX loader does on random
    weights, no equilibration (a no-op without outlier columns; its folds
    would need every bf16 weight at once). Each stacked bf16 weight is
    quantized and released before the next is drawn, so at most one (the
    largest, w_gate: 2.9 GB for the 7B) is live beside the quantized tree;
    the draws equal the bf16 load's."""
    from .models.transformer import init_params, quantize_leaf

    if quantize not in _QUANT_OPTS:
        raise ValueError(f"quantize={quantize!r}: expected one of {_QUANT_OPTS}")
    if embed_bits and not quantize:
        raise ValueError("embed_bits needs quantize")
    if not quantize:
        return init_params(0, model_cfg, device=device)
    bits = 4 if quantize in _INT4_OPTS else 8
    if embed_bits not in (None, 8):
        raise ValueError("embedding quantization supports int8 only")
    if embed_bits and model_cfg.tie_word_embeddings:
        raise ValueError("embed_bits requires untied embeddings")

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
    quantize=False,  # True/8: W8A16; 4/"int4": W4A16 + int8 head; "w4a8": W4A8
    embed_bits: Optional[int] = None,  # 8: the int8 per-row embedding table
    model_cfg=None,  # DecoderConfig override; must keep the FlexAR vocab layout
    vq_cfg=None,  # VQConfig override
    device=None,
) -> LoadedModel:
    if ckpt_dir or vq_ckpt:
        raise NotImplementedError("checkpoint porting is not ported yet")
    from .data.item_processor import image_grid_from_block, size_token_id, split_generation
    from .data.vocab_translation import identity_mapping
    from .models.chameleon import IMAGE_END_ID, IMAGE_START_ID, lumina_engine
    from .models.vq import CHAMELEON_VQ, decode as vq_decode, init_vq_params

    dev = resolve_device(device)
    eng = lumina_engine(size=size, target_size=target_size, window=window,
                        guidance_scale=guidance_scale, image_top_k=image_top_k,
                        scheme=scheme, init=init, act_quant=_act_quant_of(quantize),
                        model_cfg=model_cfg, device=dev)
    params = _build_decoder_params(eng.model_cfg, quantize, embed_bits, dev)
    vq_cfg = vq_cfg if vq_cfg is not None else CHAMELEON_VQ
    vq_params = init_vq_params(1, vq_cfg, device=dev)
    mapping = identity_mapping(vq_cfg.n_embed, 4)
    extras: dict = {"vq_params": vq_params, "vq_cfg": vq_cfg, "mapping": mapping,
                    "last_result": None, "quantize": quantize, "embed_bits": embed_bits}

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
        """Placeholder text ids (no tokenizer) + the image header. The ids
        come from a stable hash of the prompt (the JAX loader uses Python's
        per-process ``hash``)."""
        h = zlib.crc32(prompt.encode())
        ids = [(h >> (4 * i)) % 4000 + 9000 for i in range(12)]
        return ids + [IMAGE_START_ID, size_token_id(target_size),
                      size_token_id(target_size)]

    def sample_fn(prompt: str, rng_seed: Optional[int] = None) -> np.ndarray:
        ids = torch.as_tensor([prompt_ids_fn(prompt)], dtype=torch.int32, device=dev)
        res = eng.generate(params, seed if rng_seed is None else rng_seed, ids)
        extras["last_result"] = res
        toks = res.tokens[0, : int(res.length[0])].tolist()
        return decode_image_fn(toks)

    extras.update(prompt_ids_fn=prompt_ids_fn, decode_image_fn=decode_image_fn)
    smoke = ["random decoder weights (no ckpt_dir)", "random VQ decoder (no vq_ckpt)",
             "placeholder prompt ids (no tokenizer)"]
    return LoadedModel(name="lumina_mgpt", engine=eng, params=params,
                       sample_fn=sample_fn,
                       extras=_mark_smoke(extras, "lumina_mgpt", smoke))
