"""Model loading (sjd_tpu/loader.py): ``load_lumina_mgpt`` on its
random-weight path.

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
    model_cfg=None,  # DecoderConfig override; must keep the FlexAR vocab layout
    vq_cfg=None,  # VQConfig override
    device=None,
) -> LoadedModel:
    if ckpt_dir or vq_ckpt:
        raise NotImplementedError("checkpoint porting is not ported yet")
    from .data.item_processor import image_grid_from_block, size_token_id, split_generation
    from .data.vocab_translation import identity_mapping
    from .models.chameleon import IMAGE_END_ID, IMAGE_START_ID, lumina_engine
    from .models.transformer import init_params
    from .models.vq import CHAMELEON_VQ, decode as vq_decode, init_vq_params

    dev = resolve_device(device)
    eng = lumina_engine(size=size, target_size=target_size, window=window,
                        guidance_scale=guidance_scale, image_top_k=image_top_k,
                        scheme=scheme, init=init, model_cfg=model_cfg, device=dev)
    params = init_params(0, eng.model_cfg, device=dev)
    vq_cfg = vq_cfg if vq_cfg is not None else CHAMELEON_VQ
    vq_params = init_vq_params(1, vq_cfg, device=dev)
    mapping = identity_mapping(vq_cfg.n_embed, 4)
    extras: dict = {"vq_params": vq_params, "vq_cfg": vq_cfg, "mapping": mapping,
                    "last_result": None}

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
