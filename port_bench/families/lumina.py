"""Lumina-mGPT (Chameleon backbone): CFG by masking the prompt down to its
last token, the ``lumina`` grammar, the taming VQ decoder (16x)."""

from __future__ import annotations

import dataclasses

import torch

from .. import weights


def engine_config(cfg: dict, mix: dict, h: int, w: int):
    """The Lumina loader's engine (``chameleon.lumina_engine``), stopping at
    <image_end>."""
    from sjd_tpu_torch.core.engine import EngineConfig
    from sjd_tpu_torch.models.chameleon import jacobi_interval_r

    srv = cfg["serving"]
    g = mix["image_px"] // 16
    return EngineConfig(window=mix["window"], interval_l=1,
                        interval_r=jacobi_interval_r(mix["image_px"]),
                        scheme="speculative_jacobi", init=mix["init"],
                        max_len=g * (g + 1) + 64, eos_id=srv["stop_id"],
                        pad_id=srv["pad_id"], cfg_mode=srv["cfg_mode"])


def gstate_fn(cfg, h, w, device):
    """Lumina's grammar reads the grid from the prompt's header."""
    return None


def vq_config(cfg: dict):
    from sjd_tpu_torch.models.vq.taming import VQConfig

    vq = cfg["serving"]["vq"]
    return VQConfig(ch=vq["ch"], ch_mult=tuple(vq["ch_mult"]),
                    num_res_blocks=vq["num_res_blocks"], z_channels=vq["z_channels"],
                    embed_dim=vq["embed_dim"], n_embed=vq["n_embed"], out_ch=vq["out_ch"])


def image_decoder(cfg: dict, mix: dict, device, dtype=None):
    """decode(prompt, gen) -> uint8 [H, W, 3], as the Lumina loader's
    ``decode_image_fn`` decodes: the last image span through the
    offset-only vocabulary mapping, ``taming.decode``, ``pixels_to_uint8``.
    ``dtype``: the VQ's arithmetic (None: float32, the loader's default)."""
    from sjd_tpu_torch.data.item_processor import image_grid_from_block, split_generation
    from sjd_tpu_torch.data.vocab_translation import identity_mapping
    from sjd_tpu_torch.loader import pixels_to_uint8
    from sjd_tpu_torch.models.vq.taming import decode

    vq = cfg["serving"]["vq"]
    vcfg = vq_config(cfg)
    tree = weights.taming_decoder_tree(vq, weights.seed_of(cfg), device)
    if dtype is not None:
        vcfg = dataclasses.replace(vcfg, dtype=dtype)
        tree = _cast(tree, dtype)
        tree["codebook"] = tree["codebook"].to(dtype)
    mapping = identity_mapping(vq["n_embed"], vq["token_offset"])
    end_id = cfg["serving"]["grammar"]["image_end_id"]

    def decode_image(prompt, gen):
        spans = [s for k, s in split_generation(list(prompt) + list(gen)) if k == "image"]
        span = spans[-1]
        grid = image_grid_from_block(span[:-1] if span[-1] == end_id else span,
                                     mapping=mapping)
        ids = torch.as_tensor(grid.reshape(1, -1), device=device)
        with torch.no_grad():
            pixels = decode(tree, vcfg, ids, grid.shape)
        return pixels_to_uint8(pixels[0])

    return decode_image


def _cast(t, dtype):
    if isinstance(t, dict):
        return {k: _cast(v, dtype) for k, v in t.items()}
    if isinstance(t, list):
        return [_cast(v, dtype) for v in t]
    return t.to(dtype) if t.is_floating_point() else t
