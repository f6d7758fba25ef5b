"""Emu3-Gen: CFG against a negative prompt, the positional ``emu3``
grammar armed by the prompt's <image token>, its grid known up front.
Its cells decode no image inside the window (a 720px request outlasts it),
so no VQ decoder is built."""

from __future__ import annotations


def engine_config(cfg: dict, mix: dict, h: int, w: int):
    """The Emu3 loader's engine (``emu3.emu3_engine``)."""
    from sjd_tpu_torch.core.engine import EngineConfig

    srv = cfg["serving"]
    return EngineConfig(window=mix["window"], interval_l=1, interval_r=h * (w + 1) - 1,
                        scheme="speculative_jacobi", init=mix["init"],
                        max_len=h * (w + 1) + 128, eos_id=srv["stop_id"],
                        pad_id=srv["pad_id"], cfg_mode=srv["cfg_mode"])


def gstate_fn(cfg, h, w, device):
    from sjd_tpu_torch.models.emu3 import emu3_grammar_state

    return lambda batch: emu3_grammar_state(batch, h, w, device=device)


def image_decoder(cfg, mix, device, dtype=None):
    raise ValueError("the emu3 configuration builds no image decoder")
