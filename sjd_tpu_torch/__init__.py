"""sjd_tpu_torch: the PyTorch/CUDA port of sjd_tpu (Speculative Jacobi
Decoding for autoregressive text-to-image), for one NVIDIA H100.

The layout mirrors ``sjd_tpu/``: ``core/`` (engine, sampling, grammar,
acceptance, batching), ``models/`` (decoder, Chameleon/Lumina family, VQ
encoder and decoder), ``ops/`` (the hand-written Hopper kernels, sources in
``csrc/``), ``data/`` (prompting, the fine-tuning dataset, sampler and
pre-tokenization), ``eval/``, ``parallel/`` (meshes, sharding rules, the
train step, the fine-tuning command line), ``utils/`` (checkpoint reading
and porting, training checkpoints, tokenizer, profiling, logging) and
``loader.py``. ``convert.py`` turns the JAX package's parameters into
this package's. Nothing here imports JAX or ``sjd_tpu``.

Entry points take ``device=`` and default to ``"cuda"``; they raise when
CUDA is absent unless the caller asks for the CPU, and never fall back to
it on their own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. A CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
