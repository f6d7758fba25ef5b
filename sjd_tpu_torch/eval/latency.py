"""Component latency probes (sjd_tpu/eval/latency.py): the window forward
timed under configuration ablations, which attributes a decode step's time
to the layers and to the logits head.

On CUDA each variant's forward is captured once as a CUDA graph (after one
eager call, which also sizes the quantized products' counters outside the
capture) and replayed, the counterpart of the JAX version's ``jax.jit``;
each timing ends in ``torch.cuda.synchronize()``. On the CPU the forward
runs eagerly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from .. import resolve_device


def default_variants(model_cfg) -> Dict[str, dict]:
    """The full model, half the layers (the per-layer cost) and an
    8192-row head (the logits head's cost)."""
    return {
        "full": {},
        "half_layers": {"num_layers": max(model_cfg.num_layers // 2, 1)},
        "small_head": {"vocab_size": 8192},
    }


def seconds_per_call(fn: Callable[[], object], dev: torch.device, iters: int) -> float:
    """Seconds per call of ``fn``: eager on the CPU, a replayed CUDA graph of
    one call on CUDA."""
    if dev.type != "cuda":
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(device=dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        fn()
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        graph.replay()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / iters


def decode_step_latencies(
    model_cfg,
    params,
    *,
    batch: int = 2,
    window: int = 16,
    buf_len: int = 2500,
    cache_fill: int = 1200,
    iters: int = 20,
    variants: Optional[Dict[str, dict]] = None,
    params_fn: Optional[Callable] = None,
    device=None,
) -> Dict[str, float]:
    """Seconds per window forward for each variant (``default_variants``
    when None): a config override of ``model_cfg``. An overridden config
    gets ``params_fn(cfg)``, by default fresh random parameters (seed 0) on
    ``device``; ``params`` (on ``device``) serve the variant without
    overrides."""
    from ..models import decoder_model_fns, init_params

    dev = resolve_device(device)
    if params_fn is None:
        params_fn = lambda c: init_params(0, c, device=dev)  # noqa: E731
    if variants is None:
        variants = default_variants(model_cfg)
    ids = torch.zeros((batch, window), dtype=torch.int32, device=dev)
    pos = torch.arange(window, dtype=torch.int32, device=dev)[None].repeat(batch, 1)
    valid = torch.ones((batch, buf_len), dtype=torch.bool, device=dev)
    ce = torch.full((batch,), cache_fill, dtype=torch.int32, device=dev)

    results = {}
    with torch.no_grad():
        for name, overrides in variants.items():
            cfg = dataclasses.replace(model_cfg, **overrides)
            p = params_fn(cfg) if overrides else params
            model = decoder_model_fns(cfg, max_positions=buf_len + window + 8, device=dev)
            kv = model.init_cache(batch, buf_len)
            results[name] = seconds_per_call(
                lambda: model.forward(p, ids, pos, kv, ce, valid)[0], dev, iters)
            del p, kv
    return results
