"""Device-memory read ceiling against the quantized products
(examples/hbm_bw_probe.py).

The 7B's decode step reads ~1.6 GB of packed int4 projections and a
0.27 GB int8 head every forward (W4A16). This probe measures on the card:

  stream_bf16_gbps  the read ceiling: ``torch.sum`` over a 3.2 GB bf16
                    buffer, accumulated in f32 in the one pass
  stream_s4_gbps    the packed int4 bytes of the 7B's projection mass
                    (BLOCKS x [8192, 4096] codes, 1.6 GB), read once by the
                    same reduction, the bytes taken as bf16 pairs: PyTorch
                    sums integers through a float copy of the whole buffer,
                    and eager PyTorch has no fused unpack-and-reduce, so
                    this is the bytes' read without the unpack (the unpack
                    is K1's, in dot_s4)
  dot_s4_gbps       the production pattern: K1 (``ops.quant_linear_a16``)
                    at M = 32 over the same BLOCKS packed [8192, 4096]
                    weights, one launch each
  stream_s8_*, dot_s8_*  the same with int8 weights (half the blocks, so
                    the same bytes)

The gap between ``stream_*`` and ``dot_s4`` is what K1 leaves of the
ceiling. Each probe is one CUDA graph of the whole pass, replayed; rates
are the weights' bytes over the time. Prints one JSON object with the JAX
script's keys. Run it alone on the card:

    python -m sjd_tpu_torch.examples.hbm_bw_probe [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import resolve_device
from ..eval.latency import seconds_per_call
from ..ops.quant_linear import quant_linear_a16

BLOCKS = 96  # 96 x 4096 x 8192 = 3.2e9 weights
K, N = 4096, 8192
M = 32  # rows of the activations: CFG batch 2 x window 16
ITERS = 10


def _rates(out: dict, key: str, ms_key: str, nbytes: int, seconds: float) -> None:
    out[f"{key}_gbps"] = nbytes / seconds / 1e9
    out[ms_key] = seconds * 1e3


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    out: dict = {}

    wb = torch.randn((BLOCKS, K, K), generator=gen, dtype=torch.bfloat16, device=dev)
    t = seconds_per_call(lambda: acc.add_(torch.sum(wb, dtype=torch.float32) * 1e-9),
                         dev, ITERS)
    _rates(out, "stream_bf16", "stream_bf16_ms", wb.numel() * 2, t)
    del wb

    x0 = torch.ones((M, K), dtype=torch.bfloat16, device=dev)

    def dot(w, s, bits):
        def run():
            for b in range(w.shape[0]):
                quant_linear_a16(x0, w[b], s[b], bits=bits)
        return run

    w4 = torch.randint(0, 256, (BLOCKS, N, K // 2), generator=gen, dtype=torch.uint8,
                       device=dev)
    t = seconds_per_call(
        lambda: acc.add_(torch.sum(w4.view(torch.bfloat16), dtype=torch.float32) * 1e-9),
        dev, ITERS)
    _rates(out, "stream_s4", "stream_s4_ms", w4.numel(), t)
    s4 = torch.ones((BLOCKS, N), dtype=torch.bfloat16, device=dev)
    _rates(out, "dot_s4", "dot_s4_ms", w4.numel(), seconds_per_call(dot(w4, s4, 4), dev, ITERS))
    del w4, s4

    w8 = torch.randint(-127, 128, (max(BLOCKS // 2, 1), N, K), generator=gen,
                       dtype=torch.int8, device=dev)
    t = seconds_per_call(
        lambda: acc.add_(torch.sum(w8.view(torch.bfloat16), dtype=torch.float32) * 1e-9),
        dev, ITERS)
    _rates(out, "stream_s8", "stream_s8_ms_half", w8.numel(), t)
    s8 = torch.ones(w8.shape[:2], dtype=torch.bfloat16, device=dev)
    _rates(out, "dot_s8", "dot_s8_ms_half", w8.numel(),
           seconds_per_call(dot(w8, s8, 8), dev, ITERS))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
