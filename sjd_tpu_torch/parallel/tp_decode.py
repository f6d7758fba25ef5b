"""Tensor-parallel SJD decode of Chameleon-34B at its real shapes
(examples/tp_decode_34b.py of the JAX package), one process per rank:

    torchrun --nproc-per-node N -m sjd_tpu_torch.parallel.tp_decode \\
        [--max-len 12] [--window 4] [--layers 0] [--tp N] [--backend nccl]

The real config (48 layers, d 8192, 64 query heads over 8 KV heads,
swin-norm, vocab 65536; ``--layers K`` keeps K of the layers at full width)
with seeded random bf16 weights, every rank drawing the same global leaf
and keeping its shard (``parallel.sharding.init_params_sharded``: one
stacked leaf at a time), a bf16 KV cache, and a
greedy, no-CFG 512px generation, each step eager (``cuda_graph=False``: the
step is not captured under a model axis). Rank r uses
``cuda:(LOCAL_RANK % device_count)``; ranks that share one card need
``--backend gloo`` (NCCL refuses two ranks on one device). The mesh is
``(ranks / tp) x tp``.

Rank 0 prints one JSON line: the JAX script's keys (the generated span,
NFE, ``grammar_ok``), whether every rank generated the same tokens, and
each rank's peak device memory, ms per forward and kernel launches.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-len", type=int, default=12)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--tp", type=int, default=0, help="model axis (default: every rank)")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep this many of the 48 layers (0: all); widths, heads, vocab "
                         "and the sharding stay the 34B's")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend (default nccl on CUDA, gloo on the CPU)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    import torch
    import torch.distributed as dist

    from .. import resolve_device
    from ..models.chameleon import IMAGE_START_ID, SIZE_TOKEN_BASE, chameleon_config, \
        lumina_engine
    from ..ops import launch_counts
    from .dist import init_distributed
    from .mesh import make_mesh
    from .sharding import init_params_sharded

    args = parse_args(argv)
    dev = resolve_device(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    init_distributed(device=dev, backend=args.backend)
    tp = args.tp or world
    mesh = make_mesh(data=world // tp, model=tp, device=dev)
    cfg = chameleon_config("34B")
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    eng = lumina_engine(size="34B", target_size=512, window=args.window, max_len=args.max_len,
                        kv_quant=False, guidance_scale=1.0, greedy=True, model_cfg=cfg,
                        cuda_graph=False, device=dev)

    t0 = time.time()
    params = init_params_sharded(0, cfg, mesh, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_init = time.time() - t0

    size_tok = SIZE_TOKEN_BASE + (512 // 16) // 2
    prompt = torch.tensor([list(range(9000, 9008)) + [IMAGE_START_ID, size_tok, size_tok]],
                          device=dev)
    before = launch_counts()
    t0 = time.time()
    res = eng.generate(params, 0, prompt)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_gen = time.time() - t0
    launches = {k: n - before[k] for k, n in launch_counts().items()}
    toks = res.tokens[0, 11:int(res.length[0])].cpu().tolist()
    mine = {"rank": dist.get_rank() if dist.is_initialized() else 0,
            "device": str(dev), "tokens": toks, "launches": launches,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
            "ms_per_forward": 1e3 * t_gen / res.nfe}
    ranks = [mine]
    if dist.is_initialized():
        ranks = [None] * world
        dist.all_gather_object(ranks, mine)
    out = {
        "config": ("Chameleon-34B 48L/8192d/64H-8KV swin-norm (real shapes)"
                   if not args.layers else
                   f"Chameleon-34B width, {args.layers}L (8192d/64H-8KV swin-norm, full "
                   "vocab; per-layer sharding identical to the 48L run)"),
        "tp": tp,
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "param_shards_per_leaf": tp,
        "init_s": round(t_init, 1),
        "generate_s": round(t_gen, 1),
        "nfe": int(res.nfe),
        "generated": toks,
        "grammar_ok": bool(all(4 <= t <= 8195 or t in (8803, 8196) for t in toks)),
        "ranks_equal": all(r["tokens"] == toks for r in ranks),
        "ranks": [{k: v for k, v in r.items() if k != "tokens"} for r in ranks],
    }
    if mine["rank"] == 0:
        print(json.dumps(out), flush=True)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
