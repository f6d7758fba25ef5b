"""Fine-tuning command line (examples/finetune.py of the JAX package).

Record JSONs through the fine-tuning dataset and the length-clustered
sampler with mid-epoch resume, the sharded train step (CE + z-loss, AdamW
with cosine warmup, clipping and accumulation), metric logging and
checkpoints pruned to ``--max-keep``.

    python -m sjd_tpu_torch.parallel.finetune --synthetic --steps 20 --batch-size 4
    torchrun --nproc-per-node 4 -m sjd_tpu_torch.parallel.finetune --tp 2 ...

One process runs on one device (``--device``, default ``cuda``) without
``torchrun``; under ``torchrun`` the mesh is (ranks / tp) x tp.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--meta-path", default=None, help="dataset meta JSON/YAML")
    ap.add_argument("--synthetic", action="store_true",
                    help="random tiny model + synthetic batches (smoke test)")
    ap.add_argument("--model", default="tiny", choices=["tiny", "chameleon-7B"])
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=512)
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--wd", type=float, default=0.1)
    ap.add_argument("--z-loss", type=float, default=1e-5)
    ap.add_argument("--grad-clip", type=float, default=1.0)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="./ckpt_out")
    ap.add_argument("--save-interval", type=int, default=500)
    ap.add_argument("--max-keep", type=int, default=2)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mask-image-logits", action="store_true",
                    help="disallow Chameleon image-token logits in the loss "
                         "(text-only finetuning; reference solver flag)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def model_config(name: str, max_seq_len: int):
    import torch

    from ..models.chameleon import chameleon_config
    from ..models.transformer import DecoderConfig

    if name == "tiny":
        return DecoderConfig(
            vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=4,
            num_heads=4, num_kv_heads=4, head_dim=32, qk_norm=True, dtype=torch.float32,
            max_position_embeddings=max_seq_len)
    return chameleon_config("7B")


def batches(args: argparse.Namespace, vocab_size: int, start_step: int = 0):
    """(ids, labels, mask) numpy batches: synthetic ones (64 tokens, the
    first 8 unlabelled) from ``RandomState(seed)``, or the dataset's.

    On resume the dataset's stream skips ``start_step % steps_per_epoch``
    sampler iterations, and the sampler skips ``batch_size * grad_accum``
    items for each: with accumulation that is ``grad_accum`` times the
    micro-batches the run consumed (the JAX command line's skip, kept)."""
    import numpy as np

    if args.synthetic or not args.meta_path:
        rs = np.random.RandomState(args.seed)
        while True:
            ids = rs.randint(0, vocab_size, (args.batch_size, 64)).astype(np.int32)
            labels = ids.copy()
            labels[:, :8] = -100
            yield ids, labels, np.ones_like(ids, bool)
    from ..data.dataset import FinetuneDataset, pad_batch
    from ..data.sampler import LengthClusteredSampler

    ds = FinetuneDataset(args.meta_path)
    sampler = LengthClusteredSampler(
        ds.lengths(), batch_size=args.batch_size, grad_accum=args.grad_accum,
        seed=args.seed, groups=ds.types or None, group_ratios=ds.ratios or None)
    steps_per_epoch = max(len(sampler) // args.batch_size, 1)
    epoch = start_step // steps_per_epoch
    start_iter = start_step % steps_per_epoch
    while True:
        sampler.set_epoch(epoch, start_iter)
        start_iter = 0
        buf = []
        for idx in sampler:
            buf.append(ds[idx])
            if len(buf) == args.batch_size:
                yield pad_batch(buf, max_len=args.max_seq_len)
                buf = []
        epoch += 1


def main(argv=None) -> None:
    args = parse_args(argv)

    import numpy as np
    import torch

    from .. import resolve_device
    from ..utils import checkpoints as ckpt_lib
    from ..utils.logging import MetricLogger, set_logger
    from .dist import init_distributed, is_main_process
    from .mesh import make_mesh
    from .training import TrainConfig, make_train_step

    logger = set_logger(os.path.join(args.ckpt_dir, "train.log")
                        if os.path.isdir(args.ckpt_dir) else None)
    info = init_distributed(device=args.device)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and info["process_count"] > 1:
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = model_config(args.model, args.max_seq_len)
    mesh = make_mesh(data=info["global_devices"] // args.tp, model=args.tp, device=dev)
    tcfg = TrainConfig(
        learning_rate=args.lr, weight_decay=args.wd, z_loss_weight=args.z_loss,
        grad_clip=args.grad_clip, grad_accum=args.grad_accum,
        warmup_steps=args.warmup, total_steps=args.steps,
        mask_image_logits=args.mask_image_logits)
    init_fn, step_fn = make_train_step(mesh, cfg, tcfg, tp=args.tp > 1, fsdp=True, device=dev)
    manager = ckpt_lib.make_manager(args.ckpt_dir, max_keep=args.max_keep)

    state = init_fn(args.seed)
    if args.resume:
        try:
            state = ckpt_lib.restore(manager, state)
            logger.info(f"resumed at step {state.step}")
        except FileNotFoundError:
            logger.info("no checkpoint found; starting fresh")

    metrics_log = MetricLogger()
    start = state.step
    gen = batches(args, cfg.vocab_size, start)
    t0 = time.time()
    loss = float("nan")
    for step in range(start, args.steps):
        ids, labels, mask = (torch.from_numpy(x) for x in next(gen))
        state, metrics = step_fn(state, ids, labels, mask)
        loss = float(metrics["loss"])
        if not np.isfinite(loss):  # non-finite loss kill switch
            raise RuntimeError(f"non-finite loss at step {step}: {loss}")
        metrics_log.update(loss=loss, ce=float(metrics["ce"]),
                           grad_norm=float(metrics["grad_norm"]))
        if step % args.log_every == 0 and is_main_process():
            rate = (step - start + 1) / (time.time() - t0)
            logger.info(f"step {step} {metrics_log} ({rate:.2f} it/s)")
        if args.save_interval and (step + 1) % args.save_interval == 0:
            ckpt_lib.save(manager, step + 1, state)
            logger.info(f"saved checkpoint @ {step + 1}")

    ckpt_lib.save(manager, args.steps, state)
    if is_main_process():
        logger.info(json.dumps({"final_loss": loss, "steps": args.steps}))


if __name__ == "__main__":
    main()
