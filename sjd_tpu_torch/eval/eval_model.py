"""Benchmark evaluation from the command line (examples/eval_model.py's
counterpart): shard a prompt set contiguously across (node, worker),
generate ``{index}.png`` per prompt with the skip-existing resume, and
optionally score the directory with FID and IS. Several nodes pass
``--node-id``/``--num-nodes`` and need no communication.

    python -m sjd_tpu_torch.eval.eval_model --dataset parti \\
        --dataset-path PartiPrompts.tsv [--slots 4] [--quantize 4] \\
        [--fid-reference-dir DIR --inception-ckpt pt_inception.pth] [--device cuda]

Prints the harness's stats as one JSON line and, with
``--fid-reference-dir``, the scores as another.
"""

from __future__ import annotations

import argparse
import json
import os

from ..loader import load_pretrained_model


def main(argv=None) -> None:
    from . import create_dataset, run_prompt_set, shard_prompts, workdir_name

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="lumina_mgpt")
    ap.add_argument("--dataset", default="parti", choices=["parti", "coco"])
    ap.add_argument("--dataset-path", required=True)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--node-id", type=int, default=0)
    ap.add_argument("--num-nodes", type=int, default=1)
    ap.add_argument("--worker-id", type=int, default=0)
    ap.add_argument("--num-workers", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--vq-ckpt", default=None)
    ap.add_argument("--target-size", type=int, default=768)
    ap.add_argument("--gpt-model", default="GPT-XL")
    ap.add_argument("--latent-size", type=int, default=16)
    ap.add_argument("--quantize", nargs="?", const="8", default=None,
                    choices=["4", "8", "w4a8"],
                    help="quantized weights: 8 = int8 W8A16, 4 = int4 W4A16 "
                         "(equilibrated per channel), w4a8 = int4 weights with int8 "
                         "activations")
    ap.add_argument("--slots", type=int, default=0,
                    help="stream the shard through N engine slots "
                         "(run_prompt_set_batched); the scores' statistics are "
                         "unaffected, the exact images depend on each record's seed")
    ap.add_argument("--chunk-steps", type=int, default=192)
    ap.add_argument("--no-quantize", action="store_true",
                    help="bf16 weights, whatever the family's default")
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--cfg", type=float, default=3.0)
    ap.add_argument("--image-top-k", type=int, default=2000)
    ap.add_argument("--scheme", default="speculative_jacobi")
    ap.add_argument("--init", default="random")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--max-prompts", type=int, default=0)
    ap.add_argument("--fid-reference-dir", default=None)
    ap.add_argument("--inception-ckpt", default=None,
                    help="torch InceptionV3 checkpoint (torchvision or pytorch_fid FID "
                         "weights) for FID through eval/inception.py")
    ap.add_argument("--smoke-extractor", action="store_true",
                    help="score with the checkpoint-free pixel-statistic extractors "
                         "(a pipeline smoke only, not comparable with Inception FID)")
    ap.add_argument("--device", default="cuda",
                    help="the device that generates and scores (cpu only when asked)")
    args = ap.parse_args(argv)

    records = create_dataset(args.dataset, args.dataset_path)
    if args.max_prompts:
        records = records[: args.max_prompts]
    shard = shard_prompts(records, node_id=args.node_id, num_nodes=args.num_nodes,
                          worker_id=args.worker_id, num_workers=args.num_workers)
    workdir = args.workdir or workdir_name(
        args.model, ds=args.dataset, size=args.target_size, window=args.window,
        cfg=args.cfg, topk=args.image_top_k, scheme=args.scheme, init=args.init,
        seed=args.seed)
    print(f"{len(shard)}/{len(records)} prompts -> {workdir}")

    # the family's loader arguments (examples/eval_model.py's mapping)
    common = dict(window=args.window, guidance_scale=args.cfg,
                  image_top_k=args.image_top_k, scheme=args.scheme, init=args.init,
                  device=args.device)
    quantize = False if args.no_quantize else (
        (args.quantize if args.quantize == "w4a8" else int(args.quantize))
        if args.quantize else False)
    if "llamagen" in args.model:
        kwargs = dict(gpt_ckpt=args.ckpt_dir, vq_ckpt=args.vq_ckpt, name=args.gpt_model,
                      latent_size=args.latent_size, quantize=quantize, **common)
    elif "emu3" in args.model:
        # the 8B is quantized by default, unless the flags say otherwise
        kwargs = dict(ckpt_dir=args.ckpt_dir, **common)
        if args.quantize or args.no_quantize:
            kwargs["quantize"] = quantize
    elif "anole" in args.model:
        kwargs = dict(ckpt_dir=args.ckpt_dir, quantize=quantize, **common)
    else:  # lumina
        kwargs = dict(ckpt_dir=args.ckpt_dir, vq_ckpt=args.vq_ckpt,
                      target_size=args.target_size, seed=args.seed, quantize=quantize,
                      **common)
    model = load_pretrained_model(args.model, **kwargs)
    stats_path = os.path.join(workdir, f"stats_n{args.node_id}_w{args.worker_id}.json")
    if args.slots > 1:
        from .harness import run_prompt_set_batched

        stats = run_prompt_set_batched(model, shard, workdir, slots=args.slots,
                                       chunk_steps=args.chunk_steps, stats_path=stats_path)
    else:
        stats = run_prompt_set(model.sample_fn, shard, workdir, stats_path=stats_path)
    print(json.dumps(stats))

    if args.fid_reference_dir:
        from .metrics import (
            evaluate_quantitative_scores, make_inception_extractor, make_pixel_extractor,
            make_pixel_probs)

        if args.inception_ckpt:
            from .inception import make_inception_extractor_from_ckpt

            kw = dict(feature_fn=make_inception_extractor_from_ckpt(
                args.inception_ckpt, device=args.device))
        elif args.smoke_extractor:
            kw = dict(feature_fn=make_pixel_extractor(), probs_fn=make_pixel_probs())
        else:
            kw = dict(feature_fn=make_inception_extractor(device=args.device))
        scores = evaluate_quantitative_scores(workdir, args.fid_reference_dir, **kw)
        print(json.dumps(scores))


if __name__ == "__main__":
    main()
