"""Benchmark generation runner (sjd_tpu/eval/harness.py): ``{index}.png`` for
every prompt record, existing files skipped, so that a cut run resumes
where it stopped. Several hosts split a prompt set statically
(``datasets.shard_prompts``), with the file system as the only shared
medium.

Images are uint8 arrays (what the loaders' ``sample_fn`` and
``decode_image_fn`` return; a PIL image converts through ``np.asarray``)
and are written with ``utils.image_io.write_png``, atomically.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np

from ..utils.image_io import write_png
from .datasets import PromptRecord


def _write_stats(stats: dict, stats_path: Optional[str]) -> None:
    if stats_path:
        with open(stats_path, "w") as f:
            json.dump(stats, f)


def run_prompt_set(
    sample_fn: Callable[[str], "np.ndarray"],  # prompt -> uint8 [H, W, 3]
    records: Sequence[PromptRecord],
    workdir: str,
    *,
    log_every: int = 1,
    stats_path: Optional[str] = None,
) -> dict:
    """Generate ``{index}.png`` for every record one prompt at a time,
    skipping existing outputs."""
    os.makedirs(workdir, exist_ok=True)
    done = skipped = 0
    latencies = []
    for rec in records:
        out = os.path.join(workdir, f"{rec.index}.png")
        if os.path.exists(out):
            skipped += 1
            continue
        t0 = time.time()
        image = sample_fn(rec.prompt)
        dt = time.time() - t0
        latencies.append(dt)
        write_png(out, np.asarray(image))
        done += 1
        if log_every and done % log_every == 0:
            print(f"[{done}/{len(records)}] {rec.index}: {dt:.1f}s  {rec.prompt[:60]}")
    stats = {
        "generated": done,
        "skipped_existing": skipped,
        "mean_latency_s": sum(latencies) / len(latencies) if latencies else None,
    }
    _write_stats(stats, stats_path)
    return stats


def workdir_name(model_name: str, **hyperparams) -> str:
    """The output directory's name from every hyperparameter, so that two
    configurations never share one."""
    parts = [model_name] + [f"{k}-{v}" for k, v in sorted(hyperparams.items())]
    return "_".join(str(p).replace("/", "-") for p in parts)


def run_prompt_set_batched(
    model,  # a loader's LoadedModel: engine, params and the serving seams in extras
    records: Sequence[PromptRecord],
    workdir: str,
    *,
    slots: int = 4,
    chunk_steps: int = 192,
    log_every: int = 1,
    stats_path: Optional[str] = None,
    seed_base: int = 0,
) -> dict:
    """The pending prompts stream through ``slots`` engine slots of a
    ``core.serving.StreamingBatcher`` instead of one ``sample_fn`` call at a
    time. Each finished slot is decoded and written as it completes, so the
    skip-existing resume holds image by image. Each record is submitted
    with ``seed = seed_base + record.index`` onto its own slot generator, so
    a resumed or re-sharded run makes the same image whatever its
    companions.

    The loader's seams: ``extras["prompt_ids_fn"]`` (with ``"neg_ids_fn"``
    and ``"make_gstate"`` where the family has them, Emu3) or
    ``extras["embed_prompt_fn"]`` (LlamaGen), and ``"decode_image_fn"``.

    No CUDA call is made from this thread while the batcher's drive thread
    may be capturing its decode step (the first decode steps of its first
    batch), as that would break the capture: token prompts are host lists,
    and in embedding mode the first wave's rows are all made, and copied to
    the host, before the first submit. Every later CUDA call here (the
    next rows, the VQ decode) follows a finished request.
    """
    from ..core.serving import StreamingBatcher

    os.makedirs(workdir, exist_ok=True)
    extras = model.extras
    decode = extras["decode_image_fn"]

    pending = []
    skipped = 0
    for rec in records:
        if os.path.exists(os.path.join(workdir, f"{rec.index}.png")):
            skipped += 1
        else:
            pending.append(rec)
    if not pending:
        stats = {"generated": 0, "skipped_existing": skipped, "images_per_min": None}
        _write_stats(stats, stats_path)
        return stats

    embed_mode = "embed_prompt_fn" in extras and "prompt_ids_fn" not in extras
    if embed_mode:
        batcher = StreamingBatcher(
            model.engine, model.params, batch=slots, chunk_steps=chunk_steps,
            prompt_width=extras["prompt_width"], embed_dim=extras["embed_dim"])

        def host_rows(rec):
            pe, ne, pm = extras["embed_prompt_fn"](rec.prompt)
            return (pe[0].cpu(), ne[0].cpu(), pm[0].cpu() if pm is not None else None)

        def submit(rec, rows):
            pe, ne, pm = rows
            return batcher.submit(prompt_embeds=pe, neg_prompt_embeds=ne, prompt_mask=pm,
                                  seed=seed_base + rec.index)

        # submitted lazily in waves: every prompt's conditioning rows at
        # once would hold a whole Parti t2i run's caption embeddings
        def handles_iter():
            wave = 4 * slots
            first = [(rec, host_rows(rec)) for rec in pending[:wave]]
            queue = [submit(rec, rows) for rec, rows in first]
            for rec in pending[wave:]:
                yield queue.pop(0)
                queue.append(submit(rec, host_rows(rec)))
            yield from queue

        handles = handles_iter()
    else:
        prompt_rows = [extras["prompt_ids_fn"](rec.prompt) for rec in pending]
        neg = extras["neg_ids_fn"]() if "neg_ids_fn" in extras else None
        batcher = StreamingBatcher(
            model.engine, model.params, batch=slots, chunk_steps=chunk_steps,
            prompt_width=max(len(r) for r in prompt_rows),
            neg_width=len(neg) if neg is not None else 0,
            make_gstate=extras.get("make_gstate"))
        handles = [batcher.submit(row, neg_prompt_ids=neg, seed=seed_base + rec.index)
                   for rec, row in zip(pending, prompt_rows)]

    t0 = time.time()
    done = 0
    # a failed generation (a wait that raises) still stops the drive thread
    # and records the progress: the resume relies on the images written
    try:
        for rec, handle in zip(pending, handles):
            res = handle.wait()
            write_png(os.path.join(workdir, f"{rec.index}.png"),
                      np.asarray(decode(res.tokens.tolist())))
            done += 1
            if log_every and done % log_every == 0:
                print(f"[{done}/{len(pending)}] {rec.index}: {rec.prompt[:60]}")
    finally:
        batcher.close()
        wall = time.time() - t0
        stats = {
            "generated": done,
            "skipped_existing": skipped,
            "slots": slots,
            "wall_s": round(wall, 2),
            "images_per_min": round(60.0 * done / wall, 2) if wall else None,
        }
        _write_stats(stats, stats_path)
    return stats
