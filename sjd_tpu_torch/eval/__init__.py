"""Evaluation (sjd_tpu/eval): prompt sets, the generation harness, FID, IS
and CLIPScore on the InceptionV3 and CLIP towers, and the decode-step
latency probes; ``eval_model`` and ``recon_eval`` are the command lines."""

from .datasets import PromptRecord, create_dataset, shard_prompts
from .harness import run_prompt_set, workdir_name
from .metrics import (
    clip_score,
    evaluate_quantitative_scores,
    frechet_distance,
    inception_score,
)

__all__ = [
    "PromptRecord",
    "create_dataset",
    "shard_prompts",
    "run_prompt_set",
    "workdir_name",
    "clip_score",
    "evaluate_quantitative_scores",
    "frechet_distance",
    "inception_score",
]
