"""Meshes, sharding rules and the sharded train step
(sjd_tpu/parallel/__init__.py's names); ``python -m
sjd_tpu_torch.parallel.finetune`` is the fine-tuning command line."""

from .mesh import host_local_mesh, make_mesh, shard
from .sharding import (
    apply_named_sharding,
    batch_specs,
    decoder_param_specs,
    kv_cache_specs,
)
from .training import TrainConfig, TrainState, loss_fn, make_train_step

__all__ = [
    "host_local_mesh",
    "make_mesh",
    "shard",
    "apply_named_sharding",
    "batch_specs",
    "decoder_param_specs",
    "kv_cache_specs",
    "TrainConfig",
    "TrainState",
    "loss_fn",
    "make_train_step",
]
