"""Meshes, sharding rules, the sharded train step and tensor-parallel
decoding (sjd_tpu/parallel/__init__.py's names). Command lines:
``python -m sjd_tpu_torch.parallel.finetune`` (fine-tuning),
``python -m sjd_tpu_torch.parallel.multihost_dryrun`` (a two-process FSDP
step and TP decode held equal across processes) and ``torchrun ... -m
sjd_tpu_torch.parallel.tp_decode`` (Chameleon-34B decoded under TP)."""

from .mesh import host_local_mesh, make_mesh, shard
from .multihost_dryrun import dryrun_multihost
from .sharding import (
    LocalParams,
    ModelAxis,
    apply_named_sharding,
    batch_specs,
    decoder_param_specs,
    expand_specs_for_quantized,
    init_params_sharded,
    kv_cache_specs,
    local_tree,
    shard_params,
)
from .training import TrainConfig, TrainState, loss_fn, make_train_step

__all__ = [
    "host_local_mesh",
    "make_mesh",
    "shard",
    "dryrun_multihost",
    "LocalParams",
    "ModelAxis",
    "apply_named_sharding",
    "batch_specs",
    "decoder_param_specs",
    "expand_specs_for_quantized",
    "init_params_sharded",
    "kv_cache_specs",
    "local_tree",
    "shard_params",
    "TrainConfig",
    "TrainState",
    "loss_fn",
    "make_train_step",
]
