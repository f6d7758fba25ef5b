"""Training checkpoints with resume (sjd_tpu/utils/checkpoints.py).

Step-indexed directories under one root, pruned to ``max_keep``; each is
written into a temporary directory and renamed when complete, so a cut run
leaves no half checkpoint under a step's name. The format is
``torch.distributed.checkpoint``'s (not orbax's): every rank writes its own
shards of DTensor leaves, and a state saved under one mesh restores under
another, or on one process into plain tensors.

A state is a :class:`parallel.training.TrainState` (``state_dict()``
gives tensors sharing its storage, ``load_state_dict()`` takes the
counters back) or a nested dict of tensors.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional

import torch.distributed.checkpoint as dcp

from ..parallel.dist import barrier, is_main_process

PyTree = Any
_TMP = ".tmp-"


class CheckpointManager:
    """Step directories ``<directory>/<step>`` (orbax's layout)."""

    def __init__(self, directory: str, max_keep: int):
        self.directory = os.path.abspath(directory)
        self.max_keep = max_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))


def make_manager(directory: str, *, max_keep: int = 3) -> CheckpointManager:
    return CheckpointManager(directory, max_keep)


def _template(state: PyTree) -> dict:
    return state.state_dict() if hasattr(state, "state_dict") else state


def save(manager: CheckpointManager, step: int, state: PyTree) -> None:
    """Write ``state`` as step ``step`` (all ranks call it), then keep the
    newest ``max_keep`` steps."""
    final, tmp = manager.path(step), os.path.join(manager.directory, f"{_TMP}{step}")
    if is_main_process():
        shutil.rmtree(tmp, ignore_errors=True)
    barrier()
    dcp.save(_template(state), checkpoint_id=tmp)
    barrier()
    if is_main_process():
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in manager.all_steps()[:-manager.max_keep]:
            shutil.rmtree(manager.path(old))
    barrier()


def restore(manager: CheckpointManager, state: PyTree, step: Optional[int] = None) -> PyTree:
    """Load step ``step`` (default the latest) into ``state``'s tensors, in
    place, in their own layout; returns the restored state. Raises
    ``FileNotFoundError`` when there is nothing to restore."""
    step = manager.latest_step() if step is None else step
    if step is None or not os.path.isdir(manager.path(step)):
        raise FileNotFoundError(f"no checkpoint to restore in {manager.directory}")
    sd = _template(state)
    dcp.load(sd, checkpoint_id=manager.path(step))
    return state.load_state_dict(sd) if hasattr(state, "load_state_dict") else sd
