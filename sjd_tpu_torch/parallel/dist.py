"""Multi-process initialization (sjd_tpu/parallel/dist.py).

``init_distributed`` resolves the rendezvous the way the JAX package does:
explicit arguments, then torchrun's ``MASTER_ADDR``/``MASTER_PORT``/
``WORLD_SIZE``/``RANK``, then SLURM, then one process. With more than one
process it starts ``torch.distributed`` (NCCL on CUDA, gloo on the CPU).
``all_reduce_mean`` and ``barrier`` act on host values across processes.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch
import torch.distributed as dist

from .. import resolve_device


def _first_slurm_node(nodelist: str) -> str:
    """First hostname of a SLURM nodelist, expanding the compressed bracket
    form: 'nid[001-004,007]' -> 'nid001' (zero padding kept)."""
    m = re.match(r"([^\[,]+)\[([^\]]+)\]", nodelist)
    if m:
        prefix, ranges = m.groups()
        return prefix + ranges.split(",")[0].split("-")[0]
    return nodelist.split(",")[0]


def resolve_rendezvous(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None) -> tuple:
    """(coordinator "host:port" or None, process count or None, process id
    or None), in the JAX package's order of resolution."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '1234')}"
        num_processes = num_processes or int(env.get("WORLD_SIZE", "1"))
        process_id = process_id if process_id is not None else int(env.get("RANK", "0"))
    elif coordinator_address is None and "SLURM_JOB_NODELIST" in env:
        head = _first_slurm_node(env["SLURM_JOB_NODELIST"])
        coordinator_address = f"{head}:12345"
        num_processes = num_processes or int(env.get("SLURM_NTASKS", "1"))
        process_id = process_id if process_id is not None else int(env.get("SLURM_PROCID", "0"))
    return coordinator_address, num_processes, process_id


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device=None,
                     backend: Optional[str] = None) -> dict:
    """Start ``torch.distributed`` when more than one process takes part,
    with NCCL when ``device`` (default CUDA) is a GPU and gloo on the CPU,
    or ``backend`` when given (gloo on CUDA: ranks that share one card,
    which NCCL refuses); one process starts nothing. Returns the JAX
    package's four keys: this process' index and the count, and the
    devices here and in all (one device per process)."""
    dev = resolve_device(device)
    addr, n, pid = resolve_rendezvous(coordinator_address, num_processes, process_id)
    if addr and (n or 1) > 1 and not dist.is_initialized():
        if dev.type == "cuda":  # one card per process, as torchrun numbers them;
            # more processes than cards share them (gloo)
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", pid))
                                  % torch.cuda.device_count())
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method=f"tcp://{addr}", world_size=n, rank=pid)
    count = dist.get_world_size() if dist.is_initialized() else 1
    return {"process_index": dist.get_rank() if dist.is_initialized() else 0,
            "process_count": count, "local_devices": 1, "global_devices": count}


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def all_reduce_mean(x: float) -> float:
    """Mean of a host scalar across processes."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return float(x)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor(float(x), dtype=torch.float64, device=dev)
    dist.all_reduce(t)
    return float(t) / dist.get_world_size()


def barrier(name: str = "barrier") -> None:
    """Cross-process sync (``name`` names it in the JAX package's API)."""
    del name
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
