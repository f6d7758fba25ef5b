"""Two-process dryrun of the port's distributed path
(sjd_tpu/parallel/multihost_dryrun.py): real processes join one gloo group
through ``parallel.dist.init_distributed``, run two FSDP train steps on an
``nprocs x 1`` mesh and a tensor-parallel greedy SJD decode on
``1 x nprocs``, and the parent holds their losses and tokens equal, bit
for bit.

    python -m sjd_tpu_torch.parallel.multihost_dryrun [--nprocs 2] [--device cuda]

Worker mode (started by the parent):

    python -m sjd_tpu_torch.parallel.multihost_dryrun --rank R --nprocs N \\
        --port P --outdir D --device DEV

One process holds one device, so ``global_devices`` is ``nprocs`` (the JAX
dryrun gives each process 4 virtual devices). On CUDA the ranks share
``cuda:(rank % device_count)`` over gloo, which stages CUDA tensors
through host memory.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile


def _cfg(device):
    import torch

    from ..models.transformer import DecoderConfig

    # the JAX dryrun's configuration; its heads of 8 take the plain attention
    # (the kernels take heads of 64, 100 and 128)
    return DecoderConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
                         num_heads=4, num_kv_heads=4, head_dim=8, dtype=torch.float32,
                         max_position_embeddings=64,
                         attn_impl="plain" if device.type == "cuda" else "auto")


def _worker(rank: int, nprocs: int, port: int, outdir: str, device: str) -> None:
    import numpy as np
    import torch

    from .. import resolve_device
    from ..core.engine import EngineConfig, SJDEngine
    from ..core.grammar import GrammarSpec
    from ..core.processors import SamplingParams
    from ..models.adapter import decoder_model_fns
    from .dist import all_reduce_mean, barrier, init_distributed
    from .mesh import make_mesh
    from .sharding import init_params_sharded
    from .training import TrainConfig, make_train_step

    torch.set_num_threads(1)
    dev = resolve_device(device)
    info = init_distributed(f"localhost:{port}", nprocs, rank, device=dev, backend="gloo")
    if info["process_count"] != nprocs:
        raise RuntimeError(f"joined {info['process_count']} processes, not {nprocs}")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _cfg(dev)

    # ---- FSDP train steps over nprocs x 1 ---------------------------------
    mesh = make_mesh(data=nprocs, model=1, device=dev)
    init_fn, step_fn = make_train_step(
        mesh, cfg, TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4),
        tp=False, fsdp=True, device=dev)
    rs = np.random.RandomState(0)  # the same global batch on every process
    B, T = 4 * nprocs, 12
    ids_np = rs.randint(0, 64, size=(B, T))
    labels_np = np.where(np.arange(T)[None, :] < 2, -100, ids_np)
    ids = torch.as_tensor(ids_np, device=dev)
    labels = torch.as_tensor(labels_np, device=dev)
    mask = torch.ones((B, T), dtype=torch.bool, device=dev)
    state = init_fn(0)
    losses = []
    for _ in range(2):
        state, metrics = step_fn(state, ids, labels, mask)
        losses.append(float(metrics["loss"]))
    # the loss is global: every process holds the same scalar, and the
    # mean of equal scalars is that scalar
    mean0 = all_reduce_mean(losses[-1])
    del state
    barrier("dryrun-train")

    # ---- TP SJD decode over 1 x nprocs ------------------------------------
    tp_mesh = make_mesh(data=1, model=nprocs, device=dev)
    eng = SJDEngine(
        decoder_model_fns(cfg, max_positions=64, device=dev),
        EngineConfig(window=4, scheme="speculative_jacobi", max_len=16, cfg_mode="none"),
        GrammarSpec(kind="none", image_vocab_start=0, image_vocab_end=63),
        SamplingParams(do_cfg=False, greedy=True, image_top_k=64, text_top_k=64),
        cuda_graph=False)
    params = init_params_sharded(3, cfg, tp_mesh, device=dev)
    res = eng.generate(params, 0, torch.tensor([[1, 2, 3, 4]], device=dev))
    toks = res.tokens[0, : 4 + 16].cpu().tolist()
    barrier("dryrun-decode")

    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "process_count": info["process_count"],
                   "global_devices": info["global_devices"], "losses": losses,
                   "loss_mean": mean0, "tokens": toks}, f)
    import torch.distributed as dist

    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multihost(nprocs: int = 2, timeout: float = 600.0, *, device=None) -> dict:
    """Start ``nprocs`` worker processes on ``device`` (default CUDA), wait,
    and hold their train losses and TP-decoded tokens equal across
    processes. Returns the rank-0 report."""
    from .. import resolve_device

    dev = resolve_device(device)
    outdir = tempfile.mkdtemp(prefix="mh_dryrun_")
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sjd_tpu_torch.parallel.multihost_dryrun", "--rank", str(r),
         "--nprocs", str(nprocs), "--port", str(port), "--outdir", outdir,
         "--device", dev.type], cwd=root) for r in range(nprocs)]
    try:
        for p in procs:
            rc = p.wait(timeout=timeout)
            if rc != 0:
                raise RuntimeError(f"a dryrun worker exited {rc}")
        reports = []
        for r in range(nprocs):
            with open(os.path.join(outdir, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    finally:
        for p in procs:  # no worker outlives a timeout or a failure
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(outdir, ignore_errors=True)
    for rep in reports[1:]:
        if rep["losses"] != reports[0]["losses"]:
            raise AssertionError(f"FSDP train losses diverged across processes: {reports}")
        if rep["tokens"] != reports[0]["tokens"]:
            raise AssertionError(f"TP decode diverged across processes: {reports}")
    print("dryrun_multihost ok:", json.dumps(reports[0]), flush=True)
    return reports[0]


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--port", type=int, default=12345)
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.rank is None:
        dryrun_multihost(args.nprocs, device=args.device)
    else:
        _worker(args.rank, args.nprocs, args.port, args.outdir, args.device)
