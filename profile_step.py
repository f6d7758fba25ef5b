"""Where a decode step of the port's main path spends its time, on one GPU.

    python3 profile_step.py [--at 16 600 1000] [--steps 32] [--target-size 768] [--eager]
                            [--quantize {4,w4a8}]

Loads Lumina-mGPT-7B at full width and depth with random bf16 weights (or,
with ``--quantize``, packed int4 projections and an int8 head: W4A16 with
4, W4A8 with w4a8) and an int8 KV cache
(sjd_tpu_torch.loader.load_lumina_mgpt), warms up with
one short generation (which also captures the decode step as a CUDA
graph), then, for each ``--at`` step A, measures the window of decode steps
[A, A + steps) of one image generated from a fixed seed: ``generate`` up to
step A, then ``resume`` for ``steps`` forwards, each a replay of the
captured step (``--eager``: the engine with ``cuda_graph=False``). Twice
over the same trajectory:

  * plain: host clock around the ``resume``, synchronized at both ends: ms
    per forward;
  * under torch.profiler (CPU + CUDA activities), recording the ``resume``
    only: device time by kernel name, device time per forward, the device's
    busy share (kernel time, which does not overlap on one stream, over the
    plain run's wall for the same window), host operators by self time, and
    the launch calls the host made per forward (``cudaGraphLaunch`` for a
    replay; ``cudaLaunchKernel`` and ``cuLaunchKernelEx`` for the draws, the
    copies into the graph's inputs and, with ``--eager``, every kernel).

The cache fills as the image grows, so the windows see the attention cost
at a few fills (``cache_rows``: sample 0's live cache rows at the window's
start). Only the windows are recorded: a profile of a whole image holds
millions of events and takes longer to summarize than to generate.

Prints one JSON object per window.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


GEMM_KEYS = ("nvjet", "gemm", "quant_linear_kernel")


def reach(eng, params, ids, at: int):
    """The state after decode step ``at`` of the fixed-seed image."""
    _, st = eng.generate(params, 0, ids, max_steps=1 + at, return_state=True)
    if st.nfe != 1 + at or bool(st.finished.all()):
        raise SystemExit(f"profile_step: the image ended after {st.nfe - 1} decode steps, "
                         f"before step {at}")
    return st


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # the default image (seed 0, this prompt) at 768px ends after ~1100
    # decode steps on bf16 weights, so the last default window closes before
    # it; on the random weights quantized to int4 it ends earlier (after
    # ~935 decode steps on W4A16, ~857 on W4A8: pass --at 16 600 800)
    ap.add_argument("--at", type=int, nargs="+", default=[16, 600, 1000],
                    help="first decode step of each measured window")
    ap.add_argument("--steps", type=int, default=32, help="decode steps per window")
    ap.add_argument("--target-size", type=int, default=768)
    ap.add_argument("--eager", action="store_true",
                    help="run every step eagerly (cuda_graph=False)")
    ap.add_argument("--quantize", choices=["4", "w4a8"], default=None,
                    help="quantized weights: 4 = W4A16, w4a8 = W4A8 (int8 head both)")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from sjd_tpu_torch.loader import load_lumina_mgpt

    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    quantize = {"4": 4, "w4a8": "w4a8", None: False}[args.quantize]
    model = load_lumina_mgpt(target_size=args.target_size, quantize=quantize, device="cuda")
    eng, params = model.engine, model.params
    eng.cuda_graph = not args.eager
    ids = torch.tensor([model.extras["prompt_ids_fn"]("a photo of a red fox")],
                       dtype=torch.int32, device="cuda")
    # warm-up: allocator, cuBLAS, kernels, and the capture of the step
    eng.generate(params, 0, ids, max_steps=8)

    def device_us(ev):
        return getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)

    for at in args.at:
        st = reach(eng, params, ids, at)
        rows = int(st.length[0]) - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.resume(params, st, max_steps=args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if st.nfe != 1 + at + args.steps:
            raise SystemExit(f"profile_step: the image ended inside [{at}, {at + args.steps})")

        st = reach(eng, params, ids, at)
        replays = eng.stats.replays
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.resume(params, st, max_steps=args.steps)
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [ev for ev in events if str(ev.device_type).endswith("CUDA")]
        host = [ev for ev in events if not str(ev.device_type).endswith("CUDA")]
        busy_ms = sum(device_us(ev) for ev in kernels) / 1e3
        # the weight products: cuBLAS's GEMMs on bf16 weights, the
        # quantized-product kernel otherwise
        gemm_ms = sum(device_us(ev) for ev in kernels
                      if any(k in ev.key for k in GEMM_KEYS)) / 1e3
        launch_calls = {ev.key: ev.count / args.steps for ev in host
                        if "LaunchKernel" in ev.key or "GraphLaunch" in ev.key}
        top = sorted(kernels, key=device_us, reverse=True)[: args.top]
        top_host = sorted(host, key=lambda ev: ev.self_cpu_time_total, reverse=True)[: args.top]
        print(json.dumps({
            "device": smi,
            "target_size": args.target_size,
            "path": "eager" if args.eager else "graph",
            "quantize": args.quantize,
            "window": [at, at + args.steps],
            "graph_replays": eng.stats.replays - replays,
            "cache_rows": rows,
            "ms_per_forward": 1e3 * wall / args.steps,
            # None: the profiler saw no device time (then it was not measured)
            "device_ms_per_forward": busy_ms / args.steps if busy_ms else None,
            "device_busy_share": busy_ms / 1e3 / wall if busy_ms else None,
            "gemm_ms_per_forward": gemm_ms / args.steps,
            "gemm_share_of_device": gemm_ms / busy_ms if busy_ms else None,
            "launch_calls_per_forward": launch_calls,
            "kernels": [{"name": ev.key[:120], "calls": ev.count,
                         "per_forward_ms": device_us(ev) / 1e3 / args.steps}
                        for ev in top],
            # host operators by self time (profiled, so slower than plain):
            # where the step loop's host time goes, waits on the device included
            "host": [{"name": ev.key[:120], "calls": ev.count,
                      "self_per_forward_ms": ev.self_cpu_time_total / 1e3 / args.steps}
                     for ev in top_host],
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
