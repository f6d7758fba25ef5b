"""Where a decode step of the port's main path spends its time, on one GPU.

    python3 profile_step.py [--at 16 600 1000] [--steps 32] [--target-size 768]

Loads Lumina-mGPT-7B at full width and depth with random bf16 weights and
an int8 KV cache (sjd_tpu_torch.loader.load_lumina_mgpt), warms up with
one short generation, then, for each ``--at`` step A, measures the window
of decode steps [A, A + steps) of one image generated from a fixed seed,
twice over the same trajectory:

  * plain: host clock around the window, synchronized at both ends: ms per
    forward;
  * under torch.profiler (CPU + CUDA activities), recording the window
    only: device time by kernel name, device time per forward, the
    device's busy share (kernel time, which does not overlap on one
    stream, over the plain run's wall for the same window), and host
    operators by self time, and the kernel-launch API calls per forward.

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


def run_window(eng, params, ids, at: int, steps: int, enter, leave) -> int:
    """``eng.generate`` up to decode step ``at + steps``, calling ``enter()``
    before decode step ``at`` and ``leave()`` after step ``at + steps - 1``.
    Returns sample 0's live cache rows at the window's start."""
    step = type(eng)._step
    seen = {"steps": 0, "rows": -1}

    def hooked(p, st):
        i = seen["steps"]
        if i == at:
            seen["rows"] = int(st.length[0]) - 1
            enter()
        out = step(eng, p, st)
        seen["steps"] = i + 1
        if i == at + steps - 1:
            leave()
        return out

    eng._step = hooked
    try:
        eng.generate(params, 0, ids, max_steps=1 + at + steps)
    finally:
        del eng._step
    if seen["steps"] < at + steps:
        raise SystemExit(f"profile_step: the image ended after {seen['steps']} decode "
                         f"steps, before the window [{at}, {at + steps})")
    return seen["rows"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # the default image (seed 0, this prompt) at 768px ends after 1051
    # decode steps, so the last default window closes before it
    ap.add_argument("--at", type=int, nargs="+", default=[16, 600, 1000],
                    help="first decode step of each measured window")
    ap.add_argument("--steps", type=int, default=32, help="decode steps per window")
    ap.add_argument("--target-size", type=int, default=768)
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
    model = load_lumina_mgpt(target_size=args.target_size, device="cuda")
    eng, params = model.engine, model.params
    ids = torch.tensor([model.extras["prompt_ids_fn"]("a photo of a red fox")],
                       dtype=torch.int32, device="cuda")
    eng.generate(params, 0, ids, max_steps=8)  # warm-up (allocator, cuBLAS, kernels)

    def device_us(ev):
        return getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)

    for at in args.at:
        clock = {}

        def tick(key):
            torch.cuda.synchronize()
            clock[key] = time.perf_counter()

        rows = run_window(eng, params, ids, at, args.steps,
                          lambda: tick("start"), lambda: tick("end"))
        wall = clock["end"] - clock["start"]

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

        def start():
            torch.cuda.synchronize()
            prof.start()

        def stop():
            torch.cuda.synchronize()
            prof.stop()

        run_window(eng, params, ids, at, args.steps, start, stop)
        events = prof.key_averages()
        kernels = [ev for ev in events if str(ev.device_type).endswith("CUDA")]
        host = [ev for ev in events if not str(ev.device_type).endswith("CUDA")]
        busy_ms = sum(device_us(ev) for ev in kernels) / 1e3
        # kernel launches the host issued (cudaLaunchKernel and its kin)
        launch_calls = {ev.key: ev.count / args.steps for ev in host
                        if "LaunchKernel" in ev.key}
        top = sorted(kernels, key=device_us, reverse=True)[: args.top]
        top_host = sorted(host, key=lambda ev: ev.self_cpu_time_total, reverse=True)[: args.top]
        print(json.dumps({
            "device": smi,
            "target_size": args.target_size,
            "window": [at, at + args.steps],
            "cache_rows": rows,
            "ms_per_forward": 1e3 * wall / args.steps,
            "device_ms_per_forward": busy_ms / args.steps,
            "device_busy_share": busy_ms / 1e3 / wall,
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
