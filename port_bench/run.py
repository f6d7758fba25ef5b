"""Run one cell of the port's benchmark once.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It builds the cell's configuration in the port (weights drawn on the card
from the configuration's seed, quantized by the port), warms the cell's own shapes, runs
the cell's entry for ``--seconds`` on its traffic, and prints the
end-to-end metrics (``--trace 0``) or the per-layer ones (``--trace 1``)
as the last line of standard output, one JSON object. Then, with the
port's state freed, it checks what the timed path produced against the
plain reference (``reference/``) and prints each number compared beside
its limit, on standard error and under ``checks`` in that line.

It needs a CUDA device: without one, or with fewer than the cell asks
for, it exits with 2 and prints no result. It exits with 3 and prints no
result if JAX or the JAX package is loaded in the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# loaded by no run: compared by whole top-level module names
FORBIDDEN = ("jax", "jaxlib", "flax", "sjd_tpu")


def load_spec(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry in BENCHMARK.json with its configuration, traffic
    mix, cell file and metrics, each found by its name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = root / HERE.name
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((here / "traffic" / "mixes" / f"{cell['traffic']}.json").read_text())
    cellfile = json.loads((here / "workloads" / f"{workload}.json").read_text())

    def applies(m):
        return workload in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return dict(root=str(root), cell=cell, cfg=cfg, mix=mix, cellfile=cellfile,
                end_to_end=e2e, per_layer=per_layer)


def reader(name: str, root: Path = ROOT):
    """``metrics/<name>.py``'s ``read``."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Ctx:
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    device: object
    system: object
    rec: object
    tracer: object
    t_setup: Optional[float] = None

    def setup_done(self):
        self.t_setup = time.perf_counter()


class RunView:
    """What a metric reader sees."""

    def __init__(self, spec, window, setup_s, trace, model):
        self.cell, self.cfg, self.mix = spec["cell"], spec["cfg"], spec["mix"]
        self.window, self.setup_s, self.trace, self.model = window, setup_s, trace, model
        self.batched = spec["mix"]["entry"] == "batcher"
        self.notes = {}

    def note(self, key, value):
        self.notes[key] = value


def tracer_for(mix: dict):
    from .trace import Tracer

    return Tracer(every=mix.get("trace_every", 6), repeat=mix.get("trace_repeat", 3))


def check(spec: dict, items: list, device) -> list:
    """(name, value, limit, kind) of each number compared; ``correct``
    holds where each value is within its limit (at most, or at least where
    the kind is "min"). Every request of the window is checked: those that
    finished in it and those in flight at its close, with the tokens they
    had committed."""
    import numpy as np
    import torch

    from . import weights
    from .reference import taming
    from .reference.check import check_tokens
    from .reference.grammar import image_codes

    cfg, mix = spec["cfg"], spec["mix"]
    limits = spec["cellfile"].get("limits", {})
    out = [("requests_checked", len(items), 1, "min")]
    if not items:
        return out
    res = check_tokens(cfg, mix, device, items)
    for name in ("logit_gap", "mean_gap", "outside_topk"):
        if name in limits:
            out.append((name, res[name], limits[name], "max"))
    out.append(("grammar_misses", res["grammar_misses"], 0, "max"))
    out.append(("trajectory_misses", res["trajectory_misses"], 0, "max"))
    finished = [it for it in items if not it.get("in_flight")]
    if mix.get("decode_images") and finished:
        tree = weights.taming_decoder_tree(cfg["serving"]["vq"], weights.seed_of(cfg), device)
        mean_abs, max_abs = 0.0, 0
        with torch.no_grad():
            from .reference.decoder import strict_f32

            for it in finished:
                if it.get("image") is None:
                    mean_abs = math.inf
                    continue
                codes = torch.as_tensor(image_codes(cfg, mix, it["gen"]), device=device)
                with strict_f32():
                    ref = taming.to_uint8(taming.decode(tree, codes[None])[0])
                d = np.abs(ref.astype(np.int16) - np.asarray(it["image"]).astype(np.int16))
                mean_abs = max(mean_abs, float(d.mean()))
                max_abs = max(max_abs, int(d.max()))
        for name, v in (("vq_mean_abs", mean_abs), ("vq_max_abs", max_abs)):
            if name in limits:
                out.append((name, v, limits[name], "max"))
    out.append(("tokens_checked", res["tokens"], mix.get("check_min_tokens", 1), "min"))
    return out


def _finite(v):
    """JSON has no infinity: an unbounded reading prints as 1e30."""
    return v if math.isfinite(v) else 1e30


def verdict(checks: list, failed: int) -> bool:
    ok = failed == 0
    for _, value, limit, kind in checks:
        if limit is None:
            continue
        ok &= (value >= limit) if kind == "min" else (value <= limit)
    return bool(ok and all(c[2] is not None for c in checks))


def device_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START) -> dict:
    """One run of one cell on ``device``; returns the result object (the
    last line) without printing it."""
    import torch

    from . import families
    from .recorder import Recorder
    from .roofline.shapes import model_dims
    from .trace import TraceView

    from sjd_tpu_torch.utils import compile_watch

    cfg, mix = spec["cfg"], spec["mix"]
    dev = torch.device(device)
    cw0 = compile_watch.snapshot()
    system = families.build(cfg, mix, dev)
    t_built = time.perf_counter()
    ctx = Ctx(cfg=cfg, mix=mix, seed=seed, seconds=seconds, device=dev, system=system,
              rec=Recorder(), tracer=tracer_for(mix) if trace else None)
    entry = importlib.import_module(f"{__package__}.entries.{mix['entry']}")
    window = entry.run(ctx)
    setup_s = window.t_open - t_start
    print(f"setup: {setup_s:.3f} s to the window: {t_built - t_start:.3f} s to the "
          f"weights and engine, {(ctx.t_setup or window.t_open) - t_built:.3f} s of warm-up; "
          f"{json.dumps(compile_watch.delta(cw0))}", file=sys.stderr)
    tview = TraceView(ctx.tracer) if trace else None
    view = RunView(spec, window, setup_s, tview, model_dims(cfg))
    wanted = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in wanted:
        v = reader(m["name"], Path(spec["root"]))(view)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "count": int(spec["cell"].get("chips", 1)),
                "memory_peak_bytes": int(max(window.peak_setup, window.peak_window))}
    result = {"correct": False, "attempted": window.attempted, "failed": window.failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = tview.busy_s
        dev_info["window_s"] = tview.window_s
        result["breakdown"] = {"device_ops": tview.top_ops(), "idle_gaps": tview.idle_gaps()}
    print(f"window: {window.seconds:.3f} s, {window.work.tokens} tokens, "
          f"{window.work.forwards} forwards, {json.dumps(window.notes, default=str)}, "
          f"{json.dumps(view.notes)}, trace read {window.read_s:.3f} s", file=sys.stderr)
    # the port's state goes before the reference runs
    ctx.system = system = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check(spec, window.items, dev)
    print(f"check: {time.perf_counter() - t_check:.3f} s over {len(window.items)} requests",
          file=sys.stderr)
    result["correct"] = verdict(checks, window.failed)
    result["checks"] = {name: {"value": _finite(value), "limit": limit}
                        for name, value, limit, _ in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec(args.workload)
    import torch

    chips = int(spec["cell"].get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda-cache"))
    print(f"card: {device_line()}; peaks: 989e12 bf16 FLOP/s, 3.35e12 B/s (H100 SXM "
          f"data sheet); torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr)
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: the process loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
