"""The traced run: ``torch.profiler`` over whole steps spread across the
window (a step is a chunk, boundary to boundary), with a schedule so
that the trace stays small enough to read in seconds.

From each recorded step it keeps the device intervals (kernels, copies and
sets on the card) and the benchmark's annotations (``bench.*``) on the
profiler's clock, and the host seconds its own reading took, which the
host-clock metrics leave out."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import List, Optional

import torch

K1_NAMES = ("quant_linear_kernel",)
ATTN_NAMES = ("flash_decode_split_kernel", "merge_splits_kernel")


def _ns(ev, what: str) -> float:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(ev, f"{what}_us")()) * 1e3


class Tracer:
    """Steps are numbered from 0 at ``start``; step k is recorded where
    ``k % cycle == cycle - 1`` for the first ``repeat`` cycles."""

    def __init__(self, every: int, repeat: int):
        self.every, self.repeat = max(2, int(every)), int(repeat)
        self.step_no = 0
        self.prof = None
        self.device: List[tuple] = []  # (name, start_ns, end_ns)
        self.notes: List[tuple] = []  # (name, start_ns, end_ns)
        self.steps: List[tuple] = []  # (start_ns, end_ns) of each recorded step
        self.read_s = 0.0  # host seconds spent reading traces (inside step/stop)

    def active(self, k: Optional[int] = None) -> bool:
        k = self.step_no if k is None else k
        return k % self.every == self.every - 1 and k < self.every * self.repeat

    def profiled(self, k: Optional[int] = None) -> bool:
        """Step k runs under the profiler (its warm-up or its recording)."""
        k = self.step_no if k is None else k
        return k % self.every >= self.every - 2 and k < self.every * self.repeat

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        sched = torch.profiler.schedule(wait=self.every - 2, warmup=1, active=1,
                                        repeat=self.repeat)
        self.prof = torch.profiler.profile(activities=acts, schedule=sched,
                                           on_trace_ready=self._ready)
        self.prof.start()

    def step(self):
        t = time.perf_counter()
        self.prof.step()
        self.step_no += 1
        self.read_s += time.perf_counter() - t

    def stop(self):
        if self.prof is None:
            return
        t = time.perf_counter()
        self.prof.stop()
        self.prof = None
        self.read_s += time.perf_counter() - t

    def _ready(self, p):
        t = time.perf_counter()
        lo, hi = None, None
        for ev in p.profiler.kineto_results.events():
            name = ev.name()
            s = _ns(ev, "start")
            e = s + _ns(ev, "duration")
            if ev.device_type() != torch.autograd.DeviceType.CPU:
                # the device timeline also mirrors the host's annotations
                if not name.startswith(("ProfilerStep#", "bench.")):
                    self.device.append((name, s, e))
            elif name.startswith("ProfilerStep#"):
                lo = s if lo is None else min(lo, s)
                hi = e if hi is None else max(hi, e)
            elif name.startswith("bench."):
                self.notes.append((name[6:], s, e))
        if lo is not None:
            self.steps.append((lo, hi))
        self.read_s += time.perf_counter() - t


def _union(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class TraceView:
    """The recorded steps of one run, in seconds."""

    def __init__(self, tr: Tracer):
        self.tr = tr
        self.spans = []  # per step: (start, end) widened to its last device op
        self.dev = []  # device ops inside a step
        for lo, hi in tr.steps:
            ops = [d for d in tr.device if lo <= d[1] <= hi + 5e8]
            end = max([hi] + [d[2] for d in ops])
            self.spans.append((lo, end))
            self.dev.extend(ops)

    @property
    def window_s(self) -> float:
        return sum(e - s for s, e in self.spans) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(_union([(max(s, lo), min(e, hi)) for _, s, e in self.dev
                           if e > lo and s < hi]) for lo, hi in self.spans) / 1e9

    def kernel_s(self, names) -> tuple:
        """(seconds, launches) of the device ops whose name holds one of
        ``names``."""
        ops = [d for d in self.dev if any(n in d[0] for n in names)]
        return sum(e - s for _, s, e in ops) / 1e9, len(ops)

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for name, s, e in self.dev:
            by[name[:120]] += (e - s) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest device-idle gaps inside the recorded steps, each named
        by the benchmark span the host was in at its middle."""
        gaps = []
        for lo, hi in self.spans:
            ops = sorted((s, e) for _, s, e in self.dev if e > lo and s < hi)
            cur = lo
            for s, e in ops:
                if s > cur:
                    gaps.append((cur, s))
                cur = max(cur, e)
            if hi > cur:
                gaps.append((cur, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) / 2
            inner = [nt for nt in self.tr.notes if nt[1] <= mid <= nt[2]]
            inner.sort(key=lambda nt: nt[2] - nt[1])
            name = NAMES.get(inner[0][0], inner[0][0]) if inner else "batcher boundary"
            out.append([name, (e - s) / 1e9])
        return out


NAMES = {
    "engine.resume": "engine step loop (draws, their copy, replay, flags read)",
    "engine.generate": "engine generate (prefill, step loop)",
    "engine.refill": "refill prefill",
    "vq_decode": "VQ decode",
}
