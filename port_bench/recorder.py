"""The benchmark's own spans and counters around the calls into the port.

``EngineProxy`` is the engine handed to ``StreamingBatcher``: it forwards
``generate``, ``resume`` and ``refill`` to the port's ``SJDEngine`` and
records, for each call, its host interval and the engine state at the
chunk boundary it returns (per-slot lengths, NFE, acceptance histogram). The window opens and closes on such a
boundary; after it closes, every further call raises :class:`WindowClosed`,
which drains the batcher without running the engine again.

``StepLog`` records, before every decode step, what the check needs to
follow each request step by step: the slots' lengths, carried-draft counts
and carried drafts (device copies into a buffer made beforehand, with no
sync), and the initial seed of each slot's generator.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, List, Optional

import numpy as np

import torch


class WindowClosed(RuntimeError):
    """Raised into the batcher after the window: its requests are dropped."""


@dataclasses.dataclass
class Call:
    kind: str  # "generate" | "resume" | "refill"
    t0: float
    t1: float
    nfe0: int
    nfe1: int
    len0: List[int]  # per-slot lengths before (after the previous call)
    len1: List[int]  # per-slot lengths after
    refilled: int  # slots re-armed (refill) or admitted (generate)
    hist: List[int]  # acceptance histogram delta (decode steps by accepted length)
    prompt_rows: int
    slots: int


class Recorder:
    """Host spans (name, t0, t1) by thread; profiler annotations of the
    same names while a trace is on."""

    def __init__(self):
        self.spans: List[tuple] = []
        self.lock = threading.Lock()
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = (torch.profiler.record_function(f"bench.{name}") if self.annotate
              else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
        t1 = time.perf_counter()
        with self.lock:
            self.spans.append((name, t0, t1, threading.get_ident()))


class EngineProxy:
    """The port's engine with the benchmark's boundary records."""

    def __init__(self, engine, recorder: Recorder, seconds: float,
                 on_boundary: Optional[Callable] = None):
        self._eng = engine
        self.rec = recorder
        self.seconds = seconds
        self.calls: List[Call] = []
        self.open_requested = threading.Event()
        self.opened = threading.Event()
        self.closed = threading.Event()
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None
        self.i_open = self.i_close = 0  # calls[i_open:i_close] lie in the window
        # called at each boundary from the opening one on: (proxy, time, closing)
        self.on_boundary = on_boundary
        self._lengths: Optional[List[int]] = None
        self._hist: Optional[List[int]] = None
        self.peak_setup = self.peak_window = 0
        self.final = None  # (token rows, lengths) of the state at the closing boundary
        self.excluded_s = 0.0  # host seconds inside the window that it does not measure

    def __getattr__(self, name):  # device, config, sampling, stats, ...
        return getattr(self._eng, name)

    def _record(self, kind, t0, state, nfe0, refilled):
        lens = state.length.tolist()
        hist = state.accept_hist.tolist()
        if kind == "generate" or self._hist is None:
            dh = hist
        else:
            dh = [a - b for a, b in zip(hist, self._hist)]
        self.calls.append(Call(
            kind=kind, t0=t0, t1=time.perf_counter(), nfe0=nfe0, nfe1=state.nfe,
            len0=self._lengths if (self._lengths and kind != "generate") else
            [state.prompt_rows] * len(lens),
            len1=lens, refilled=refilled, hist=dh, prompt_rows=state.prompt_rows,
            slots=len(lens)))
        self._lengths, self._hist = lens, hist

    def _boundary(self, state):
        """A chunk boundary: open or close the window here."""
        now = time.perf_counter()
        cuda = torch.cuda.is_available()
        if self.t_open is None:
            if self.open_requested.is_set():
                self.peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
                self.t_open, self.i_open = now, len(self.calls)
                if self.on_boundary:
                    self.on_boundary(self, now, False)
                self.opened.set()
            return
        if self.t_close is None:
            closing = now - self.t_open - self.excluded_s >= self.seconds
            if self.on_boundary:
                self.on_boundary(self, now, closing)
            if closing:
                self.peak_window = torch.cuda.max_memory_allocated() if cuda else 0
                self.final = (state.tokens.cpu().numpy(), state.length.tolist())
                self.t_close, self.i_close = now, len(self.calls)
                self.closed.set()

    def _guard(self):
        if self.t_close is not None:
            raise WindowClosed("the measured window has closed")

    def generate(self, params, rng, *args, **kw):
        self._guard()
        t0 = time.perf_counter()
        with self.rec.span("engine.generate"):
            res, state = self._eng.generate(params, rng, *args, **kw)
        self._record("generate", t0, state, 0, len(state.gens))
        self._boundary(state)
        return res, state

    def resume(self, params, state, *args, **kw):
        self._guard()
        nfe0, t0 = state.nfe, time.perf_counter()
        with self.rec.span("engine.resume"):
            res, state = self._eng.resume(params, state, *args, **kw)
        self._record("resume", t0, state, nfe0, 0)
        self._boundary(state)
        return res, state

    def refill(self, params, state, *args, refill_mask=None, **kw):
        self._guard()
        nfe0, t0 = state.nfe, time.perf_counter()
        with self.rec.span("engine.refill"):
            state = self._eng.refill(params, state, *args, refill_mask=refill_mask, **kw)
        self._record("refill", t0, state, nfe0, int(sum(bool(m) for m in refill_mask)))
        return state

    def window_calls(self) -> List[Call]:
        return self.calls[self.i_open:self.i_close]


class StepLog:
    """Per decode step of ``engine``, the state the step starts from. It
    wraps the engine's ``_draws``, which every step calls once before its
    forward (eagerly or before a graph's replay), and adds one copy kernel
    to the step."""

    def __init__(self, engine, batch: int, max_steps: int):
        W = engine.config.window
        self._eng = engine
        self._draws = engine._draws
        self.buf = torch.zeros((max_steps, batch, W + 2), dtype=torch.int32,
                               device=engine.device)
        self.seeds: List[List[int]] = []  # per step, each slot's generator seed
        self.prompt_rows = None
        self._rec = None
        engine._draws = self._record  # the instance's attribute shadows the method

    def _record(self, st):
        i = len(self.seeds)
        if i >= self.buf.shape[0]:
            raise RuntimeError(f"more than {self.buf.shape[0]} decode steps to record")
        torch.cat([st.length[:, None], st.carried_count[:, None], st.carried_tokens],
                  dim=1, out=self.buf[i])
        self.seeds.append([g.initial_seed() for g in st.gens])
        self.prompt_rows = st.prompt_rows
        return self._draws(st)

    def close(self) -> None:
        """Stop recording: the engine's own ``_draws`` again."""
        del self._eng._draws

    def steps_of(self, generator_seed: int) -> np.ndarray:
        """[k, W + 2] (length, carried count, carried drafts) of the steps
        of the slot whose generator has ``generator_seed``, in order."""
        if self._rec is None or len(self._rec) != len(self.seeds):
            self._rec = self.buf[:len(self.seeds)].cpu().numpy()
        rec = self._rec
        rows = [rec[i, b] for i, seeds in enumerate(self.seeds)
                for b, s in enumerate(seeds) if s == generator_seed]
        return np.stack(rows) if rows else np.zeros((0, rec.shape[-1]), np.int32)
