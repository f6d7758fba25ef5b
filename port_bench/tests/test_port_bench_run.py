"""The harness end to end on the CPU at tiny sizes, both entries (the
solo entry also on a tiny Chameleon-34B shape: swin-norm, group 8): the
result line's keys, the checks last, and ``correct`` against the plain
reference; then the same runs with the timed path broken underneath,
which ``correct`` has to catch."""

import dataclasses
import json

import pytest
import torch

from port_bench import run
from port_bench.tests import tiny

CELLS = {
    "batcher": ("lumina7b-w4a16.batch5-768", "lumina-mgpt-7b-w4a16", "batch5-768"),
    "emu3": ("emu3gen-w4a16.batch3-720", "emu3-gen-8b-w4a16", "batch3-720"),
    "solo": ("lumina7b-w4a16.solo-512", "lumina-mgpt-7b-w4a16", "solo-512"),
    "solo34b": ("lumina7b-w4a16.solo-512", "lumina-mgpt-7b-w4a16", "solo-512"),
}
SHAPES = {"solo34b": "34b"}  # tiny.spec's shape
# loose enough for bf16 logits of a 2-layer model on the CPU; the chip's
# limits are the cell files'
LIMITS = {"mean_gap": 0.1, "vq_mean_abs": 1.0}


def _run(kind, trace=False, seconds=2.0):
    torch.manual_seed(0)
    spec = tiny.spec(*CELLS[kind], limits=dict(LIMITS), shape=SHAPES.get(kind))
    return run.run_cell(spec, 2**33 + 17, seconds, trace, "cpu")


def _cfg(kind):
    return tiny.spec(*CELLS[kind], shape=SHAPES.get(kind))["cfg"]


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_run_line(kind):
    r = _run(kind)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    json.dumps(r)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert {"setup_s", "gen_tokens_per_s"} <= set(r["metrics"])
    # every request of the window is checked, those in flight at its close too
    assert r["checks"]["requests_checked"]["value"] == r["attempted"]
    assert run.forbidden_modules() == []


@pytest.mark.parametrize("kind", ["batcher", "solo"])
def test_traced_run(kind):
    r = _run(kind, trace=True, seconds=3.0)
    assert {"tokens_per_forward", "engine_ms_per_forward"} <= set(r["metrics"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "window_s" in r["device"] and "busy_s" in r["device"]


def _altered_logits(monkeypatch, kind):
    """Every forward's logits favour one image token by a wide margin: the
    token the grammar leaves free is altered where it is produced."""
    from sjd_tpu_torch.models import transformer

    real = transformer.forward
    tok = _cfg(kind)["serving"]["grammar"]["image_vocab_start"] + 1234

    def forward(*a, **k):
        out = real(*a, **k)
        out.logits[..., tok] += 50.0
        return out
    monkeypatch.setattr(transformer, "forward", forward)


def _frozen_step(monkeypatch, kind):
    """The decode step leaves its state as it was."""
    from sjd_tpu_torch.core.engine import SJDEngine

    monkeypatch.setattr(SJDEngine, "_step_into", lambda self, *a, **k: None)


def _stale_grammar(monkeypatch, kind):
    """A refilled slot keeps the grammar state of the request it held."""
    from sjd_tpu_torch.core.engine import SJDEngine

    real = SJDEngine.refill

    def refill(self, params, state, *a, **k):
        old = [t.clone() for t in state.gstate]
        out = real(self, params, state, *a, **k)
        for dst, src in zip(out.gstate, old):
            dst.copy_(src)
        return out
    monkeypatch.setattr(SJDEngine, "refill", refill)


def _flipped_swin(monkeypatch, kind):
    """The program's layers with the other norm placement (pre-norm where
    the configuration states swin-norm)."""
    from port_bench import families

    real = families.model_config
    monkeypatch.setattr(families, "model_config", lambda cfg, act_quant="bf16": (
        dataclasses.replace(real(cfg, act_quant), swin_norm=not cfg.get("swin_norm", False))))


@pytest.mark.parametrize("kind,fault", [("batcher", "token"), ("emu3", "token"),
                                        ("solo", "token"), ("solo34b", "token"),
                                        ("batcher", "frozen"), ("emu3", "frozen"),
                                        ("solo", "frozen"), ("batcher", "stale"),
                                        ("solo34b", "swin")])
def test_broken_path_is_not_correct(monkeypatch, kind, fault):
    {"token": _altered_logits, "frozen": _frozen_step, "stale": _stale_grammar,
     "swin": _flipped_swin}[fault](monkeypatch, kind)
    r = _run(kind)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("kind", ["batcher", "solo"])
def test_control_readings(kind):
    """The control at a test size: a window served by the port's W4A8 path,
    and its bf16 VQ decode, judged by the same reference as the program's."""
    from port_bench import control

    spec = tiny.spec(*CELLS[kind], limits=dict(LIMITS))
    r = control.one_seed(spec, 99, 2.0, torch.device("cpu"))
    for side in ("program", "control"):
        assert r[side]["requests"] >= 1 and r[side]["tokens"] >= 21
        assert {"logit_gap", "mean_gap", "outside_topk", "vq_mean_abs"} <= set(r[side])
        assert r[side]["grammar_misses"] == 0 and r[side]["trajectory_misses"] == 0
    assert r["control"]["vq_mean_abs"] > r["program"]["vq_mean_abs"]


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_float32_program_reads_no_gap(monkeypatch, kind):
    """With the program in float32, as the reference is, every decision of
    every step (acceptances, rejections, samples, resamples) is the
    reference's own: the check follows the program's sampling exactly, and
    only the program's rounding leaves gaps above 0."""
    from port_bench import families

    real = families.model_config
    monkeypatch.setattr(families, "model_config", lambda cfg, act_quant="bf16": (
        dataclasses.replace(real(cfg, act_quant), dtype=torch.float32)))
    r = _run(kind)
    assert r["checks"]["requests_checked"]["value"] >= 2
    assert r["checks"]["mean_gap"]["value"] < 1e-4, r["checks"]
