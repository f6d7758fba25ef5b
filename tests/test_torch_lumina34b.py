"""Lumina-mGPT-34B-512 at W4A16 (``port_bench/configs/lumina-mgpt-34b-w4a16.json``)
on the CPU, without JAX:

- the configuration file is the port's ``chameleon_config("34B")``, and the
  plain reference models every key of it;
- a copy in its shape (swin-norm, qk-norm, 8 query heads over 1 KV head, an
  int8 cache, W4A16 leaves; widths and depth cut) through the port's
  ``forward``, a prefill and then decode windows of 16 through the cache,
  against the reference's full forward on the logits;
- its byte and operation counts (``port_bench/roofline/``) and
  ``step_hbm_pct`` on a hand-built view;
- the benchmark's solo entry on that copy, judged by the reference.

About 30 s in one process.
"""

import dataclasses
import json
import math
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "port_bench" / "configs" / "lumina-mgpt-34b-w4a16.json"
CELL = "lumina34b-w4a16.solo-512"


def _real() -> dict:
    return json.loads(CONFIG.read_text())


def _shaped() -> dict:
    """The real file with its widths and depth cut: d 128 over 8 query heads
    of 16 and 1 KV head (group 8, as 64 over 8), ff 256, 2 layers, a small
    taming decoder. The vocabulary, the special ids, the norms' placement,
    qk-norm, the int8 cache and W4A16 are the file's."""
    cfg = _real()
    cfg.update(hidden_size=128, intermediate_size=256, num_attention_heads=8,
               num_key_value_heads=1, num_hidden_layers=2)
    cfg["serving"] = dict(cfg["serving"])
    cfg["serving"]["vq"] = dict(cfg["serving"]["vq"], ch=32, ch_mult=[1, 2], num_res_blocks=1,
                                z_channels=32, embed_dim=8)
    return cfg


# -- (a) the file is the port's 34B --------------------------------------------


def test_file_has_the_ports_34b_shape():
    from sjd_tpu_torch.models.chameleon import chameleon_config

    cfg, port = _real(), chameleon_config("34B")
    assert cfg["reduced"] == []
    assert (cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]) == (
        port.hidden_size, port.intermediate_size, port.num_layers)
    assert (cfg["num_attention_heads"], cfg["num_key_value_heads"]) == (
        port.num_heads, port.num_kv_heads)
    assert cfg["hidden_size"] // cfg["num_attention_heads"] == port.head_dim == 128
    assert (cfg["vocab_size"], cfg["rope_theta"], cfg["rms_norm_eps"]) == (
        port.vocab_size, port.rope_theta, port.norm_eps)
    assert cfg["qk_layernorm"] is port.qk_norm is True
    assert cfg["swin_norm"] is port.swin_norm is True
    assert cfg["tie_word_embeddings"] is port.tie_word_embeddings is False
    assert cfg["serving"]["rope_positions"] == port.max_position_embeddings


def test_benchmark_builds_the_ports_34b():
    """The benchmark's DecoderConfig is the port's, with the Lumina
    loader's int8 cache."""
    from port_bench import families
    from sjd_tpu_torch.models.chameleon import chameleon_config

    assert families.model_config(_real()) == dataclasses.replace(
        chameleon_config("34B"), kv_quant=True)


def test_reference_models_every_key():
    from port_bench.reference.decoder import MODELLED, refuse_unmodelled

    cfg = _real()
    refuse_unmodelled(cfg)
    assert set(cfg) <= MODELLED


# -- (b) the port's forward against the reference, in the 34B's shape -----------

PROMPT, WINDOW, STEPS = 12, 16, 3
# bf16 activations and products in the port (a rounding moves a value by up
# to 2^-9 of it) through two post-norm layers and the int8 head leave the
# logits (spread 1) 0.085 (prefill) and 0.102 (windows) from the float32
# reference on this seed, and 0.056-0.102 over five prompt seeds: the
# tolerance keeps half as much again above the largest. The other norm
# placement, in the reference alone, lies 2.2 and 4.6 away on this seed
# (1.35 at the least over the five): over ten times the tolerance.
LOGITS_TOL = 0.15


def _readings(seed: int) -> tuple:
    """(the port's logits, the reference's, the reference's with
    ``swin_norm`` flipped), each row of the prefill and of the windows."""
    from port_bench import families, weights
    from port_bench.reference.decoder import Decoder
    from sjd_tpu_torch.models.adapter import decoder_model_fns

    cfg = _shaped()
    lo, hi = cfg["serving"]["text_ids"]
    ids = torch.randint(lo, hi, (PROMPT + WINDOW * STEPS,),
                        generator=torch.Generator().manual_seed(seed))
    mcfg = dataclasses.replace(families.model_config(cfg), attn_impl="plain")
    fns = decoder_model_fns(mcfg, max_positions=256, device="cpu")
    params = families.program_params(cfg, weights.seed_of(cfg), "cpu")
    kv = fns.init_cache(1, 64)
    valid = torch.ones((1, 64), dtype=torch.bool)
    port = []
    for s, t in [(0, PROMPT)] + [(PROMPT + WINDOW * k, WINDOW) for k in range(STEPS)]:
        logits, kv = fns.forward(params, ids[None, s:s + t].int(),
                                 torch.arange(s, s + t)[None].int(), kv,
                                 torch.tensor([s], dtype=torch.int32), valid)
        port.append(logits[0])

    def reference(c):
        dec = Decoder(c, "cpu")
        hid, _ = dec.hidden([(ids, torch.arange(len(ids)))])
        return dec.logits(hid[0])

    return torch.cat(port), reference(cfg), reference(dict(cfg, swin_norm=False))


@pytest.fixture(scope="module")
def readings():
    return _readings(23)


ROWS = {"prefill": slice(0, PROMPT), "windows": slice(PROMPT, None)}


@pytest.mark.parametrize("rows", sorted(ROWS))
def test_port_forward_agrees_with_reference(readings, rows):
    port, ref, _ = readings
    assert port.shape == ref.shape == (PROMPT + WINDOW * STEPS, 65536)
    assert float((port[ROWS[rows]] - ref[ROWS[rows]]).abs().max()) < LOGITS_TOL


@pytest.mark.parametrize("rows", sorted(ROWS))
def test_other_norm_placement_fails_by_tenfold(readings, rows):
    port, _, flipped = readings
    assert float((port[ROWS[rows]] - flipped[ROWS[rows]]).abs().max()) > 10 * LOGITS_TOL


# -- (c) what the roofline functions count at the 34B's widths -------------------


def _dims():
    from port_bench.roofline.shapes import model_dims

    return model_dims(_real())


def test_seven_products_per_layer():
    from port_bench.roofline.shapes import projections

    # wq, wk, wv, wo, w_gate, w_up, w_down as (N, K)
    assert projections(_dims()) == [(8192, 8192), (1024, 8192), (1024, 8192), (8192, 8192),
                                    (22016, 8192), (22016, 8192), (8192, 22016)]


def test_weight_bytes_per_forward():
    """Packed int4 projections (N K / 2) and bf16 row scales over 48 layers,
    and the int8 head with its scales: 17.15 GB a forward."""
    from port_bench.roofline.step_bytes import weight_bytes

    per_layer = sum(n * k // 2 + 2 * n for n, k in [(8192, 8192), (1024, 8192), (1024, 8192),
                                                     (8192, 8192), (22016, 8192),
                                                     (22016, 8192), (8192, 22016)])
    head = 65536 * 8192 + 2 * 65536
    assert weight_bytes(_dims()) == 48 * per_layer + head
    assert abs(weight_bytes(_dims()) - 17.15e9) <= 0.001 * 17.15e9


def test_group8_int8_attention_bytes():
    """One layer's attention for two samples of a 16-row window over 600
    and 900 live rows: K and V rows of 8 heads of 128 int8 codes with a
    bf16 scale each, and 64 heads of bf16 queries in and outputs out."""
    from port_bench.roofline.attention import layer_call

    flops, nbytes = layer_call(_dims(), 16, [600, 900])
    assert nbytes == 2 * 1500 * 8 * (128 + 2) + 2 * 2 * 16 * 64 * 128 * 2
    assert flops == 4 * 16 * 64 * 128 * 1500


def _view(prefills, decodes, wall_s):
    from port_bench.account import Work

    quiet = Work(prefills=prefills, decodes=decodes, wall_s=wall_s)
    return types.SimpleNamespace(window=types.SimpleNamespace(quiet=quiet), model=_dims())


def _reader():
    from port_bench import run

    return run.reader("step_hbm_pct", ROOT)


def test_step_hbm_pct_on_a_hand_built_view():
    """A prefill of 2 x 99 rows (head over 2) and 10 decode forwards of 2 x
    16 rows over fills of 600 and 620 rows a forward, in 0.2 s: the bytes
    counted by hand over 0.2 s x 3.35 TB/s."""
    weights = 17153228800
    prods = 48 * 2 * sum(n + k for n, k in [(8192, 8192), (1024, 8192), (1024, 8192),
                                             (8192, 8192), (22016, 8192), (22016, 8192),
                                             (8192, 22016)])  # bf16 in and out, per row
    kv_row = 2 * 8 * (128 + 2)  # K and V of one row, 8 heads, codes and scales
    prefill = (weights + 198 * prods + 2 * 8192 * 2  # the head's 2 rows in, out below
               + 2 * 65536 * 2 + 198 * 8192 * 2 + 48 * 198 * kv_row)
    decode = (weights + 32 * prods + 32 * 8192 * 2 + 32 * 65536 * 2 + 32 * 8192 * 2
              + 48 * (1220 * kv_row + 2 * 2 * 16 * 64 * 128 * 2))
    view = _view([(2, 99, 2)], [(10, 2, 16, [6000.0, 6200.0])], 0.2)
    want = 100.0 * (prefill + 10 * decode) / (0.2 * 3.35e12)
    assert math.isclose(_reader()(view), want, rel_tol=1e-12)
    assert 0 < want <= 100


def test_step_hbm_pct_reads_nothing_without_forwards():
    assert _reader()(_view([], [], 0.0)) is None
    assert _reader()(_view([], [(0, 2, 16, [0.0, 0.0])], 1.0)) is None


# -- (d) the solo entry on the shaped copy, judged by the reference -------------


def _solo(monkeypatch, seconds, flip_program=False):
    from port_bench import families, run

    spec = run.load_spec(CELL)
    assert spec["cell"]["config"] == _real()["name"] and spec["mix"]["entry"] == "solo"
    spec["cfg"] = _shaped()
    # a window holds at least one chunk of 4 steps, so 4 tokens or more are
    # judged however slow a CPU shared with other test processes is (a whole
    # 64px image is 21 tokens; such a CPU served 11 in 8 s)
    spec["mix"] = dict(spec["mix"], image_px=64, prompt_len=[4, 8], window=4, pool=3,
                       image_top_k=50, text_top_k=5, chunk_steps=4, check_min_tokens=4)
    # loose enough for bf16 logits of a 2-layer model on the CPU; the chip's
    # limits are the cell file's
    spec["cellfile"] = {"limits": {"mean_gap": 0.1, "vq_mean_abs": 1.0, "vq_max_abs": 255}}
    if flip_program:
        real = families.model_config
        monkeypatch.setattr(families, "model_config", lambda cfg, act_quant="bf16": (
            dataclasses.replace(real(cfg, act_quant), swin_norm=not cfg["swin_norm"])))
    torch.manual_seed(0)
    return run.run_cell(spec, 2**33 + 23, seconds, False, "cpu")


def test_solo_entry_is_correct(monkeypatch):
    r = _solo(monkeypatch, 8.0)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["checks"]["requests_checked"]["value"] >= 1
    assert r["checks"]["grammar_misses"]["value"] == 0


def test_solo_entry_with_pre_norm_program_is_not_correct(monkeypatch):
    """The program's layers with the other norm placement: ``correct`` is
    false by the gaps of its decisions, whatever the window's length."""
    r = _solo(monkeypatch, 4.0, flip_program=True)
    assert not r["correct"], r["checks"]
    gap = r["checks"]["mean_gap"]
    assert gap["value"] > gap["limit"], r["checks"]
