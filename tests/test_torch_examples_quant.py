"""The port's quant_fidelity command line (sjd_tpu_torch/examples/
quant_fidelity.py) against examples/quant_fidelity.py on the CPU, both on a
tiny configuration in place of Chameleon-7B's (tests/test_quant_fidelity.py's
widths), run in-process with their argv:

  * the JSON keys, mode, config string and variant names equal the JAX
    script's; KL orders int8 <= int4_equil < int4_raw (the ordering
    tests/test_quant_fidelity.py asserts);
  * the synthetic mode equals the port's compare_quant_variants on the
    same outlier weights and ids;
  * the checkpoint mode agrees with sjd_tpu's compare_quant_variants on the
    same synthesized files and ids: KL and per-layer MSE within 2% (+1e-6
    for the 6 printed decimals), top-1 agreement within one token.

About 16 s here alone, on one torch thread."""

import dataclasses
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from ckpt_synth import save_sharded_safetensors, synth_hf_llama_state_dict
from sjd_tpu import loader as jax_loader
from sjd_tpu.models import DecoderConfig as JaxDecoderConfig
from sjd_tpu.models.quant_eval import compare_quant_variants as jax_compare
from sjd_tpu.utils import port as jax_port
from sjd_tpu_torch.convert import decoder_config_from_jax
from sjd_tpu_torch.examples import quant_fidelity
from test_torch_eval import json_lines, load_example
from test_torch_examples import one_torch_thread  # noqa: F401 - an autouse fixture

QF_CFG = JaxDecoderConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                          num_layers=3, num_heads=4, num_kv_heads=2, head_dim=16,
                          qk_norm=True, dtype=jnp.float32, max_position_embeddings=64)


def test_quant_fidelity_keys_and_modes_equal_jax(monkeypatch, tmp_path, capsys):
    pcfg = decoder_config_from_jax(QF_CFG)
    monkeypatch.setattr(quant_fidelity, "chameleon_config", lambda size, dtype: pcfg)
    monkeypatch.setattr("sjd_tpu.models.chameleon.chameleon_config",
                        lambda size, dtype: QF_CFG)
    monkeypatch.setattr("sjd_tpu.utils.compile_cache.enable_persistent_cache",
                        lambda *a, **k: None)
    flags = ["--layers", "2", "--tokens", "12", "--outlier-scale", "25",
             "--outlier-cols", "4"]
    quant_fidelity.main(flags + ["--device", "cpu"])
    (got,) = json_lines(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["quant_fidelity.py"] + flags)
    load_example("quant_fidelity").main()
    (want,) = json_lines(capsys.readouterr().out)
    assert list(got) == list(want) and got["mode"] == want["mode"] == "synthetic-outliers x25.0"
    assert got["config"] == want["config"] == "64d/128ff/128V x 2L"
    assert list(got["variants"]) == list(want["variants"])
    for name in want["variants"]:
        assert list(got["variants"][name]) == list(want["variants"][name])
    # the synthetic mode is compare_quant_variants on the outlier weights
    from sjd_tpu_torch.models.quant_eval import compare_quant_variants

    cfg2 = dataclasses.replace(pcfg, num_layers=2)
    res = compare_quant_variants(quant_fidelity.outlier_params(cfg2, 0, 25.0, 4, "cpu"),
                                 cfg2, quant_fidelity.fidelity_ids(128, 12))
    assert got["variants"]["int4_raw"]["kl"] == round(res["int4_raw"]["kl"], 6)
    v = got["variants"]
    assert v["int8"]["kl"] <= v["int4_equil"]["kl"] < v["int4_raw"]["kl"]

    # the checkpoint mode against sjd_tpu on the same files and ids
    ckpt = str(tmp_path / "ckpt")
    save_sharded_safetensors(synth_hf_llama_state_dict(QF_CFG, seed=5), ckpt, shards=2)
    quant_fidelity.main(["--ckpt-dir", ckpt, "--tokens", "12", "--device", "cpu"])
    (got,) = json_lines(capsys.readouterr().out)
    assert got["mode"] == "checkpoint" and got["config"] == "64d/128ff/128V x 3L"
    jp = jax_port.port_hf_llama_like(jax_loader._load_sharded_state(ckpt), QF_CFG)
    ids = jnp.asarray(quant_fidelity.fidelity_ids(128, 12).numpy())
    want = jax_compare(jp, QF_CFG, ids)
    for name, w in want.items():
        g = got["variants"][name]
        assert g["kl"] == pytest.approx(w["kl"], rel=2e-2, abs=1e-6), name
        assert g["top1_agree"] == pytest.approx(w["top1_agree"], abs=1 / 12 + 1e-9), name
        np.testing.assert_allclose(g["rel_mse_per_layer"], w["rel_mse_per_layer"],
                                   rtol=2e-2, atol=1e-6)


