"""Quantized weights in the port (sjd_tpu_torch/models/transformer.py,
ops/quant_linear.py, convert.py, loader.py) against sjd_tpu on the same numpy
inputs.

The JAX side runs under ``jax.jit``, as its loader and quant_eval run it:
XLA then folds the constant divisions ``amax / 127`` and ``amax / 7`` into
multiplies by the f32 reciprocals, which the port computes too. (Run
eagerly, JAX divides, and a tie can round one code the other way.) On these
terms the quantized bytes and scales are equal, bit for bit.

Tolerances: a W*A16 product sums in f32 in another order than XLA's, so its
output may differ by one rounding of the output dtype at the output's
magnitude; a W*A8 product sums exactly (int32 in JAX, float64 in the plain
version) and multiplies the scales in the same order, so it is equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import TINY
from sjd_tpu.models import init_params as jax_init_params
from sjd_tpu.models import transformer as jt
from sjd_tpu_torch.convert import decoder_config_from_jax, params_from_jax, tensor_from_numpy
from sjd_tpu_torch.models import transformer as pt
from sjd_tpu_torch.ops.quant_linear import (
    quant_linear_a8, quant_linear_a8_plain, quant_linear_a16, unpack_int4)

BF16 = dataclasses.replace(TINY, dtype=jnp.bfloat16)


def outlier_params(cfg, seed=0, scale=20.0, n_outlier=3):
    """Random init with a few dominant input columns per projection (the
    regime where equilibration matters; tests/test_quant_fidelity.py)."""
    params = jax_init_params(jax.random.PRNGKey(seed), cfg)
    rs = np.random.RandomState(seed + 1)
    lay = dict(params["layers"])
    for k in ("wq", "wk", "wv", "w_gate", "w_up", "w_down", "wo"):
        w = np.array(lay[k], np.float32)
        w[..., rs.choice(w.shape[-1], n_outlier, replace=False)] *= scale
        lay[k] = jnp.asarray(w, lay[k].dtype)
    return dict(params, layers=lay)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_tree_equal(want, got, path=""):
    """A JAX (numpy) tree and a port tree hold the same values, bit for bit."""
    if isinstance(want, dict):
        assert set(want) == set(got), (path, set(want), set(got))
        for k in want:
            assert_tree_equal(want[k], got[k], f"{path}/{k}")
        return
    w = np.asarray(want)
    g = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    if w.dtype.name == "bfloat16":
        w = w.astype(np.float32)
    assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype, w.dtype, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.fixture(scope="module")
def jax_outliers():
    return outlier_params(BF16)


@pytest.fixture(scope="module")
def port_outliers(jax_outliers):
    return params_from_jax(np_tree(jax_outliers), decoder_config_from_jax(BF16), device="cpu")


QUANT_CASES = {
    "int8": dict(bits=8),
    "int4_raw": dict(bits=4, head_bits=8, equilibrate=False),
    "int4_equil": dict(bits=4, head_bits=8, equilibrate=True),
    "int4_head4": dict(bits=4, equilibrate=True),
    "int4_embed8": dict(bits=4, head_bits=8, equilibrate=True, embed_bits=8),
    "int8_no_head": dict(bits=8, quantize_head=False, embed_bits=8),
}


@pytest.mark.parametrize("case", list(QUANT_CASES))
def test_quantize_weights_bytes_equal_jax(jax_outliers, port_outliers, case):
    """Codes, packed bytes and scales of every leaf, and the folded norms."""
    kw = QUANT_CASES[case]
    want = jax.jit(lambda p: jt.quantize_weights(p, config=BF16, **kw))(jax_outliers)
    got = pt.quantize_weights(port_outliers, config=decoder_config_from_jax(BF16), **kw)
    assert_tree_equal(np_tree(want), got)


def test_odd_k_falls_back_to_int8():
    w = np.random.RandomState(3).randn(8, 13).astype(np.float32)
    want = jax.jit(lambda w: jt.quantize_weights({"layers": {"wq": w}}, quantize_head=False,
                                                 bits=4, equilibrate=False))(w)
    got = pt.quantize_weights({"layers": {"wq": torch.from_numpy(w)}}, quantize_head=False,
                              bits=4, equilibrate=False)
    assert set(got["layers"]["wq"]) == {"q", "s"}
    assert_tree_equal(np_tree(want), got)


def test_embed_bits_refuses_tied_embeddings():
    cfg = pt.DecoderConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=1,
                           num_heads=4, num_kv_heads=4, head_dim=8, tie_word_embeddings=True)
    with pytest.raises(ValueError, match="untied"):
        pt.quantize_weights(pt.init_params(0, cfg, device="cpu"), embed_bits=8)


def test_unpack_int4_equals_jax():
    packed = np.random.RandomState(4).randint(0, 256, (3, 5, 24), dtype=np.uint8)
    want = np.asarray(jt.unpack_int4(jnp.asarray(packed)))
    np.testing.assert_array_equal(unpack_int4(torch.from_numpy(packed)).numpy(), want)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_equilibrate_for_int4_equals_jax(dtype):
    """Every folded leaf within a stated tolerance: f32 leaves within 2^-22
    relative (XLA's fused divisions may round once more than IEEE division,
    about 3% of the elements by one ulp), bf16 leaves within one bf16
    rounding (in practice equal: quantize_weights' bytes are)."""
    cfg = dataclasses.replace(TINY, dtype=dtype)
    jp = outlier_params(cfg)
    want = np_tree(jax.jit(lambda p: jt.equilibrate_for_int4(p, cfg))(jp))
    got = pt.equilibrate_for_int4(params_from_jax(np_tree(jp), decoder_config_from_jax(cfg),
                                                  device="cpu"),
                                  decoder_config_from_jax(cfg))
    rtol = 2.0 ** -22 if dtype == jnp.float32 else 2.0 ** -8
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "attn_norm", "mlp_norm"):
        np.testing.assert_allclose(got["layers"][name].float().numpy(),
                                   np.asarray(want["layers"][name], np.float32), rtol=rtol,
                                   atol=0, err_msg=name)
    for name in ("lm_head", "final_norm"):
        np.testing.assert_allclose(got[name].float().numpy(),
                                   np.asarray(want[name], np.float32), rtol=rtol, atol=0)


LINEAR_MODES = {  # (bits, act_quant)
    "w8a16": (8, "bf16"), "w4a16": (4, "bf16"), "w8a8": (8, "int8"), "w4a8": (4, "int8"),
}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", list(LINEAR_MODES))
def test_linear_multi_equals_jax(mode, dtype):
    """Three projections of one input in each mode, against JAX's
    linear_multi under jit: A16 within one rounding of the output dtype at
    the output's magnitude, A8 equal."""
    bits, act = LINEAR_MODES[mode]
    rs = np.random.RandomState(5)
    x = rs.randn(2, 7, 64).astype(np.float32)
    ws = {k: (rs.randn(n, 64) * 0.05).astype(np.float32) for k, n in
          (("wq", 96), ("wk", 48), ("wv", 32))}
    jq = jax.jit(lambda ws: jt.quantize_weights({"layers": ws}, quantize_head=False, bits=bits,
                                                equilibrate=False))(
        {k: jnp.asarray(v, dtype) for k, v in ws.items()})["layers"]
    jq = [jq[k] for k in sorted(jq)]
    xj = jnp.asarray(x, dtype)
    want = jax.jit(lambda x, ws: jt.linear_multi(x, ws, act))(xj, jq)
    tq = [{k: tensor_from_numpy(v, "cpu") for k, v in np_tree(w).items()} for w in jq]
    xt = torch.from_numpy(x).to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    got = pt.linear_multi(xt, tq, act)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        if act == "int8":
            np.testing.assert_array_equal(g, w)
        else:
            eps = 2.0 ** -8 if dtype == jnp.bfloat16 else 2.0 ** -20
            assert np.abs(g - w).max() <= eps * np.abs(w).max(), np.abs(g - w).max()


def test_a8_plain_sums_exactly():
    """The plain A8 product's float64 sum is the exact int32 sum."""
    rs = np.random.RandomState(6)
    xq = rs.randint(-127, 128, (5, 96)).astype(np.int8)
    q = rs.randint(-127, 128, (40, 96)).astype(np.int8)
    xs = np.ones((5, 1), np.float32)
    s = torch.ones(40, dtype=torch.bfloat16)
    got = quant_linear_a8_plain(torch.from_numpy(xq), torch.from_numpy(xs),
                                torch.from_numpy(q), s, bits=8, out_dtype=torch.float32)
    want = (xq.astype(np.int64) @ q.astype(np.int64).T).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors the wrappers are their plain versions and count no
    launch."""
    rs = np.random.RandomState(7)
    w = torch.from_numpy((rs.randn(24, 32) * 0.1).astype(np.float32))
    x = torch.from_numpy(rs.randn(3, 32).astype(np.float32)).to(torch.bfloat16)
    leaf = pt.quantize_int4(w)
    before = (quant_linear_a16.launches, quant_linear_a8.launches)
    y = quant_linear_a16(x, leaf["q4p"], leaf["s"], bits=4)
    xq, xs = pt._quantize_act(x)
    y8 = quant_linear_a8(xq, xs, leaf["q4p"], leaf["s"], bits=4)
    assert (quant_linear_a16.launches, quant_linear_a8.launches) == before
    assert y.shape == y8.shape == (3, 24) and y.dtype == y8.dtype == torch.bfloat16


def test_embed_lookup_int8_equals_jax(jax_outliers, port_outliers):
    want_q = jax.jit(lambda p: jt.quantize_weights(p, bits=8, embed_bits=8))(jax_outliers)
    got_q = pt.quantize_weights(port_outliers, bits=8, embed_bits=8)
    ids = np.asarray([[0, 1, 5], [63, 7, 2]], np.int32)
    for dtype, tdtype in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jt.embed_lookup(want_q, jnp.asarray(ids), dtype), np.float32)
        got = pt.embed_lookup(got_q, torch.from_numpy(ids).long(), tdtype).float().numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tree", ["q4p", "q8", "s4_unpacked"])
def test_params_from_jax_takes_quantized_trees(jax_outliers, tree):
    """Packed int4, int8 (with the int8 embedding) and the unpacked int4 a
    TPU run's persist_int4_params leaves (repacked to q4p): the bytes of
    sjd_tpu's quantize_weights, and the port's forward on them equals its
    forward on the same tree quantized by the port."""
    kw = dict(bits=8, embed_bits=8) if tree == "q8" else dict(bits=4, head_bits=8)
    jq = jax.jit(lambda p: jt.quantize_weights(p, config=BF16, **kw))(jax_outliers)
    packed = np_tree(jq)
    if tree == "s4_unpacked":
        jq = jt.unpack_int4_params(jq)
        assert jq["layers"]["wq"]["q"].dtype == jnp.int4
    cfg = decoder_config_from_jax(BF16)
    got = params_from_jax(np_tree(jq), cfg, device="cpu")
    assert_tree_equal(packed, got)
    with pytest.raises(ValueError, match="stacks"):
        params_from_jax(np_tree(jq), dataclasses.replace(cfg, num_layers=3), device="cpu")


@pytest.mark.parametrize("act", ["bf16", "int8"], ids=["w4a16", "w4a8"])
def test_forward_on_quantized_params_equals_jax(act):
    """The cached forward on equilibrated W4A16 and W4A8 parameters (f32
    activations, as tests/test_torch_transformer.py) against sjd_tpu's
    forward: logits within 1e-3 of their largest magnitude (f32 sums in
    another order; under W4A8 such a difference can move an activation code
    by one)."""
    cfg = dataclasses.replace(TINY, act_quant=act)
    jq = jax.jit(lambda p: jt.quantize_weights(p, config=cfg, bits=4, head_bits=8))(
        outlier_params(TINY))
    pcfg = decoder_config_from_jax(cfg)
    assert pcfg.act_quant == act
    tq = params_from_jax(np_tree(jq), pcfg, device="cpu")
    ids = np.random.RandomState(8).randint(0, 64, (2, 6)).astype(np.int32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    L = 16
    jkv = jt.init_kv_cache(cfg, 2, L)
    valid = np.ones((2, L), bool)
    want = jt.forward(jq, cfg, jnp.asarray(ids), jnp.asarray(pos), jkv,
                      jnp.zeros((2,), jnp.int32), jnp.asarray(valid),
                      jt.make_rope_table(cfg, 64)).logits
    kv = pt.init_kv_cache(pcfg, 2, L, device="cpu")
    got = pt.forward(tq, pcfg, torch.from_numpy(ids), torch.from_numpy(pos.copy()), kv,
                     torch.zeros(2, dtype=torch.int32), torch.from_numpy(valid),
                     pt.make_rope_table(pcfg, 64, device="cpu")).logits
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-3 * np.abs(want).max(), (act, err)


def test_k1_kernels_carry_a_name_the_benchmark_trace_finds():
    """port_bench reads K1's launches out of a device trace by name
    (``port_bench.trace.K1_NAMES``) and counts one launch per product:
    every ``__global__`` kernel of ``csrc/quant_linear.cu`` carries one of
    those names, K1's wgmma kernel among them."""
    import re
    from pathlib import Path

    from port_bench.trace import K1_NAMES

    src = (Path(__file__).resolve().parents[1] / "sjd_tpu_torch" / "csrc"
           / "quant_linear.cu").read_text()
    # __global__ void, its attributes (__launch_bounds__(...) ...), its name
    names = re.findall(r"__global__\s+void\s+(?:__\w+__\((?:[^()]|\([^()]*\))*\)\s*)*"
                       r"(\w+)\s*\(", src)
    assert "quant_linear_kernel_wg" in names, names
    assert "quant_linear_kernel" in names, names
    for name in names:
        assert any(k in name for k in K1_NAMES), name
