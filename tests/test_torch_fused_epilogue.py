"""Port of the fused epilogue (sjd_tpu_torch/ops/fused_epilogue.py) against
the Pallas kernel run in interpret mode, on the same numpy inputs.

Tolerances: int8 K/V codes and every bf16 output must be bit-equal (the
plain version keeps the kernel's cast points and exact divisions). f32
q/k/v are held to 1e-6, as tests/test_pallas_ops.py holds the kernel to
the unfused chain; bf16 scales to one bf16 rounding (rtol 1e-2)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sjd_tpu.ops.fused_epilogue import fused_epilogue as jax_fused_epilogue
from sjd_tpu_torch.ops.fused_epilogue import fused_epilogue


def _inputs(seed, S, T, H, Hkv, D, dtype):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    arrs = dict(
        qp=f(S, T, H * D), kp=f(S, T, Hkv * D), vp=f(S, T, Hkv * D) * 3.0,
        qns=1.0 + 0.1 * f(H, D), qnb=0.1 * f(H, D),
        kns=1.0 + 0.1 * f(Hkv, D), knb=0.1 * f(Hkv, D),
    )
    ang = rng.uniform(0, 3.0, (S, T, D)).astype(np.float32)
    arrs["cos"], arrs["sin"] = np.cos(ang), np.sin(ang)
    jx = {k: jnp.asarray(v, jnp.float32 if k in ("cos", "sin") else dtype)
          for k, v in arrs.items()}
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tx = {k: torch.from_numpy(v).to(torch.float32 if k in ("cos", "sin") else tdt)
          for k, v in arrs.items()}
    return jx, tx


def _run_both(jx, tx, H, Hkv, D, qk_norm, quantize):
    names = ("qns", "qnb", "kns", "knb")
    got = fused_epilogue(
        tx["qp"], tx["kp"], tx["vp"], *[tx[n] if qk_norm else None for n in names],
        tx["cos"], tx["sin"], num_heads=H, num_kv_heads=Hkv, head_dim=D,
        qk_norm=qk_norm, quantize=quantize)
    want = jax_fused_epilogue(
        jx["qp"], jx["kp"], jx["vp"], *[jx[n] if qk_norm else None for n in names],
        jx["cos"], jx["sin"], num_heads=H, num_kv_heads=Hkv, head_dim=D,
        qk_norm=qk_norm, quantize=quantize, interpret=True)
    return got, want


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("qk_norm,quantize", [
    (True, True), (True, False), (False, True), (False, False),
])
def test_plain_epilogue_matches_pallas_f32(qk_norm, quantize):
    S, T, H, Hkv, D = 2, 4, 4, 2, 8
    jx, tx = _inputs(3, S, T, H, Hkv, D, jnp.float32)
    got, want = _run_both(jx, tx, H, Hkv, D, qk_norm, quantize)
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    if quantize:
        np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
        np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
        for g, w in zip(got[3:], want[3:]):
            np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), rtol=1e-2)
    else:
        np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]), rtol=1e-6, atol=1e-6)


def test_plain_epilogue_bit_matches_pallas_bf16():
    """The production dtypes at a head width of 128: bf16 q, int8 K/V and
    bf16 scales all bit-equal."""
    S, T, H, Hkv, D = 2, 4, 2, 2, 128
    jx, tx = _inputs(9, S, T, H, Hkv, D, jnp.bfloat16)
    got, want = _run_both(jx, tx, H, Hkv, D, True, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w, np.float32 if g.dtype
                                                          == torch.bfloat16 else None))


@pytest.mark.parametrize("quantize", [True, False], ids=["int8_cache", "bf16_cache"])
@pytest.mark.parametrize("qk_norm", [True, False], ids=["qk_norm", "no_norm"])
@pytest.mark.parametrize("D", [64, 128])
def test_into_cache_plain_matches_pallas_then_write_kv_layer(quantize, qk_norm, D):
    """The cache-writing entry on the CPU (its plain version) against the
    Pallas kernel in interpret mode followed by the JAX package's
    write_kv_layer, into sentinel-filled stacked caches, GQA (Hq != Hkv).
    Sample 1's cache_end overruns L - T, so its window lands clamped at the
    buffer's end. q and the whole caches are bit-equal."""
    from sjd_tpu.models.transformer import write_kv_layer as jax_write_kv_layer
    from sjd_tpu_torch.ops.fused_epilogue import fused_epilogue_into_cache

    S, T, H, Hkv, NL, L, layer = 2, 4, 4, 2, 3, 12, 1
    ends = np.array([3, L - T + 2], np.int32)
    jx, tx = _inputs(11, S, T, H, Hkv, D, jnp.bfloat16)
    kv_np = np.int8 if quantize else np.float32
    sentinel = np.full((S, NL, L, Hkv, D), -128 if quantize else -3.0, kv_np)
    caches = [sentinel, sentinel]
    if quantize:
        caches += [np.full((S, NL, L, Hkv), -1.0, np.float32)] * 2
    jdt = lambda a: jnp.asarray(a, jnp.int8 if a.dtype == np.int8 else jnp.bfloat16)  # noqa: E731
    tdt = lambda a: torch.from_numpy(a.copy()).to(  # noqa: E731
        torch.int8 if a.dtype == np.int8 else torch.bfloat16)
    tcaches = [tdt(c) for c in caches]
    names = ("qns", "qnb", "kns", "knb")
    kw = dict(num_heads=H, num_kv_heads=Hkv, head_dim=D, qk_norm=qk_norm)

    q = fused_epilogue_into_cache(
        tx["qp"], tx["kp"], tx["vp"], *[tx[n] if qk_norm else None for n in names],
        tx["cos"], tx["sin"], *tcaches, *([None, None] if not quantize else []),
        torch.from_numpy(ends), layer=layer, **kw)
    want = jax_fused_epilogue(
        jx["qp"], jx["kp"], jx["vp"], *[jx[n] if qk_norm else None for n in names],
        jx["cos"], jx["sin"], quantize=quantize, interpret=True, **kw)
    np.testing.assert_array_equal(_np(q), np.asarray(want[0], np.float32))
    for cache, new, got in zip(caches, want[1:], tcaches):
        ref = jax_write_kv_layer(jdt(cache), new, jnp.int32(layer), jnp.asarray(ends))
        np.testing.assert_array_equal(_np(got), np.asarray(ref, got.numpy().dtype
                                                          if got.dtype == torch.int8
                                                          else np.float32))
