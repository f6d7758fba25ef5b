"""Port of the decode attention (sjd_tpu_torch/ops/decode_attention.py)
against the Pallas kernel run in interpret mode, for every case of
tests/test_pallas_ops.py but the tensor-parallel one, on the same numpy
inputs. Tolerance 2e-5 in f32 (the two sum in another order; the Pallas
kernel also merges chunks with an online softmax) and 1e-2 in bf16 (one
rounding of the bf16 output)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sjd_tpu.models.transformer import _quantize_rows as jax_quantize_rows
from sjd_tpu.ops.decode_attention import decode_attention as jax_decode_attention
from sjd_tpu_torch.ops.decode_attention import (
    NEG_INF, decode_attention, decode_attention_plain, decode_masks)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def _case(seed, S, W, H, Hkv, D, L, NL=None):
    rng = np.random.default_rng(seed)
    cache = (S, L, Hkv, D) if NL is None else (S, NL, L, Hkv, D)
    q = rng.standard_normal((S, W, H, D)).astype(np.float32)
    k = rng.standard_normal(cache).astype(np.float32)
    v = rng.standard_normal(cache).astype(np.float32)
    return q, k, v


def _both(q, k, v, cache_end, valid, *, quantize=False, q_bf16=False, chunk=512,
          layer=None):
    W = q.shape[1]
    jq = jnp.asarray(q, jnp.bfloat16 if q_bf16 else jnp.float32)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    jks = jvs = None
    if quantize:
        jk, jks = jax_quantize_rows(jk)
        jv, jvs = jax_quantize_rows(jv)
    want = jax_decode_attention(
        jq, jk, jv, jks, jvs, jnp.asarray(cache_end, jnp.int32), jnp.asarray(valid),
        window=W, layer=layer, chunk=chunk, interpret=True)

    def t(x):
        if x is None:
            return None
        a = np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)
        out = torch.from_numpy(np.array(a))
        return out.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else out

    got = decode_attention(
        t(jq), t(jk), t(jv), t(jks), t(jvs), torch.tensor(cache_end, dtype=torch.int32),
        torch.from_numpy(valid), window=W, layer=layer)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


def _valid(S, L, masked):
    valid = np.ones((S, L), bool)
    for s, n in masked.items():
        valid[s, :n] = False
    return valid


@pytest.mark.parametrize("case", ["fp", "multichunk", "odd_length"])
def test_plain_attention_matches_pallas_fp(case):
    if case == "fp":
        S, W, H, Hkv, D, L, ce, masked, chunk = 2, 4, 4, 2, 8, 64, [10, 20], {1: 5}, 512
    elif case == "multichunk":
        S, W, H, Hkv, D, L, ce, masked, chunk = 2, 4, 8, 2, 8, 64, [9, 37], {0: 3}, 16
    else:  # no power-of-two divisor: the Pallas wrapper searches one
        S, W, H, Hkv, D, L, ce, masked, chunk = 1, 4, 4, 2, 8, 1100, [700], {0: 9}, 512
    q, k, v = _case(0, S, W, H, Hkv, D, L)
    got, want = _both(q, k, v, ce, _valid(S, L, masked), chunk=chunk)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("case", ["int8", "int8_gqa"])
def test_plain_attention_matches_pallas_int8(case):
    if case == "int8":
        S, W, H, Hkv, D, L, ce = 1, 4, 4, 4, 8, 32, [16]
    else:  # group 4: the scales broadcast over the folded window x group rows
        S, W, H, Hkv, D, L, ce = 2, 4, 8, 2, 8, 32, [7, 19]
    q, k, v = _case(1, S, W, H, Hkv, D, L)
    got, want = _both(q, k, v, ce, _valid(S, L, {}), quantize=True)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_plain_attention_matches_pallas_bf16_int8():
    S, W, H, Hkv, D, L = 2, 4, 8, 4, 16, 64
    q, k, v = _case(11, S, W, H, Hkv, D, L)
    got, want = _both(q, k, v, [12, 33], _valid(S, L, {1: 4}), quantize=True,
                      q_bf16=True, chunk=16)
    np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("quantize", [False, True])
def test_plain_attention_stacked_layer_select(quantize):
    S, W, H, Hkv, D, L, NL = 2, 4, 4, 2, 8, 64, 3
    q, k, v = _case(7, S, W, H, Hkv, D, L, NL)
    valid = _valid(S, L, {0: 3})
    for li in range(NL):
        got, want = _both(q, k, v, [10, 40], valid, quantize=quantize, layer=li)
        np.testing.assert_allclose(got, want, **F32_TOL)
        # and the stacked path equals the port's own single-layer call
        got1, _ = _both(q, k[:, li], v[:, li], [10, 40], valid, quantize=quantize)
        np.testing.assert_array_equal(got, got1)


def _split_merge(q, k, v, ks, vs, cache_end, valid, split):
    """A plain mirror of the CUDA kernel's split-K arithmetic: per split of
    ``split`` live cache rows, unnormalised partials (m, l, acc) under the
    finite NEG_INF mask, then the merge m* = max m_i,
    out = sum e^(m_i - m*) acc_i / max(sum e^(m_i - m*) l_i, 1e-37)."""
    S, W, H, D = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    scores = torch.einsum("swhgd,slhd->shgwl", q.reshape(S, W, Hkv, group, D), k)
    kscale = (ks if ks is not None else torch.ones(S, L, Hkv)) / math.sqrt(D)
    scores = scores * kscale.permute(0, 2, 1)[:, :, None, None, :]
    mask = decode_masks(cache_end, valid, W, L)[:, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    vscale = (vs if vs is not None else torch.ones(S, L, Hkv)).permute(0, 2, 1)
    out = torch.empty(S, Hkv, group, W, D)
    for s in range(S):
        n_live = min(int(cache_end[s]) + W, L)
        parts = []
        for c0 in range(0, n_live, split):
            c1 = min(c0 + split, n_live)
            sc = scores[s, ..., c0:c1]
            m = sc.max(-1).values
            p = torch.exp(sc - m[..., None])
            acc = torch.einsum("hgwl,lhd->hgwd", p * vscale[s, :, None, None, c0:c1],
                               v[s, c0:c1])
            parts.append((m, p.sum(-1), acc))
        m_star = torch.stack([m for m, _, _ in parts]).max(0).values
        e = [torch.exp(m - m_star) for m, _, _ in parts]
        num = sum(ei[..., None] * acc for ei, (_, _, acc) in zip(e, parts))
        den = sum(ei * lv for ei, (_, lv, _) in zip(e, parts))
        out[s] = num / torch.clamp_min(den, 1e-37)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(S, W, H, D)


@pytest.mark.parametrize("quantize", [False, True])
def test_split_merge_matches_pallas_and_plain(quantize):
    """Several splits of 16 rows; sample 1 masks its first 20 rows, so its
    first split is wholly masked and must drop out of the merge."""
    S, W, H, Hkv, D, L, split = 2, 4, 8, 2, 8, 64, 16
    ce = [40, 50]
    q, k, v = _case(5, S, W, H, Hkv, D, L)
    valid = _valid(S, L, {1: 20})
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    jks = jvs = None
    if quantize:
        jk, jks = jax_quantize_rows(jk)
        jv, jvs = jax_quantize_rows(jv)
    want = np.asarray(jax_decode_attention(
        jnp.asarray(q), jk, jv, jks, jvs, jnp.asarray(ce, jnp.int32), jnp.asarray(valid),
        window=W, chunk=16, interpret=True))
    t = lambda x: None if x is None else torch.from_numpy(np.asarray(x).astype(np.float32))  # noqa: E731
    qt, kt, vt, kst, vst = torch.from_numpy(q), t(jk), t(jv), t(jks), t(jvs)
    cet, validt = torch.tensor(ce, dtype=torch.int32), torch.from_numpy(valid)
    got = _split_merge(qt, kt, vt, kst, vst, cet, validt, split=split).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    stack = lambda x: None if x is None else x[:, None]  # noqa: E731  (a 1-layer stack)
    plain = decode_attention_plain(qt, stack(kt), stack(vt), stack(kst), stack(vst), cet,
                                   validt, layer=0).numpy()
    np.testing.assert_allclose(got, plain, **F32_TOL)
