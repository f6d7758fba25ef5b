"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode, so every test here is marked ``gpu``
and skips without a CUDA device. This file imports no JAX (the machine with
the card has none); run it there with

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: both versions compute in f32 and round the output to bf16 once,
but sum in another order, so a bf16 output may differ by one rounding
(2^-8 relative) plus f32 reassociation, and an int8 code by one step."""

import pytest
import torch

from sjd_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from sjd_tpu_torch.ops.fused_epilogue import fused_epilogue, fused_epilogue_plain, quantize_rows

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU mode")
    return torch.device("cuda")


def _bf16_close(got, want):
    err = (got.float() - want.float()).abs().max().item()
    bound = 2 ** -7 * want.float().abs().max().item() + 1e-3
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("qk_norm,quantize", [(True, True), (False, True), (True, False)])
def test_epilogue_kernel_matches_plain(cuda, qk_norm, quantize):
    S, T, H, Hkv, D = 2, 16, 32, 32, 128
    g = torch.Generator(device=cuda).manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g, device=cuda)  # noqa: E731
    qp, kp, vp = (r(S, T, n * D).to(torch.bfloat16) for n in (H, Hkv, Hkv))
    norms = [(1 + 0.1 * r(n, D)).to(torch.bfloat16) if i % 2 == 0 else
             (0.1 * r(n, D)).to(torch.bfloat16) for i, n in enumerate((H, H, Hkv, Hkv))]
    ang = 3 * torch.rand((S, T, D), generator=g, device=cuda)
    args = (qp, kp, vp, *norms, ang.cos(), ang.sin())
    kw = dict(num_heads=H, num_kv_heads=Hkv, head_dim=D, qk_norm=qk_norm,
              quantize=quantize)
    before = fused_epilogue.launches
    got = fused_epilogue(*args, **kw)
    want = fused_epilogue_plain(*args, **kw)
    torch.cuda.synchronize()
    assert fused_epilogue.launches == before + 1
    _bf16_close(got[0], want[0])
    if quantize:
        for a, b in zip(got[1:3], want[1:3]):
            assert a.dtype == torch.int8 and (a.int() - b.int()).abs().max().item() <= 1
        for a, b in zip(got[3:], want[3:]):
            torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -7, atol=0)
    else:
        for a, b in zip(got[1:3], want[1:3]):
            _bf16_close(a, b)


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("shape", [
    (2, 16, 32, 32, 128, 3, 1536),  # main-path heads, 3 layers
    (2, 16, 8, 2, 64, 2, 1100),     # GQA group 4, head_dim 64, ragged last tile
    (1, 1, 4, 4, 128, 1, 64),       # one-row window
], ids=["mha128", "gqa64_odd", "w1"])
def test_attention_kernel_matches_plain(cuda, quantize, shape):
    S, W, H, Hkv, D, NL, L = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((S, W, H, D), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((S, NL, L, Hkv, D), generator=g, device=cuda)
    v = torch.randn((S, NL, L, Hkv, D), generator=g, device=cuda)
    ks = vs = None
    if quantize:
        k, ks = quantize_rows(k)
        v, vs = quantize_rows(v)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    ends = [min(L - W, x) for x in (700, 37)][:S]
    cache_end = torch.tensor(ends, dtype=torch.int32, device=cuda)
    valid = torch.ones((S, L), dtype=torch.bool, device=cuda)
    valid[-1, :20] = False  # masked prompt rows
    for layer in range(NL):
        got = decode_attention(q, k, v, ks, vs, cache_end, valid, window=W, layer=layer)
        want = decode_attention_plain(q, k, v, ks, vs, cache_end, valid, layer=layer)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        _bf16_close(got, want)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 4, 2, 128), dtype=torch.float32, device=cuda)
    k = torch.zeros((1, 1, 64, 2, 128), dtype=torch.bfloat16, device=cuda)
    ce = torch.zeros((1,), dtype=torch.int32, device=cuda)
    valid = torch.ones((1, 64), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):  # f32 queries: the kernel is bf16
        decode_attention(q, k, k, None, None, ce, valid, window=4, layer=0)
    with pytest.raises(ValueError):  # head_dim 8 is not compiled
        decode_attention(q[..., :8].to(torch.bfloat16).contiguous(), k[..., :8].contiguous(),
                         k[..., :8].contiguous(), None, None, ce, valid, window=4, layer=0)


def test_forward_kernel_path_matches_plain_path(cuda):
    """A 2-layer Chameleon-shaped decoder (heads of 128, int8 cache): a
    prefill and a window through the kernels against attn_impl="plain"."""
    import dataclasses

    from sjd_tpu_torch.models import transformer as pt

    cfg = pt.DecoderConfig(vocab_size=1024, hidden_size=512, intermediate_size=1024,
                           num_layers=2, num_heads=4, num_kv_heads=4, head_dim=128,
                           qk_norm=True, kv_quant=True, max_position_embeddings=256)
    params = pt.init_params(0, cfg, device=cuda)
    rope = pt.make_rope_table(cfg, 256, device=cuda)
    S, P, W, L = 2, 12, 16, 64
    gen = torch.Generator(device=cuda).manual_seed(2)
    ids = torch.randint(0, 1024, (S, P + W), generator=gen, device=cuda)
    valid = torch.ones((S, L), dtype=torch.bool, device=cuda)
    valid[1, :P - 1] = False
    pos = torch.clamp_min(torch.cumsum(valid[:, :P].int(), 1) - 1, 0)
    pos_w = pos[:, -1:] + 1 + torch.arange(W, device=cuda)
    outs = []
    for c in (cfg, dataclasses.replace(cfg, attn_impl="plain")):
        kv = pt.init_kv_cache(c, S, L, device=cuda)
        zero = torch.zeros((S,), dtype=torch.int32, device=cuda)
        pt.forward(params, c, ids[:, :P], pos, kv, zero, valid, rope)
        outs.append(pt.forward(params, c, ids[:, P:], pos_w, kv, zero + P, valid,
                               rope).logits)
    err = (outs[0] - outs[1]).abs().max().item()
    assert err <= 0.05 * outs[1].abs().max().item(), err
