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

from sjd_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_plain, partials_numel)
from sjd_tpu_torch.ops.fused_epilogue import (
    fused_epilogue, fused_epilogue_into_cache, fused_epilogue_into_cache_plain,
    fused_epilogue_plain, quantize_rows)

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


def _epilogue_inputs(cuda, S, T, H, Hkv, D, qk_norm):
    """bf16 projections, the four qk-norm tensors (None when off) and f32
    cos/sin, from a seed."""
    g = torch.Generator(device=cuda).manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g, device=cuda)  # noqa: E731
    qp, kp, vp = (r(S, T, n * D).to(torch.bfloat16) for n in (H, Hkv, Hkv))
    norms = [(1 + 0.1 * r(n, D)).to(torch.bfloat16) if i % 2 == 0 else
             (0.1 * r(n, D)).to(torch.bfloat16) for i, n in enumerate((H, H, Hkv, Hkv))]
    ang = 3 * torch.rand((S, T, D), generator=g, device=cuda)
    return (qp, kp, vp, *(norms if qk_norm else [None] * 4), ang.cos(), ang.sin())


@pytest.mark.parametrize("qk_norm,quantize", [(True, True), (False, True), (True, False)])
def test_epilogue_kernel_matches_plain(cuda, qk_norm, quantize):
    """The JAX-shaped fused_epilogue, which goes through the cache-writing
    kernel into a one-layer scratch cache."""
    S, T, H, Hkv, D = 2, 16, 32, 32, 128
    args = _epilogue_inputs(cuda, S, T, H, Hkv, D, True)
    kw = dict(num_heads=H, num_kv_heads=Hkv, head_dim=D, qk_norm=qk_norm,
              quantize=quantize)
    before = fused_epilogue_into_cache.launches
    got = fused_epilogue(*args, **kw)
    want = fused_epilogue_plain(*args, **kw)
    torch.cuda.synchronize()
    assert fused_epilogue_into_cache.launches == before + 1
    _bf16_close(got[0], want[0])
    if quantize:
        for a, b in zip(got[1:3], want[1:3]):
            assert a.dtype == torch.int8 and (a.int() - b.int()).abs().max().item() <= 1
        for a, b in zip(got[3:], want[3:]):
            torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -7, atol=0)
    else:
        for a, b in zip(got[1:3], want[1:3]):
            _bf16_close(a, b)


# (S, T, Hq, Hkv, D, NL, L, layer), cache_end per sample
EPILOGUE_CASES = {
    "main": ((2, 16, 32, 32, 128, 3, 2560, 1), (1200, 37)),  # main-path heads
    "gqa128": ((2, 16, 32, 8, 128, 2, 512, 1), (100, 301)),  # Emu3's 32/8 heads
    "gqa64": ((2, 16, 16, 4, 64, 2, 300, 0), (7, 250)),  # LlamaGen's head width, GQA
    # past L - T, and negative (counts from the end): both clamp to L - T
    "clamped": ((2, 16, 32, 32, 128, 2, 256, 1), (250, -3)),
    "prefill15": ((2, 15, 32, 32, 128, 2, 256, 0), (0, 0)),  # the 15-token prompt
    # one rank's heads at TP=2: the 7B's 16 of 32 (MHA), the 34B's 32 query
    # heads over 4 KV heads (GQA group 8)
    "tp2_7b": ((2, 16, 16, 16, 128, 3, 2560, 1), (1200, 37)),
    "tp2_34b": ((2, 16, 32, 4, 128, 2, 2560, 1), (2400, 150)),
    # Chameleon-34B: 64 query heads over 8 KV heads, 48 layers, the last one
    "chameleon34b": ((2, 16, 64, 8, 128, 48, 2560, 47), (2400, 150)),
    # Emu3-Gen 8B: 32 query heads over 8 KV heads, 32 layers, a 720px
    # image's buffer (8.2k generated rows), the last layer
    "emu3": ((2, 16, 32, 8, 128, 32, 8704, 31), (8190, 40)),
    # LlamaGen GPT-XL: 20 heads of 64 (MHA), 36 layers, a 512px image's
    # buffer behind 120 caption rows, the last layer; the cos/sin rows come
    # from the 2-D table (ROPE_2D_CASES): sample 1's window lies in the
    # caption rows, which do not rotate
    "llamagen_xl": ((2, 16, 20, 20, 64, 36, 1280, 35), (1140, 100)),
    # LlamaGen GPT-3B: 32 heads of 100 (MHA), 24 layers, a 384px c2i
    # image's buffer (one class row, a 24 x 24 grid), the last layer;
    # sample 1's window starts at the class row, which does not rotate
    "llamagen_3b": ((2, 16, 32, 32, 100, 24, 1024, 23), (600, 0)),
}
# the cases whose cos/sin rows come from a LlamaGen 2-D table: (size, grid
# rows, condition rows)
ROPE_2D_CASES = {"llamagen_xl": ("GPT-XL", 1024, 120), "llamagen_3b": ("GPT-3B", 576, 1)}


def _rope_2d_rows(cuda, case, ends, T):
    """cos, sin [S, T, D] of the case's 2-D table at rows ends[s] ..
    ends[s] + T - 1."""
    from sjd_tpu_torch.models.llamagen import llamagen_config
    from sjd_tpu_torch.models.transformer import make_rope_table

    name, block, cls_len = ROPE_2D_CASES[case]
    table = make_rope_table(llamagen_config(name, block_size=block, cls_token_num=cls_len),
                            cls_len + block + 64, device=cuda)
    pos = torch.tensor(ends, device=cuda)[:, None] + torch.arange(T, device=cuda)
    return table[pos, 0].contiguous(), table[pos, 1].contiguous()


def _sentinel_caches(cuda, S, NL, L, Hkv, D, quantize):
    """k, v, k_scale, v_scale filled with values the kernel never writes."""
    if quantize:
        k = torch.full((S, NL, L, Hkv, D), -128, dtype=torch.int8, device=cuda)
        ks = torch.full((S, NL, L, Hkv), -1.0, dtype=torch.bfloat16, device=cuda)
        return [k, k.clone(), ks, ks.clone()]
    k = torch.full((S, NL, L, Hkv, D), -3.0, dtype=torch.bfloat16, device=cuda)
    return [k, k.clone(), None, None]


@pytest.mark.parametrize("qk_norm", [True, False], ids=["qk_norm", "no_norm"])
@pytest.mark.parametrize("quantize", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("case", list(EPILOGUE_CASES))
def test_epilogue_into_cache_matches_plain(cuda, case, quantize, qk_norm):
    """The cache-writing kernel against its plain version (the epilogue, then
    write_kv_layer): q, the window rows of the caches, and every other row
    left bit-unchanged."""
    (S, T, H, Hkv, D, NL, L, layer), ends = EPILOGUE_CASES[case]
    args = _epilogue_inputs(cuda, S, T, H, Hkv, D, qk_norm)
    if case in ROPE_2D_CASES:
        args = (*args[:7], *_rope_2d_rows(cuda, case, ends, T))
    cache_end = torch.tensor(ends, dtype=torch.int32, device=cuda)
    got_c = _sentinel_caches(cuda, S, NL, L, Hkv, D, quantize)
    want_c = _sentinel_caches(cuda, S, NL, L, Hkv, D, quantize)
    sentinel = [None if c is None else c.clone() for c in got_c]
    kw = dict(layer=layer, num_heads=H, num_kv_heads=Hkv, head_dim=D, qk_norm=qk_norm)
    before = fused_epilogue_into_cache.launches
    q = fused_epilogue_into_cache(*args, *got_c, cache_end, **kw)
    q_want = fused_epilogue_into_cache_plain(*args, *want_c, cache_end, **kw)
    torch.cuda.synchronize()
    assert fused_epilogue_into_cache.launches == before + 1
    _bf16_close(q, q_want)
    starts = [min(max(e + L if e < 0 else e, 0), L - T) for e in ends]
    for got, want, sent in zip(got_c, want_c, sentinel):
        if got is None:
            continue
        win = [(s, layer, slice(st, st + T)) for s, st in enumerate(starts)]
        g = torch.stack([got[i] for i in win])
        w = torch.stack([want[i] for i in win])
        if got.dtype == torch.int8:
            assert (g.int() - w.int()).abs().max().item() <= 1
        elif got.dim() == 4:  # scales
            torch.testing.assert_close(g.float(), w.float(), rtol=2 ** -7, atol=0)
        else:
            _bf16_close(g, w)
        for i in win:
            got[i] = sent[i]
        assert torch.equal(got, sent), "a row outside the window changed"


# (S, W, H, Hkv, D, NL, L), cache_end per sample, masked leading rows per
# sample (the CFG uncond half masks its prompt rows)
ATTENTION_CASES = {
    "mha128": ((2, 16, 32, 32, 128, 3, 1536), (700, 37), (0, 20)),  # main-path heads
    "gqa64_odd": ((2, 16, 8, 2, 64, 2, 1100), (700, 37), (0, 20)),  # GQA group 4, ragged L
    "w1": ((1, 1, 4, 4, 128, 1, 64), (63,), (20,)),  # one-row window
    "mid_tile": ((2, 16, 32, 32, 128, 1, 2560), (1001, 530), (0, 20)),  # ends inside a tile
    "all_live": ((2, 16, 32, 32, 128, 1, 1536), (1520, 1520), (0, 20)),  # cache_end + W == L
    "mostly_dead": ((2, 16, 32, 32, 128, 1, 2560), (40, 5), (0, 3)),  # most splits dead
    "masked_split": ((2, 16, 32, 32, 128, 1, 2560), (1200, 1200), (0, 600)),  # splits masked
    "w32": ((2, 32, 32, 32, 128, 1, 1024), (600, 77), (0, 20)),  # two groups of 16 rows
    # Chameleon-34B: a query group of 8 (128 rows per KV head), 48 layers
    "chameleon34b": ((2, 16, 64, 8, 128, 48, 2560), (2400, 150), (0, 14)),
    # Emu3-Gen 8B: GQA group 4 (64 query rows per KV head), a 720px image's
    # buffer, the negative prompt's half left-padded; fills early, mid, last
    "emu3_fill150": ((2, 16, 32, 8, 128, 2, 8704), (150, 150), (0, 4)),
    "emu3_fill4000": ((2, 16, 32, 8, 128, 2, 8704), (4000, 4000), (0, 4)),
    "emu3_fill8190": ((2, 16, 32, 8, 128, 2, 8704), (8190, 8190), (0, 4)),
    # LlamaGen GPT-XL: MHA, 20 heads of 64 (16 query rows per KV head), a
    # 512px image's buffer, the cond half's caption left-padded by 100 rows;
    # the first window and the last
    "llamagen_xl_fill150": ((2, 16, 20, 20, 64, 2, 1280), (150, 150), (100, 0)),
    "llamagen_xl_fill1140": ((2, 16, 20, 20, 64, 2, 1280), (1140, 1140), (100, 0)),
    # LlamaGen GPT-3B: MHA, 32 heads of 100 (rows of 200 or 100 bytes, not
    # 16-byte aligned), a 384px c2i image's 1024-row buffer; fills early,
    # mid and at the image's last window
    "llamagen_3b_fill150": ((2, 16, 32, 32, 100, 2, 1024), (150, 150), (0, 0)),
    "llamagen_3b_fill400": ((2, 16, 32, 32, 100, 2, 1024), (400, 400), (0, 0)),
    "llamagen_3b_fill600": ((2, 16, 32, 32, 100, 2, 1024), (600, 577), (0, 0)),
    "llamagen_3b_w1": ((2, 1, 32, 32, 100, 1, 1024), (300, 17), (0, 5)),  # the AR step
    # one rank's heads at TP=2 (decode_attention_tp's shapes): the 7B's 16
    # of 32, the 34B's 32 query heads over 4 KV heads
    "tp2_7b": ((2, 16, 16, 16, 128, 3, 1536), (700, 37), (0, 20)),
    "tp2_34b": ((2, 16, 32, 4, 128, 2, 2560), (2400, 150), (0, 14)),
}


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_attention_kernel_matches_plain(cuda, quantize, case):
    (S, W, H, Hkv, D, NL, L), ends, masked = ATTENTION_CASES[case]
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
    cache_end = torch.tensor(ends, dtype=torch.int32, device=cuda)
    valid = torch.ones((S, L), dtype=torch.bool, device=cuda)
    for s, n in enumerate(masked):
        valid[s, :n] = False
    # f32 elements of the wrapper's two allocations: its bf16 output, then
    # the partials scratch
    sizes = (S * W * H * D // 2, partials_numel(S, W, H, Hkv, D, L))
    for layer in range(NL):
        # replay those allocations with NaN-filled tensors and free them: the
        # caching allocator, in the same state, hands the same blocks to the
        # wrapper, so a merge that read a split the kernel did not write (a
        # dead one) would give NaN
        torch.cuda.empty_cache()
        poison = [torch.full((n,), float("nan"), device=cuda) for n in sizes]
        out_ptr = poison[0].data_ptr()
        del poison
        got = decode_attention(q, k, v, ks, vs, cache_end, valid, window=W, layer=layer)
        assert got.data_ptr() == out_ptr  # the replay reached the wrapper
        want = decode_attention_plain(q, k, v, ks, vs, cache_end, valid, layer=layer)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        _bf16_close(got, want)


@pytest.mark.parametrize("quantize", [True, False], ids=["int8", "bf16"])
def test_decode_attention_tp_launches_the_kernel_on_the_shard(cuda, quantize):
    """decode_attention_tp on one rank's heads of the 34B at TP=2 is one
    launch of the kernel on that shard, equal to the plain version."""
    from types import SimpleNamespace

    from sjd_tpu_torch.ops.decode_attention import decode_attention_tp

    S, W, H, Hkv, D, NL, L = 2, 16, 32, 4, 128, 2, 2560
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((S, W, H, D), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((S, NL, L, Hkv, D), generator=g, device=cuda)
    v = torch.randn((S, NL, L, Hkv, D), generator=g, device=cuda)
    ks = vs = None
    if quantize:
        k, ks = quantize_rows(k)
        v, vs = quantize_rows(v)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    cache_end = torch.tensor([2400, 150], dtype=torch.int32, device=cuda)
    valid = torch.ones((S, L), dtype=torch.bool, device=cuda)
    before = decode_attention.launches
    got = decode_attention_tp(q, k, v, ks, vs, cache_end, valid, window=W, layer=1,
                              axis=SimpleNamespace(size=2), num_heads=64, num_kv_heads=8)
    assert decode_attention.launches == before + 1
    want = decode_attention_plain(q, k, v, ks, vs, cache_end, valid, layer=1)
    torch.cuda.synchronize()
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

    def epilogue(D, proj_dtype=torch.bfloat16, layer=0, T=4):
        qp = torch.zeros((1, T, 2 * D), dtype=proj_dtype, device=cuda)
        cos = torch.zeros((1, T, D), dtype=torch.float32, device=cuda)
        cache = torch.zeros((1, 1, 64, 2, D), dtype=torch.bfloat16, device=cuda)
        return fused_epilogue_into_cache(
            qp, qp, qp, None, None, None, None, cos, cos, cache, cache.clone(), None, None,
            ce, layer=layer, num_heads=2, num_kv_heads=2, head_dim=D, qk_norm=False)

    epilogue(128)  # the baseline call is taken
    with pytest.raises(ValueError):  # head_dim 96 is not compiled
        epilogue(96)
    with pytest.raises(ValueError):  # f32 projections: the kernel is bf16
        epilogue(128, torch.float32)
    with pytest.raises(ValueError):  # the cache has one layer
        epilogue(128, layer=1)
    with pytest.raises(ValueError):  # a window longer than the cache
        epilogue(128, T=65)


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


def test_chameleon34b_heads_forward_kernel_path_matches_plain_path(cuda):
    """The 34B's attention shape in a 2-layer decoder: 64 query heads over 8
    KV heads of 128, swin-norm, W4A16 weights (K1), int8 cache; a prefill
    and a window through the kernels against attn_impl="plain"."""
    import dataclasses

    from sjd_tpu_torch.models import transformer as pt
    from sjd_tpu_torch.models.chameleon import chameleon_config

    cfg = dataclasses.replace(chameleon_config("34B"), vocab_size=1024, hidden_size=1024,
                              intermediate_size=2048, num_layers=2, kv_quant=True,
                              max_position_embeddings=256)
    params = pt.quantize_weights(pt.init_params(0, cfg, device=cuda), bits=4, head_bits=8,
                                 config=cfg)
    rope = pt.make_rope_table(cfg, 256, device=cuda)
    S, P, W, L = 2, 12, 16, 64
    gen = torch.Generator(device=cuda).manual_seed(3)
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
    assert torch.isfinite(outs[0]).all()
    assert err <= 0.05 * outs[1].abs().max().item(), err


def test_emu3_heads_forward_kernel_path_matches_plain_path(cuda):
    """Emu3's attention shape in a 2-layer decoder: 32 query heads over 8 KV
    heads of 128, no qk-norm, RoPE theta 1e6 at positions past 8k, W4A16
    weights (K1), int8 cache; a prefill and a window through the kernels
    against attn_impl="plain"."""
    import dataclasses

    from sjd_tpu_torch.models import transformer as pt
    from sjd_tpu_torch.models.emu3 import emu3_config

    cfg = dataclasses.replace(emu3_config(), vocab_size=1024, hidden_size=1024,
                              intermediate_size=2048, num_layers=2, kv_quant=True)
    params = pt.quantize_weights(pt.init_params(0, cfg, device=cuda), bits=4, head_bits=8,
                                 config=cfg)
    rope = pt.make_rope_table(cfg, 9216, device=cuda)
    S, P, W, L = 2, 12, 16, 64
    gen = torch.Generator(device=cuda).manual_seed(4)
    ids = torch.randint(0, 1024, (S, P + W), generator=gen, device=cuda)
    valid = torch.ones((S, L), dtype=torch.bool, device=cuda)
    valid[1, :4] = False  # the shorter negative prompt's left padding
    pos = 8000 + torch.clamp_min(torch.cumsum(valid[:, :P].int(), 1) - 1, 0)
    pos_w = pos[:, -1:] + 1 + torch.arange(W, device=cuda)
    outs = []
    for c in (cfg, dataclasses.replace(cfg, attn_impl="plain")):
        kv = pt.init_kv_cache(c, S, L, device=cuda)
        zero = torch.zeros((S,), dtype=torch.int32, device=cuda)
        pt.forward(params, c, ids[:, :P], pos, kv, zero, valid, rope)
        outs.append(pt.forward(params, c, ids[:, P:], pos_w, kv, zero + P, valid,
                               rope).logits)
    err = (outs[0] - outs[1]).abs().max().item()
    assert torch.isfinite(outs[0]).all()
    assert err <= 0.05 * outs[1].abs().max().item(), err


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_cache", "int8_cache"])
def test_llamagen_heads_forward_kernel_path_matches_plain_path(cuda, kv_quant):
    """GPT-XL's attention shape in a 2-layer decoder: 20 heads of 64 (MHA),
    no qk-norm, the 2-D RoPE table, bf16 weights; a 12-row prefill from
    embeddings (condition rows, 5 of them masked in sample 0) and a window
    of ids at grid positions, through the kernels against attn_impl="plain"."""
    import dataclasses

    from sjd_tpu_torch.models import transformer as pt
    from sjd_tpu_torch.models.llamagen import llamagen_config

    cfg = dataclasses.replace(llamagen_config("GPT-XL", block_size=1024, cls_token_num=12),
                              vocab_size=1024, num_layers=2, kv_quant=kv_quant)
    params = pt.init_params(0, cfg, device=cuda)
    rope = pt.make_rope_table(cfg, 1100, device=cuda)
    S, P, W, L = 2, 12, 16, 64
    gen = torch.Generator(device=cuda).manual_seed(5)
    embeds = 0.02 * torch.randn((S, P, cfg.hidden_size), generator=gen, device=cuda)
    ids = torch.randint(0, 1024, (S, W), generator=gen, device=cuda)
    valid = torch.ones((S, L), dtype=torch.bool, device=cuda)
    valid[0, :5] = False
    pos = torch.clamp_min(torch.cumsum(valid[:, :P].int(), 1) - 1, 0)
    pos_w = pos[:, -1:] + 1 + torch.arange(W, device=cuda)
    outs = []
    for c in (cfg, dataclasses.replace(cfg, attn_impl="plain")):
        kv = pt.init_kv_cache(c, S, L, device=cuda)
        zero = torch.zeros((S,), dtype=torch.int32, device=cuda)
        pt.forward(params, c, torch.zeros((S, P), dtype=torch.int32, device=cuda), pos, kv,
                   zero, valid, rope, inputs_embeds=embeds)
        outs.append(pt.forward(params, c, ids, pos_w, kv, zero + P, valid, rope).logits)
    err = (outs[0] - outs[1]).abs().max().item()
    assert torch.isfinite(outs[0]).all()
    assert err <= 0.05 * outs[1].abs().max().item(), err


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_cache", "int8_cache"])
def test_llamagen_3b_heads_forward_kernel_path_matches_plain_path(cuda, kv_quant):
    """GPT-3B's attention shape in a 2-layer decoder: 32 heads of 100 (MHA),
    the 2-D RoPE table, bf16 weights; a class row's prefill, then a window
    at grid positions, through the kernels against attn_impl="plain"."""
    import dataclasses

    from sjd_tpu_torch.models import transformer as pt
    from sjd_tpu_torch.models.llamagen import llamagen_config

    cfg = dataclasses.replace(llamagen_config("GPT-3B", block_size=576, cls_token_num=1),
                              vocab_size=1024, num_layers=2, kv_quant=kv_quant)
    params = pt.init_params(0, cfg, device=cuda)
    rope = pt.make_rope_table(cfg, 640, device=cuda)
    S, W, L = 2, 16, 64
    gen = torch.Generator(device=cuda).manual_seed(5)
    embeds = 0.02 * torch.randn((S, 1, cfg.hidden_size), generator=gen, device=cuda)
    ids = torch.randint(0, 1024, (S, W), generator=gen, device=cuda)
    valid = torch.ones((S, L), dtype=torch.bool, device=cuda)
    pos = torch.zeros((S, 1), dtype=torch.int32, device=cuda)
    pos_w = (1 + torch.arange(W, device=cuda, dtype=torch.int32)).expand(S, W).contiguous()
    outs = []
    for c in (cfg, dataclasses.replace(cfg, attn_impl="plain")):
        kv = pt.init_kv_cache(c, S, L, device=cuda)
        zero = torch.zeros((S,), dtype=torch.int32, device=cuda)
        pt.forward(params, c, torch.zeros((S, 1), dtype=torch.int32, device=cuda), pos, kv,
                   zero, valid, rope, inputs_embeds=embeds)
        outs.append(pt.forward(params, c, ids, pos_w, kv, zero + 1, valid, rope).logits)
    err = (outs[0] - outs[1]).abs().max().item()
    assert torch.isfinite(outs[0]).all()
    assert err <= 0.05 * outs[1].abs().max().item(), err


# -- the engine's captured decode step --------------------------------------


def _small_lumina(cuda, cuda_graph):
    """A 2-layer decoder with 128-wide heads and an int8 cache behind the
    Lumina engine (grammar, CFG, window 16) at a 128px grid, and its
    15-token prompt."""
    from sjd_tpu_torch.data.item_processor import size_token_id
    from sjd_tpu_torch.models import transformer as pt
    from sjd_tpu_torch.models.chameleon import IMAGE_START_ID, lumina_engine

    cfg = pt.DecoderConfig(vocab_size=65536, hidden_size=512, intermediate_size=1024,
                           num_layers=2, num_heads=4, num_kv_heads=4, head_dim=128,
                           qk_norm=True, kv_quant=True, max_position_embeddings=1024)
    eng = lumina_engine(model_cfg=cfg, target_size=128, cuda_graph=cuda_graph, device=cuda)
    header = [IMAGE_START_ID, size_token_id(128), size_token_id(128)]
    return eng, list(range(9000, 9012)) + header


def _params(cuda, eng):
    from sjd_tpu_torch.models import transformer as pt

    return pt.init_params(0, eng.model_cfg, device=cuda)


def test_graph_path_equals_eager_path(cuda):
    """24 decode steps through the captured graph (a warm-up step, then 23
    replays) against 24 eager steps from the same seed: tokens, lengths,
    NFE, accept_hist and every byte of the KV cache are equal."""
    states = {}
    for graph in (False, True):
        eng, prompt = _small_lumina(cuda, graph)
        params = _params(cuda, eng)
        ids = torch.tensor([prompt, prompt[3:] + prompt[:3]], device=cuda)
        _, states[graph] = eng.generate(params, 0, ids, max_steps=25, return_state=True)
        if graph:
            assert (eng.stats.captures, eng.stats.replays, eng.stats.eager_steps) == (1, 23, 1)
        else:
            assert eng.stats.captures == 0 and eng.stats.eager_steps == 24
    eager, graph = states[False], states[True]
    assert eager.nfe == graph.nfe == 25
    for name in ("tokens", "length", "accept_hist", "steps_multi", "carried_tokens",
                 "finished"):
        assert torch.equal(getattr(eager, name), getattr(graph, name)), name
    for a, b in zip(eager.kv, graph.kv):
        assert torch.equal(a, b), "KV cache bytes differ"


def test_ar_fast_path_graph_equals_eager(cuda):
    """ar_fast_path=True on the 128px Lumina engine through a whole image:
    the steps past the interval (62 generated tokens) take the width-1
    graph, captured once beside the wide one; the tokens, NFE, accept_hist
    and the KV cache equal the eager run's, and the greedy tokens the
    always-wide graph run's, which bf16 products need not keep bit for bit
    across widths (so only their count of equal tokens is read)."""
    import dataclasses

    runs = {}
    for graph, fast in ((False, True), (True, True), (True, False)):
        eng, prompt = _small_lumina(cuda, graph)
        eng.ar_fast_path = fast
        eng.sampling = dataclasses.replace(eng.sampling, greedy=True)
        params = _params(cuda, eng)
        res, st = eng.generate(params, 0, torch.tensor([prompt], device=cuda),
                               return_state=True)
        runs[graph, fast] = res, st, eng.stats
    (e_res, e_st, e_stats), (g_res, g_st, g_stats), (w_res, _, w_stats) = runs.values()
    assert torch.equal(e_res.tokens, g_res.tokens) and e_res.nfe == g_res.nfe
    assert torch.equal(e_res.accept_hist, g_res.accept_hist)
    for a, b in zip(e_st.kv, g_st.kv):
        assert torch.equal(a, b), "KV cache bytes differ"
    assert g_stats.captures_by_width == {16: 1, 1: 1}, g_stats
    assert g_stats.replays_by_width[1] > 0 and set(e_stats.eager_by_width) == {16, 1}
    assert w_stats.captures_by_width == {16: 1}
    assert (g_res.tokens == w_res.tokens).float().mean().item() > 0.5


def test_refill_under_graph_keeps_live_slot_and_does_not_recapture(cuda):
    eng, prompt = _small_lumina(cuda, True)
    params = _params(cuda, eng)
    ids = torch.tensor([prompt, prompt[1:] + prompt[:1]], device=cuda)
    want = eng.generate(params, 3, ids, max_steps=25)  # 24 decode steps, no refill
    _, state = eng.generate(params, 3, ids, max_steps=13, return_state=True)
    captures = eng.stats.captures
    fresh = torch.tensor([prompt[2:] + prompt[:2]] * 2, device=cuda)
    state = eng.refill(params, state, fresh, [True, False])
    assert state.nfe == 14
    _, state = eng.resume(params, state, max_steps=12, return_state=True)
    assert eng.stats.captures == captures == 1
    n = int(want.length[1])
    assert int(state.length[1]) == n
    assert torch.equal(state.tokens[1, :n], want.tokens[1, :n])
    assert int(state.length[0]) > len(prompt) + 1  # the refilled slot decodes on


def test_second_generate_replays_the_cached_graph(cuda):
    eng, prompt = _small_lumina(cuda, True)
    params = _params(cuda, eng)
    ids = torch.tensor([prompt], device=cuda)
    first = eng.generate(params, 5, ids, max_steps=12)
    second = eng.generate(params, 5, ids, max_steps=12)
    assert eng.stats.captures == 1 and eng.stats.eager_steps == 1
    assert eng.stats.replays == 10 + 11  # warm-up, then replays; then replays only
    assert torch.equal(first.tokens, second.tokens) and first.nfe == second.nfe == 12


def test_new_prompt_width_releases_the_old_state_and_graph(cuda):
    """One state and one graph per engine: another prompt width warms up and
    captures anew over a new state, and the old state can no longer be
    resumed."""
    eng, prompt = _small_lumina(cuda, True)
    params = _params(cuda, eng)
    _, old = eng.generate(params, 5, torch.tensor([prompt], device=cuda), max_steps=4,
                          return_state=True)
    _, new = eng.generate(params, 5, torch.tensor([[0, 0] + prompt], device=cuda),
                          prompt_mask=torch.tensor([[False, False] + [True] * len(prompt)],
                                                   device=cuda),
                          max_steps=4, return_state=True)
    assert eng._state is new and new.tokens.shape[1] == old.tokens.shape[1] + 2
    assert (eng.stats.captures, eng.stats.eager_steps, eng.stats.replays) == (2, 2, 4)
    with pytest.raises(ValueError, match="no longer the engine's own"):
        eng.resume(params, old, max_steps=1)


def test_executed_launches_are_layers_times_forwards(cuda):
    """Each TPU kernel runs once per layer per forward; the capture's
    recorded launches are taken out and each replay's put in
    (GraphStats.executed). bf16 weights launch no quantized product."""
    from sjd_tpu_torch.ops import launch_counts

    eng, prompt = _small_lumina(cuda, True)
    params = _params(cuda, eng)
    before = launch_counts()
    res = eng.generate(params, 0, torch.tensor([prompt], device=cuda), max_steps=20)
    counted = {k: n - before[k] for k, n in launch_counts().items()}
    executed = eng.stats.executed(counted)
    per_forward = {"fused_epilogue": eng.model_cfg.num_layers,
                   "decode_attention": eng.model_cfg.num_layers,
                   "quant_linear_a16": 0, "quant_linear_a8": 0}
    assert eng.stats.captured_launches == per_forward  # the capture records one forward
    assert executed == {k: n * res.nfe for k, n in per_forward.items()}


def test_refill_with_embeddings_under_graph_keeps_live_slot_and_does_not_recapture(cuda):
    """A LlamaGen c2i engine (2 layers of GPT-XL's heads, a 16 x 16 grid) on
    the graph path: slot 0 re-armed from new class embeddings mid-flight
    (the eager small-cache prefill) replays on without a recapture, and
    slot 1's tokens equal a run without the refill."""
    import dataclasses

    from sjd_tpu_torch.models import transformer as pt
    from sjd_tpu_torch.models.llamagen import (
        embed_class, embed_uncond_class, init_cond_params, llamagen_config, llamagen_engine)

    cfg = dataclasses.replace(llamagen_config("GPT-XL", block_size=256, cls_token_num=1),
                              num_layers=2)
    eng = llamagen_engine(latent_size=16, model_cfg=cfg, device=cuda)
    params = pt.init_params(0, cfg, device=cuda)
    cond = init_cond_params(1, cfg, device=cuda)
    kw = dict(prompt_embeds=embed_class(cond, torch.tensor([3, 9], device=cuda), cfg.dtype),
              neg_prompt_embeds=embed_uncond_class(cond, 2, cfg.dtype))
    want = eng.generate(params, 3, max_steps=40, **kw)
    _, state = eng.generate(params, 3, max_steps=20, return_state=True, **kw)
    captures = eng.stats.captures
    fresh = embed_class(cond, torch.tensor([5, 5], device=cuda), cfg.dtype)
    state = eng.refill(params, state, None, [True, False], prompt_embeds=fresh,
                       neg_prompt_embeds=kw["neg_prompt_embeds"])
    assert state.nfe == 21
    # 19 + 20 decode steps, as the 39 of the run without the refill
    _, state = eng.resume(params, state, max_steps=20, return_state=True)
    assert eng.stats.captures == captures == 1
    n = int(want.length[1])
    assert int(state.length[1]) == n
    assert torch.equal(state.tokens[1, :n], want.tokens[1, :n])
    assert int(state.length[0]) > 2  # the refilled slot decodes on


# -- quantized-weight products (csrc/quant_linear.cu) -------------------------


def _quant_inputs(cuda, M, N, K, bits, seed=0):
    """bf16 activations, and a weight quantized as quantize_weights does."""
    from sjd_tpu_torch.models import transformer as pt

    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((N, K), generator=g, device=cuda) / K ** 0.5).to(torch.bfloat16)
    leaf = pt.quantize_int4(w) if bits == 4 else pt.quantize_int8(w)
    return x, leaf["q4p" if bits == 4 else "q"], leaf["s"]


# (M, N, K): the decode window at the 7B's widths, the serve window, the
# MLP's down projection, ragged rows and columns with a partial last chunk,
# one row, a prefill's rows, and the down projection's K with N not a
# multiple of the block's 128 weight rows (86 int4 chunks, which the split
# count does not divide)
QUANT_CASES = {
    "decode": (32, 4096, 4096), "serve": (64, 11008, 4096), "down": (32, 4096, 11008),
    "ragged": (37, 200, 288), "one_row": (1, 72, 160), "prefill": (150, 1000, 4096),
    "ragged_down": (32, 1000, 11008),
}


@pytest.mark.parametrize("a8", [False, True], ids=["a16", "a8"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("case", list(QUANT_CASES))
def test_quant_linear_kernels_match_plain(cuda, case, bits, a8):
    """Each kernel against its plain version: A16 within one bf16 rounding
    (f32 sums in another order), A8 bit-equal (exact int32 sums, the scales
    multiplied in the same order)."""
    from sjd_tpu_torch.models.transformer import _quantize_act
    from sjd_tpu_torch.ops import quant_linear as ql

    M, N, K = QUANT_CASES[case]
    x, q, s = _quant_inputs(cuda, M, N, K, bits)
    if a8:
        xq, xs = _quantize_act(x)
        before = ql.quant_linear_a8.launches
        got = ql.quant_linear_a8(xq, xs, q, s, bits=bits)
        want = ql.quant_linear_a8_plain(xq, xs, q, s, bits=bits)
        assert ql.quant_linear_a8.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    else:
        before = ql.quant_linear_a16.launches
        got = ql.quant_linear_a16(x, q, s, bits=bits)
        want = ql.quant_linear_a16_plain(x, q, s, bits=bits)
        assert ql.quant_linear_a16.launches == before + 1
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        _bf16_close(got, want)


# Emu3-Gen 8B's weights (N, K, bits): wk/wv, w_gate/w_up, w_down, and the
# int8 head of 184622 rows (not a multiple of the block's 128)
EMU3_QUANT_SHAPES = {"wk": (1024, 4096, 4), "w_gate": (14336, 4096, 4),
                     "w_down": (4096, 14336, 4), "lm_head": (184622, 4096, 8)}


@pytest.mark.parametrize("M", [32, 64])
@pytest.mark.parametrize("weight", list(EMU3_QUANT_SHAPES))
def test_quant_linear_a16_emu3_shapes_match_plain(cuda, weight, M):
    """K1 at Emu3's weight shapes and the generate and serve windows' rows,
    within one bf16 rounding of its plain version."""
    from sjd_tpu_torch.ops import quant_linear as ql

    N, K, bits = EMU3_QUANT_SHAPES[weight]
    x, q, s = _quant_inputs(cuda, M, N, K, bits, seed=M)
    before = ql.quant_linear_a16.launches
    got = ql.quant_linear_a16(x, q, s, bits=bits)
    want = ql.quant_linear_a16_plain(x, q, s, bits=bits)
    assert ql.quant_linear_a16.launches == before + 1
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    _bf16_close(got, want)


@pytest.mark.parametrize("a8", [False, True], ids=["a16", "a8"])
@pytest.mark.parametrize("shape", [(4096, 4096), (11008, 4096), (4096, 11008)],
                         ids=["split", "one_split", "down"])
def test_quant_linear_rows_do_not_depend_on_the_row_count(cuda, shape, a8):
    """A row's output is bit-identical whether it is multiplied alone, in a
    decode window (32 rows), a serve window (64) or a prefill (160)."""
    from sjd_tpu_torch.models.transformer import _quantize_act
    from sjd_tpu_torch.ops import quant_linear as ql

    N, K = shape
    x, q, s = _quant_inputs(cuda, 160, N, K, 4, seed=3)

    def run(rows):
        if a8:
            xq, xs = _quantize_act(rows)
            return ql.quant_linear_a8(xq, xs, q, s, bits=4)
        return ql.quant_linear_a16(rows, q, s, bits=4)

    full = run(x)
    for m in (1, 32, 64):
        assert torch.equal(run(x[:m].contiguous()), full[:m]), m
    assert torch.equal(run(x[37:38].contiguous()), full[37:38])


@pytest.mark.parametrize("a8", [False, True], ids=["a16", "a8"])
def test_quant_linear_ragged_cases_are_ragged(cuda, a8):
    """ragged_down's N is not a multiple of the block's weight rows, and its
    chunks are not a multiple of its splits: the edges the cases must reach."""
    from sjd_tpu_torch.ops import quant_linear as ql

    M, N, K = QUANT_CASES["ragged_down"]
    tiles_n, _, g = ql.grid(M, N, K, 4, a8)
    assert N % ql.tile(a8)[0] and g > 1 and (K // 2 // 64) % g, (ql.tile(a8), g)


def _wq_split_call(cuda, a8, seed=5):
    """A product at wq's shape in a generate window (32 rows, int4 4096 x
    4096: several splits), as a call without arguments, and x's device."""
    from sjd_tpu_torch.models.transformer import _quantize_act
    from sjd_tpu_torch.ops import quant_linear as ql

    M, N, K = 32, 4096, 4096
    assert ql.splits(N, K, 4, a8) > 1
    x, q, s = _quant_inputs(cuda, M, N, K, 4, seed=seed)
    if a8:
        xq, xs = _quantize_act(x)
        return (lambda: ql.quant_linear_a8(xq, xs, q, s, bits=4)), x.device
    return (lambda: ql.quant_linear_a16(x, q, s, bits=4)), x.device


@pytest.mark.parametrize("a8", [False, True], ids=["a16", "a8"])
def test_quant_linear_graph_replays_equal_the_eager_call(cuda, a8):
    """The split sum inside the launch, under a CUDA graph: each of three
    replays equals the eager call bit for bit, and every arrival counter is
    0 again afterwards (the next launch and replay find them so)."""
    from sjd_tpu_torch.ops import quant_linear as ql

    call, dev = _wq_split_call(cuda, a8)
    want = call()  # eager: sizes the counters before the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call()
    for _ in range(3):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert torch.equal(call(), want)
    torch.cuda.synchronize()
    assert not ql.counters(dev, 1).any()


def test_quant_linear_capture_does_not_grow_the_counters(cuda, monkeypatch):
    """A call under capture that needs a new or a larger counter buffer
    raises (the buffer is never allocated inside a graph's pool); the same
    call outside a capture grows it and runs."""
    from sjd_tpu_torch.ops import quant_linear as ql

    call, dev = _wq_split_call(cuda, False)
    tiles_n, tiles_m, _ = ql.grid(32, 4096, 4096, 4, False)
    small = torch.zeros(tiles_n * tiles_m - 1, dtype=torch.int32, device=dev)
    for have in ({}, {dev.index: small}):
        monkeypatch.setattr(ql, "_COUNTERS", dict(have))
        with pytest.raises(RuntimeError, match="capture"):
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                call()
        assert ql._COUNTERS.get(dev.index) is have.get(dev.index)  # not grown
    y = call()
    torch.cuda.synchronize()
    assert ql._COUNTERS[dev.index].numel() >= tiles_n * tiles_m
    assert torch.isfinite(y.float()).all()


def test_quant_linear_refuses_what_the_kernel_does_not_take(cuda):
    from sjd_tpu_torch.ops import quant_linear as ql

    x, q, s = _quant_inputs(cuda, 4, 64, 256, 4)
    ql.quant_linear_a16(x, q, s, bits=4)  # the baseline call is taken
    with pytest.raises(ValueError):  # f32 activations: the kernel reads bf16
        ql.quant_linear_a16(x.float(), q, s, bits=4)
    with pytest.raises(ValueError):  # rows of 8 packed bytes: not a multiple of 16
        ql.quant_linear_a16(x[:, :16].contiguous(), q[:, :8].contiguous(), s, bits=4)
    with pytest.raises(ValueError):  # bits 2
        ql.quant_linear_a16(x, q, s, bits=2)
    with pytest.raises(ValueError):  # int8 codes given as packed int4
        ql.quant_linear_a16(x, q.view(torch.int8), s, bits=4)
    with pytest.raises(ValueError):  # the kernel writes bf16 only
        ql.quant_linear_a8(x.to(torch.int8), torch.ones((4, 1), device=cuda), q, s, bits=4,
                           out_dtype=torch.float32)


@pytest.mark.parametrize("act", ["bf16", "int8"], ids=["w4a16", "w4a8"])
def test_quantized_forward_kernel_path_matches_plain_path(cuda, act):
    """A 2-layer Chameleon-shaped decoder on W4A16 / W4A8 weights (int8
    head): a 12-row prefill and a window through the kernels against
    attn_impl="plain" (plain attention and plain quantized products)."""
    import dataclasses

    from sjd_tpu_torch.models import transformer as pt
    from sjd_tpu_torch.ops import quant_linear as ql

    cfg = pt.DecoderConfig(vocab_size=1024, hidden_size=512, intermediate_size=1024,
                           num_layers=2, num_heads=4, num_kv_heads=4, head_dim=128,
                           qk_norm=True, kv_quant=True, act_quant=act,
                           max_position_embeddings=256)
    params = pt.quantize_weights(pt.init_params(0, cfg, device=cuda), bits=4, head_bits=8,
                                 config=cfg)
    rope = pt.make_rope_table(cfg, 256, device=cuda)
    S, P, W, L = 2, 12, 16, 64
    gen = torch.Generator(device=cuda).manual_seed(2)
    ids = torch.randint(0, 1024, (S, P + W), generator=gen, device=cuda)
    valid = torch.ones((S, L), dtype=torch.bool, device=cuda)
    pos = torch.arange(P, device=cuda).expand(S, P)
    pos_w = P + torch.arange(W, device=cuda).expand(S, W)
    outs = []
    for c in (cfg, dataclasses.replace(cfg, attn_impl="plain")):
        kernel = ql.quant_linear_a8 if act == "int8" else ql.quant_linear_a16
        before = kernel.launches
        kv = pt.init_kv_cache(c, S, L, device=cuda)
        zero = torch.zeros((S,), dtype=torch.int32, device=cuda)
        pt.forward(params, c, ids[:, :P], pos, kv, zero, valid, rope)
        outs.append(pt.forward(params, c, ids[:, P:], pos_w, kv, zero + P, valid,
                               rope).logits)
        # 7 products per layer and the head, in each of the two forwards
        assert kernel.launches - before == (0 if c.attn_impl == "plain" else 2 * (7 * 2 + 1))
    err = (outs[0] - outs[1]).abs().max().item()
    assert err <= 0.05 * outs[1].abs().max().item(), err


def test_quantized_graph_path_equals_eager_path(cuda):
    """The captured decode step on W4A16 weights: 12 steps replayed against
    12 eager ones, tokens and KV bytes equal."""
    from sjd_tpu_torch.models import transformer as pt

    states = {}
    for graph in (False, True):
        eng, prompt = _small_lumina(cuda, graph)
        params = pt.quantize_weights(_params(cuda, eng), bits=4, head_bits=8,
                                     config=eng.model_cfg)
        ids = torch.tensor([prompt], device=cuda)
        _, states[graph] = eng.generate(params, 0, ids, max_steps=13, return_state=True)
    for name in ("tokens", "length", "accept_hist"):
        assert torch.equal(getattr(states[False], name), getattr(states[True], name)), name
    for a, b in zip(states[False].kv, states[True].kv):
        assert torch.equal(a, b), "KV cache bytes differ"


# -- evaluation: the towers and the batched harness on the card ---------------


def test_inception_extractor_card_equals_cpu(cuda, tmp_path, monkeypatch):
    """The checkpoint-file extractor (bilinear resize to 299, the trunk) on
    the card against the CPU in f32 (TF32 off): rtol 2e-3 / atol 2e-4, the
    CPU tests' tolerance against the JAX package."""
    import numpy as np

    from sjd_tpu_torch.eval.inception import (
        make_inception_extractor_from_ckpt, synth_inception_state_dict)

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    path = str(tmp_path / "inception.pt")
    torch.save({k: torch.from_numpy(v) for k, v in synth_inception_state_dict(0).items()}, path)
    imgs = np.random.RandomState(0).rand(3, 128, 128, 3).astype(np.float32)
    got = make_inception_extractor_from_ckpt(path, batch=2, device=cuda)(imgs)
    want = make_inception_extractor_from_ckpt(path, batch=2, device="cpu")(imgs)
    assert got.shape == (3, 2048) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_clip_towers_card_equal_cpu(cuda, monkeypatch):
    """Both CLIP towers at ViT-B/32's widths with 2 layers each, on the card
    against the CPU in f32 (TF32 off), within 1e-4."""
    import dataclasses

    import numpy as np

    from sjd_tpu_torch.eval import clip as pclip

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    full = pclip.CLIPConfig.vit_b32()
    cfg = dataclasses.replace(full, vision=dataclasses.replace(full.vision, layers=2),
                              text=dataclasses.replace(full.text, layers=2))
    sd = pclip.synth_clip_state_dict(cfg, 0)
    rs = np.random.RandomState(0)
    px = torch.from_numpy(rs.randn(2, 224, 224, 3).astype(np.float32))
    ids = torch.from_numpy(rs.randint(1, 49000, size=(3, 77)))
    ids[:, 20] = 49407  # the eot
    outs = []
    for dev in (cuda, torch.device("cpu")):
        params = pclip.port_clip(sd, cfg, device=dev)
        outs.append((pclip.clip_image_features(params, cfg, px.to(dev)).cpu(),
                     pclip.clip_text_features(params, cfg, ids.to(dev)).cpu()))
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_batched_harness_through_the_graph_equals_eager(cuda, tmp_path):
    """run_prompt_set_batched in token mode on the 128px Lumina engine: 3
    records through 2 slots on the captured decode step give the same PNGs
    as on an eager engine (per-slot seeds; graph and eager steps are
    bit-equal), and a second run skips them all."""
    import os

    import numpy as np

    from sjd_tpu_torch.eval.datasets import PromptRecord
    from sjd_tpu_torch.eval.harness import run_prompt_set_batched
    from sjd_tpu_torch.utils.image_io import read_png

    def image_of(toks):
        px = (np.asarray(toks[-48:], np.int64) % 256).astype(np.uint8)
        return np.stack([px.reshape(6, 8)] * 3, axis=-1)

    class Model:
        def __init__(self, graph):
            self.engine, prompt = _small_lumina(cuda, graph)
            self.params = _params(cuda, self.engine)
            self.extras = {"prompt_ids_fn": lambda p: prompt[len(p) % 3:],
                           "decode_image_fn": image_of}

    recs = [PromptRecord(index=i, prompt="p" * i) for i in range(3)]
    stats = {}
    for graph in (True, False):
        model = Model(graph)
        wd = str(tmp_path / str(graph))
        stats[graph] = run_prompt_set_batched(model, recs, wd, slots=2, chunk_steps=16,
                                              log_every=0)
        assert stats[graph]["generated"] == 3
        if graph:
            assert model.engine.stats.captures >= 1 and model.engine.stats.replays > 0
        again = run_prompt_set_batched(model, recs, wd, slots=2, log_every=0)
        assert (again["generated"], again["skipped_existing"]) == (0, 3)
    for i in range(3):
        a = read_png(os.path.join(str(tmp_path / "True"), f"{i}.png"))
        b = read_png(os.path.join(str(tmp_path / "False"), f"{i}.png"))
        assert np.array_equal(a, b), i


def test_train_step_card_equals_cpu(cuda, monkeypatch):
    """Four train-step calls (grad_accum 2, clip, decay) on the card, where
    AdamW is the fused CUDA one, against the same calls on the CPU: loss and
    grad norm within rtol 1e-4, the parameters within rtol 1e-4 and 1e-2
    of the rate (tests/test_torch_parallel.py's tolerance: Adam divides
    each gradient by its own scale, so float32 noise in a near-zero
    gradient element reaches its update at that scale; one qk-norm bias
    element moved 2.1e-5 off here on an H100)."""
    from sjd_tpu_torch.models.transformer import DecoderConfig, init_params
    from sjd_tpu_torch.parallel import TrainConfig, make_mesh, make_train_step

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = DecoderConfig(vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
                        num_heads=4, num_kv_heads=4, head_dim=16, qk_norm=True,
                        dtype=torch.float32, max_position_embeddings=64)
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=10, grad_accum=2,
                       grad_clip=1.0, weight_decay=0.1)
    g = torch.Generator().manual_seed(1)
    batches = []
    for _ in range(4):
        ids = torch.randint(0, 256, (2, 24), generator=g)
        labels = ids.clone()
        labels[:, :4] = -100
        batches.append((ids, labels, torch.ones_like(ids, dtype=torch.bool)))
    runs = []
    for dev in ("cpu", cuda):
        init_fn, step_fn = make_train_step(make_mesh(device=dev), cfg, tcfg, device=dev)
        params = init_params(0, cfg, device="cpu")
        state = init_fn(params={k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
                                    else v.to(dev)) for k, v in params.items()})
        metrics = []
        for b in batches:
            state, m = step_fn(state, *b)
            metrics.append({k: float(v) for k, v in m.items()})
        runs.append((metrics, {n: p.detach().cpu() for n, p in state.opt_state.names.items()},
                     state.opt_state.adamw.defaults["fused"]))
    (want_m, want_p, fused_cpu), (got_m, got_p, fused_card) = runs
    assert fused_card and not fused_cpu
    for got, want in zip(got_m, want_m):
        for k in ("loss", "grad_norm", "ce", "z_loss"):
            assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got[k], want[k])
    for n, t in want_p.items():
        torch.testing.assert_close(got_p[n], t, rtol=1e-4, atol=1e-2 * tcfg.learning_rate)


# w_down of one rank at TP=2 (N, K of the whole leaf): the 7B's and the 34B's
TP_DOWN_SHAPES = {"7b": (4096, 11008), "34b": (8192, 22016)}


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("model", list(TP_DOWN_SHAPES))
def test_quant_linear_a16_on_the_repacked_w_down_shard(cuda, model, rank):
    """K1 on a rank's repacked int4 w_down shard (its K half unpacked,
    sliced and packed split-half again: 2752- and 5504-byte rows) against
    the plain version; the two ranks' plain partial products sum to the
    whole leaf's product."""
    from sjd_tpu_torch.ops import quant_linear as ql
    from sjd_tpu_torch.parallel.sharding import packed_column_shard

    N, K = TP_DOWN_SHAPES[model]
    x, q, s = _quant_inputs(cuda, 32, N, K, 4, seed=3)
    shard = packed_column_shard(q, rank, 2)
    assert shard.shape == (N, K // 4)
    xl = x[:, rank * K // 2:(rank + 1) * K // 2].contiguous()
    before = ql.quant_linear_a16.launches
    got = ql.quant_linear_a16(xl, shard, s, bits=4)
    assert ql.quant_linear_a16.launches == before + 1
    want = ql.quant_linear_a16_plain(xl, shard, s, bits=4)
    torch.cuda.synchronize()
    _bf16_close(got, want)
    other = packed_column_shard(q, 1 - rank, 2)
    xo = x[:, (1 - rank) * K // 2:(2 - rank) * K // 2]
    parts = (ql.quant_linear_a16_plain(xl.float(), shard, s.float(), bits=4)
             + ql.quant_linear_a16_plain(xo.float(), other, s.float(), bits=4))
    whole = ql.quant_linear_a16_plain(x.float(), q, s.float(), bits=4)
    torch.testing.assert_close(parts, whole, rtol=1e-4, atol=1e-3)


def test_engine_refuses_a_cuda_graph_under_a_model_axis(cuda):
    """One rank's shard of a model axis of 2 steps eagerly (a gloo
    collective cannot be captured): an engine built with cuda_graph=True
    raises at its first call and says what to pass, before any collective."""
    from sjd_tpu_torch.core.engine import EngineConfig, SJDEngine
    from sjd_tpu_torch.core.grammar import GrammarSpec
    from sjd_tpu_torch.core.processors import SamplingParams
    from sjd_tpu_torch.models import transformer as pt
    from sjd_tpu_torch.models.adapter import decoder_model_fns
    from sjd_tpu_torch.parallel.sharding import LocalParams, ModelAxis

    cfg = pt.DecoderConfig(vocab_size=64, hidden_size=256, intermediate_size=256, num_layers=1,
                           num_heads=2, num_kv_heads=2, head_dim=128,
                           max_position_embeddings=64)
    params = LocalParams(pt.init_params(0, cfg, device=cuda), ModelAxis(None, 0, 2))
    eng = SJDEngine(decoder_model_fns(cfg, max_positions=64, device=cuda),
                    EngineConfig(window=4, scheme="jacobi", max_len=8, cfg_mode="none"),
                    GrammarSpec(kind="none", image_vocab_start=0, image_vocab_end=63),
                    SamplingParams(do_cfg=False, greedy=True, image_top_k=64, text_top_k=64))
    with pytest.raises(ValueError, match="cuda_graph=False"):
        eng.generate(params, 0, torch.tensor([[1, 2, 3]], device=cuda))


def _vq_pair_parts(dev, size=64, batch=2):
    """One G/D pair's losses and gradients of LLAMAGEN_VQ16 (f32, full
    widths) with random LPIPS and PatchGAN (n_layers 3, ndf 64), adaptive
    weight, hinge, disc_start 0, on ``dev`` from weights drawn on the CPU:
    (G aux, G grads, D aux, D grads, recon). The D half takes the CPU's
    recon when given one, so a near tie in the quantizer cannot make the
    two devices' D inputs differ."""
    import dataclasses

    import numpy as np

    from sjd_tpu_torch.models.vq import train as vt
    from sjd_tpu_torch.models.vq.discriminator import PatchGANConfig, init_patchgan_params
    from sjd_tpu_torch.models.vq.lpips import init_lpips_params
    from sjd_tpu_torch.models.vq.taming import LLAMAGEN_VQ16, init_vq_params

    cfg = dataclasses.replace(LLAMAGEN_VQ16, dtype=torch.float32)
    tcfg = vt.VQTrainConfig(recon_loss="l2", perceptual_weight=1.0, disc_start=0,
                            disc_weight=0.5, disc_adaptive_weight=True)
    dcfg = PatchGANConfig(n_layers=3)
    to = vt._tree_map

    def move(tree):
        return to(lambda t: t.to(dev).requires_grad_(t.is_floating_point()), tree)

    params = move(init_vq_params(0, cfg, device="cpu"))
    d_params = move(init_patchgan_params(2, dcfg, device="cpu"))
    lp = to(lambda t: t.to(dev), init_lpips_params(1, device="cpu"))
    x = torch.from_numpy(np.tanh(np.random.RandomState(0).randn(batch, size, size, 3))
                         .astype(np.float32)).to(dev)
    loss, g_aux = vt.generator_loss(params, d_params, x, 0, cfg, tcfg, lpips_params=lp,
                                    disc_cfg=dcfg)
    g_grads = torch.autograd.grad(loss, vt.tree_leaves(params))
    with torch.no_grad():
        recon, _ = vt._vq_forward(params, cfg, x)
    return to(torch.detach, g_aux), g_grads, recon, (d_params, x, tcfg, dcfg)


def _vq_d_parts(recon, d_args):
    from sjd_tpu_torch.models.vq import train as vt

    d_params, x, tcfg, dcfg = d_args
    loss, d_aux = vt.discriminator_loss(d_params, x, recon.to(x.device), 0, tcfg, disc_cfg=dcfg)
    return vt._tree_map(torch.detach, d_aux), torch.autograd.grad(loss, vt.tree_leaves(d_params))


def test_vq_train_pair_card_equals_cpu(cuda, monkeypatch):
    """One G/D pair's losses and gradients at VQ-16's widths on 64 px, batch
    2, in f32 on the card (cuDNN's TF32 off) against the CPU: each loss
    within rtol 1e-3 (the logits' means, near 0, within 1e-4 absolute), each
    gradient leaf within 1e-2 of its largest magnitude (leaves whose
    gradient cancels to 1e-3-1e-4 of the largest, biases before a
    normalization, differ by 2.3e-3 of theirs on an H100), a leaf whose CPU
    gradient is under 1e-6 of the largest (0 in exact arithmetic: attention
    key biases) under that on the card too."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    want_g, want_gg, recon, want_d_args = _vq_pair_parts("cpu")
    got_g, got_gg, _, got_d_args = _vq_pair_parts(cuda)
    want_d, want_dg = _vq_d_parts(recon, want_d_args)
    got_d, got_dg = _vq_d_parts(recon, got_d_args)
    for want, got in ((want_g, got_g), (want_d, got_d)):
        for k, w in want.items():
            g, w = float(got[k]), float(w)
            tol = 1e-4 if k.startswith("logits_") else 1e-3 * abs(w)
            assert abs(g - w) <= tol, (k, g, w)
    for wants, gots in ((want_gg, got_gg), (want_dg, got_dg)):
        top = max(float(w.abs().max()) for w in wants)
        for i, (w, g) in enumerate(zip(wants, gots)):
            err = float((g.cpu() - w).abs().max())
            bound = 1e-6 * top if w.abs().max() <= 1e-6 * top else 1e-2 * float(w.abs().max())
            assert err <= bound, (i, err, bound, float(w.abs().max()) / top)


def test_vq_train_steps_run_fused_on_the_card(cuda):
    """make_vqgan_train_steps on the card: both optimizers fused, two pairs
    leave no gradient on the other network's leaves, EMA and D move."""
    import dataclasses

    import numpy as np

    from sjd_tpu_torch.models.vq import train as vt
    from sjd_tpu_torch.models.vq.discriminator import PatchGANConfig
    from sjd_tpu_torch.models.vq.lpips import init_lpips_params
    from sjd_tpu_torch.models.vq.taming import LLAMAGEN_VQ16, init_vq_params

    cfg = dataclasses.replace(LLAMAGEN_VQ16, dtype=torch.float32)
    tcfg = vt.VQTrainConfig(recon_loss="l2", disc_start=0, disc_adaptive_weight=True)
    init_fn, g_step, d_step = vt.make_vqgan_train_steps(
        cfg, tcfg, lpips_params=init_lpips_params(1, device=cuda),
        disc_cfg=PatchGANConfig(n_layers=3))
    params = init_vq_params(0, cfg, device=cuda)
    g_opt, d_params, d_opt, ema = init_fn(params, 2)
    assert g_opt.defaults["fused"] and d_opt.defaults["fused"]
    d0 = [t.detach().clone() for t in vt.tree_leaves(d_params)]
    e0 = [t.detach().clone() for t in vt.tree_leaves(ema)]
    x = torch.from_numpy(np.tanh(np.random.RandomState(1).randn(2, 64, 64, 3))
                         .astype(np.float32)).to(cuda)
    for step in range(2):
        params, g_opt, ema, g_aux = g_step(params, g_opt, ema, d_params, x, step)
        assert all(t.grad is None for t in vt.tree_leaves(d_params))
        d_params, d_opt, d_aux = d_step(d_params, d_opt, params, x, step)
        assert all(t.grad is None for t in vt.tree_leaves(params))
        assert all(np.isfinite(float(v)) for v in {**g_aux, **d_aux}.values())
    assert any(not torch.equal(a, b) for a, b in zip(d0, vt.tree_leaves(d_params)))
    assert any(not torch.equal(a, b) for a, b in zip(e0, vt.tree_leaves(ema)))
