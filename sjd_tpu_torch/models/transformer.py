"""Decoder-only transformer with a static KV cache: the inference half of
``sjd_tpu/models/transformer.py`` in PyTorch.

Layout and semantics follow the JAX module:

  * parameters are a dict with stacked per-layer tensors ``[NL, out, in]``
    (torch's weight layout, so ``F.linear`` takes them as they are);
  * the KV cache is sample-major ``[S, NL, L_buf, Hkv, D]``, int8 with
    per-(row, head) bf16 scales when ``kv_quant``; a window is written in
    place at each sample's ``cache_end`` (clamped to ``[0, L_buf - T]``, as
    ``dynamic_update_slice`` clamps) and rejected rows are simply
    overwritten by the next window (no rollback);
  * a window is attended after its K/V rows are written.

``forward`` loops over the layers in Python (the JAX ``lax.scan``) and
updates the cache in place (the JAX version returns a new one). On CUDA
tensors with ``T <= 32`` (decode windows, and prompts that short) the
layer's epilogue and attention go through the hand-written kernels of
``sjd_tpu_torch/ops``, and the epilogue kernel writes the window's K/V rows
into the cache itself; everything else takes the plain chain below and
``write_kv_layer``, as the JAX package's prefill takes XLA code. The
projections stay ``F.linear``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.decode_attention import NEG_INF, decode_attention, decode_masks
from ..ops.fused_epilogue import fused_epilogue_into_cache, quantize_rows, write_kv_layer

Tensor = torch.Tensor
Params = Dict[str, object]

# window width up to which forward() takes the kernels (transformer.py's
# Pallas cutoff: the decode windows, not prompt-length prefills)
KERNEL_MAX_T = 32


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Shape/arch hyperparameters for the generic decoder (the fields of
    sjd_tpu's DecoderConfig that the bf16 inference path reads)."""

    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rope_style: str = "1d"  # "2d" (LlamaGen) is not ported yet
    qk_norm: bool = False
    qk_norm_eps: float = 1e-5
    swin_norm: bool = False
    kv_quant: bool = False
    # "auto": the kernels for CUDA windows of T <= 32, the plain chain
    # elsewhere; "plain": the plain chain everywhere (the JAX "xla" value)
    attn_impl: str = "auto"
    norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    max_position_embeddings: int = 16384

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


class KVCache(NamedTuple):
    """k, v: [S, NL, L_buf, Hkv, D] (int8 when quantized, with
    k_scale/v_scale [S, NL, L_buf, Hkv] bf16). Live rows of sample s are
    [0, cache_end[s])."""

    k: Tensor
    v: Tensor
    k_scale: Optional[Tensor] = None
    v_scale: Optional[Tensor] = None

    @property
    def buf_len(self) -> int:
        return self.k.shape[2]


def init_kv_cache(cfg: DecoderConfig, batch: int, buf_len: int,
                  device=None) -> KVCache:
    dev = resolve_device(device)
    shape = (batch, cfg.num_layers, buf_len, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_quant:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev),
            v_scale=torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev),
        )
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=dev))


_quantize_rows = quantize_rows
_decode_masks = decode_masks


# ---------------------------------------------------------------------------
# RoPE tables
# ---------------------------------------------------------------------------


def rope_table_1d(cfg: DecoderConfig, max_pos: int, device=None) -> Tensor:
    """[max_pos, 2, head_dim] (cos, sin) f32 table, split-half convention."""
    dev = resolve_device(device)
    half = cfg.head_dim // 2
    inv_freq = 1.0 / (
        cfg.rope_theta ** (torch.arange(0, half, dtype=torch.float32, device=dev) / half)
    )
    t = torch.arange(max_pos, dtype=torch.float32, device=dev)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.stack([torch.cos(emb), torch.sin(emb)], dim=1)


def make_rope_table(cfg: DecoderConfig, max_pos: Optional[int] = None,
                    device=None) -> Tensor:
    max_pos = max_pos or cfg.max_position_embeddings
    if cfg.rope_style == "1d":
        return rope_table_1d(cfg, max_pos, device)
    raise ValueError(f"rope_style {cfg.rope_style!r} is not ported")


def _rotate_half(x: Tensor) -> Tensor:
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x: [S, T, H, D]; cos/sin: [S, T, D] f32."""
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    return (x * cos + _rotate_half(x) * sin).to(x.dtype)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_params(rng: Union[int, torch.Generator], cfg: DecoderConfig, *,
                device=None) -> Params:
    """Random parameters with sjd_tpu's shapes and scales, drawn from a
    ``torch.Generator`` (a seed makes one on ``device``). The draws differ
    from ``jax.random``'s; ``convert.params_from_jax`` carries the JAX
    package's own parameters over instead."""
    dev = resolve_device(device)
    if isinstance(rng, torch.Generator):
        gen = rng
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(rng))
    dt = cfg.dtype

    def dense(fan_in, shape):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return w.mul_(1.0 / math.sqrt(fan_in)).to(dt)

    n, d, i = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    layers = {
        "attn_norm": torch.ones((n, d), dtype=dt, device=dev),
        "wq": dense(d, (n, cfg.q_dim, d)),
        "wk": dense(d, (n, cfg.kv_dim, d)),
        "wv": dense(d, (n, cfg.kv_dim, d)),
        "wo": dense(cfg.q_dim, (n, d, cfg.q_dim)),
        "mlp_norm": torch.ones((n, d), dtype=dt, device=dev),
        "w_gate": dense(d, (n, i, d)),
        "w_up": dense(d, (n, i, d)),
        "w_down": dense(i, (n, d, i)),
    }
    if cfg.qk_norm:
        for name, heads in (("q", cfg.num_heads), ("k", cfg.num_kv_heads)):
            layers[f"{name}_norm_scale"] = torch.ones(
                (n, heads, cfg.head_dim), dtype=dt, device=dev)
            layers[f"{name}_norm_bias"] = torch.zeros(
                (n, heads, cfg.head_dim), dtype=dt, device=dev)
    params: Params = {
        "embed": dense(d, (cfg.vocab_size, d)),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=dt, device=dev),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense(d, (cfg.vocab_size, d))
    return params


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def embed_lookup(params: Params, ids: Tensor, dtype: torch.dtype) -> Tensor:
    return params["embed"][ids].to(dtype)


def linear(x: Tensor, w: Tensor) -> Tensor:
    """x [..., in] @ w [out, in] -> [..., out] (the bf16 branch)."""
    return F.linear(x, w)


def linear_multi(x: Tensor, ws) -> list:
    """Several projections of the same input (qkv, gate/up)."""
    return [F.linear(x, w) for w in ws]


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def head_layer_norm(x: Tensor, scale: Tensor, bias: Tensor, eps: float) -> Tensor:
    """Chameleon qk-norm: LayerNorm over head_dim, per-head affine.
    x: [S, T, H, D]; scale/bias: [H, D]."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps)
    return (xn * scale.float() + bias.float()).to(x.dtype)


def _attend(q: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> Tensor:
    """Masked MHA/GQA attention, f32 scores. q [S,T,H,D], k/v [S,L,Hkv,D],
    mask [S,T,L]."""
    S, T, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(S, T, Hkv, H // Hkv, D)
    scores = torch.einsum("sthgd,slhd->shgtl", qg.float(), k.float()) / math.sqrt(D)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("shgtl,slhd->sthgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(S, T, H, D).to(q.dtype)


def _attend_quantized(q: Tensor, k_q: Tensor, v_q: Tensor, k_s: Tensor,
                      v_s: Tensor, mask: Tensor) -> Tensor:
    """Attention over the int8 cache with the per-row scales factored out
    of both products: scores = (q . k_int8) * s_k, out = (p * s_v) . v_int8."""
    S, T, H, D = q.shape
    Hkv = k_q.shape[2]
    qg = q.reshape(S, T, Hkv, H // Hkv, D)
    scores = torch.einsum("sthgd,slhd->shgtl", qg.float(), k_q.to(q.dtype).float())
    scores = scores * (k_s.float().permute(0, 2, 1)[:, :, None, None, :] / math.sqrt(D))
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = probs * v_s.float().permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("shgtl,slhd->sthgd", probs.to(q.dtype).float(),
                       v_q.to(q.dtype).float())
    return out.reshape(S, T, H, D).to(q.dtype)


class ForwardResult(NamedTuple):
    logits: Tensor  # [S, T_out, V] float32
    kv: KVCache


def forward(
    params: Params,
    cfg: DecoderConfig,
    ids: Tensor,  # [S, T] int
    positions: Tensor,  # [S, T] int
    kv: KVCache,  # updated in place
    cache_end: Tensor,  # [S] int32: rows already live in the cache
    valid: Tensor,  # [S, L_buf] bool: attendable-prefix mask
    rope_table: Tensor,  # [P, 2, D] f32
    *,
    logits_tail: Optional[int] = None,
) -> ForwardResult:
    """One forward over a window of T tokens with the static KV cache
    (prefill: T = prompt length, cache_end = 0; SJD: T = window)."""
    S, T = ids.shape
    L_buf = kv.buf_len
    h = embed_lookup(params, ids, cfg.dtype)
    rope = rope_table[positions.long()]  # [S, T, 2, D]
    cos, sin = rope[:, :, 0].contiguous(), rope[:, :, 1].contiguous()
    cache_end = cache_end.to(torch.int32).expand(S).contiguous()
    use_kernels = cfg.attn_impl == "auto" and h.is_cuda and T <= KERNEL_MAX_T
    mask = None if use_kernels else _decode_masks(cache_end, valid, T, L_buf)
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def attn_block(x, p, i):
        qp, kp, vp = linear_multi(x, (p["wq"], p["wk"], p["wv"]))
        if use_kernels:
            # the kernel writes the window's K/V rows into the cache itself
            q = fused_epilogue_into_cache(
                qp, kp, vp,
                p.get("q_norm_scale"), p.get("q_norm_bias"),
                p.get("k_norm_scale"), p.get("k_norm_bias"),
                cos, sin, kv.k, kv.v, kv.k_scale, kv.v_scale, cache_end, layer=i,
                num_heads=H, num_kv_heads=Hkv, head_dim=D, qk_norm=cfg.qk_norm,
                eps=cfg.qk_norm_eps,
            )
            out = decode_attention(q, kv.k, kv.v, kv.k_scale, kv.v_scale,
                                   cache_end, valid, window=T, layer=i)
            return linear(out.reshape(S, T, cfg.q_dim), p["wo"])
        q = qp.reshape(S, T, H, D)
        k = kp.reshape(S, T, Hkv, D)
        v = vp.reshape(S, T, Hkv, D)
        if cfg.qk_norm:
            q = head_layer_norm(q, p["q_norm_scale"], p["q_norm_bias"], cfg.qk_norm_eps)
            k = head_layer_norm(k, p["k_norm_scale"], p["k_norm_bias"], cfg.qk_norm_eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if cfg.kv_quant:
            k, kscale = _quantize_rows(k)
            v, vscale = _quantize_rows(v)
        write_kv_layer(kv.k, k, i, cache_end)
        write_kv_layer(kv.v, v, i, cache_end)
        if cfg.kv_quant:
            write_kv_layer(kv.k_scale, kscale, i, cache_end)
            write_kv_layer(kv.v_scale, vscale, i, cache_end)
            out = _attend_quantized(q, kv.k[:, i], kv.v[:, i], kv.k_scale[:, i],
                                    kv.v_scale[:, i], mask)
        else:
            out = _attend(q, kv.k[:, i], kv.v[:, i], mask)
        return linear(out.reshape(S, T, cfg.q_dim), p["wo"])

    def mlp_block(x, p):
        g, u = linear_multi(x, (p["w_gate"], p["w_up"]))
        return linear(F.silu(g.float()).to(u.dtype) * u, p["w_down"])

    layers = params["layers"]
    for i in range(cfg.num_layers):
        p = {name: t[i] for name, t in layers.items()}
        if cfg.swin_norm:
            h1 = h + rms_norm(attn_block(h, p, i), p["attn_norm"], cfg.norm_eps)
            h = h1 + rms_norm(mlp_block(h1, p), p["mlp_norm"], cfg.norm_eps)
        else:
            h1 = h + attn_block(rms_norm(h, p["attn_norm"], cfg.norm_eps), p, i)
            h = h1 + mlp_block(rms_norm(h1, p["mlp_norm"], cfg.norm_eps), p)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if logits_tail is not None and logits_tail < T:
        h = h[:, T - logits_tail:, :]
    if cfg.tie_word_embeddings:
        logits = torch.einsum("std,vd->stv", h.float(), params["embed"].float())
    else:
        logits = linear(h, params["lm_head"])
    return ForwardResult(logits=logits.float(), kv=kv)
