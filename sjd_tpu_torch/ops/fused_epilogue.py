"""Fused per-layer attention epilogue: qk-norm + RoPE + int8 KV quantization,
with K, V and their scales written into the stacked KV cache.

The counterpart of ``sjd_tpu/ops/fused_epilogue.py`` followed by
``sjd_tpu/models/transformer.py``'s ``write_kv_layer``. On CUDA tensors,
:func:`fused_epilogue_into_cache` launches the hand-written Hopper kernel
``csrc/fused_epilogue.cu`` (which replaces the TPU kernel
``_epilogue_kernel``); on CPU tensors it runs
:func:`fused_epilogue_into_cache_plain`, the same function in plain PyTorch
(:func:`fused_epilogue_plain`, then :func:`write_kv_layer`). There is no
fallback from one to the other: CUDA tensors the kernel does not take raise.

:func:`fused_epilogue` keeps the JAX package's signature and returns
``(q, k, v, k_scale, v_scale)``; on CUDA it goes through the same kernel,
into a one-layer cache of T rows.

What bounds the kernel on the H100, and what its design does about it, is
written at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ._build import load

Tensor = torch.Tensor
_KERNEL_HEAD_DIMS = (64, 100, 128)
_INV127 = (torch.tensor(1.0) / torch.tensor(127.0)).item()  # f32 1/127, exactly


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, typed once when the library is loaded
    (not on every call: the caller's host path is the bottleneck)."""
    fn = load("fused_epilogue").sjd_fused_epilogue
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return fn


def quantize_rows(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric int8 per-(row, head) quantization over the last axis:
    scale = max(amax * fl32(1/127), 1e-8), codes round half to even,
    clipped to +-127; the scale is returned as bf16
    (transformer._quantize_rows)."""
    xf = x.float()
    # XLA, which runs the reference, folds amax / 127 into a multiply by the
    # f32 reciprocal of 127 (a tie x / scale = n + 0.5 can round the other
    # way with the exact quotient); the kernel multiplies by it too
    inv127 = torch.full((), _INV127, dtype=torch.float32, device=x.device)
    scale = torch.clamp_min(xf.abs().amax(-1) * inv127, 1e-8)
    xq = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return xq.to(torch.int8), scale.to(torch.bfloat16)


def write_kv_layer(buf: Tensor, new: Tensor, layer: int, offsets: Tensor) -> Tensor:
    """Write a window ``new`` [S, T, H(, D)] into layer ``layer`` of the
    stacked buffer [S, NL, L_buf, H(, D)] at per-sample rows ``offsets``, in
    place. Start rows follow ``jax.lax.dynamic_update_slice`` (the JAX
    package's write_kv_layer): a negative one counts from the end (+ L_buf),
    then each is clamped to [0, L_buf - T], so a window never writes past
    the buffer."""
    write_kv_layer.calls += 1
    S, T = new.shape[:2]
    L = buf.shape[2]
    start = offsets.long()
    start = torch.where(start < 0, start + L, start).clamp(0, L - T)
    rows = start[:, None] + torch.arange(T, device=buf.device)[None, :]
    samples = torch.arange(S, device=buf.device)[:, None]
    buf[:, layer][samples, rows] = new
    return buf


write_kv_layer.calls = 0  # the kernel path of transformer.forward makes none


def fused_epilogue_plain(
    qp: Tensor, kp: Tensor, vp: Tensor,
    q_norm_scale: Optional[Tensor], q_norm_bias: Optional[Tensor],
    k_norm_scale: Optional[Tensor], k_norm_bias: Optional[Tensor],
    cos: Tensor, sin: Tensor,
    *, num_heads: int, num_kv_heads: int, head_dim: int, qk_norm: bool,
    quantize: bool, eps: float = 1e-5,
) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor], Optional[Tensor]]:
    """The epilogue in PyTorch, with the TPU kernel's cast points: the norm
    output and the RoPE output each round to the compute dtype."""
    S, T = qp.shape[:2]
    dt = qp.dtype
    cos = cos.float()[:, :, None, :]
    sin = sin.float()[:, :, None, :]

    def norm(x, scale, bias):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(-1, keepdim=True)
        xn = (xf - mean) * torch.sqrt(var + eps).reciprocal()  # exact, as the kernel
        return (xn * scale.float() + bias.float()).to(dt)

    def rope(x):
        xf = x.float()
        a, b = xf.chunk(2, dim=-1)
        rot = torch.cat([-b, a], dim=-1)
        return (xf * cos + rot * sin).to(dt)

    q = qp.reshape(S, T, num_heads, head_dim)
    k = kp.reshape(S, T, num_kv_heads, head_dim)
    v = vp.reshape(S, T, num_kv_heads, head_dim)
    if qk_norm:
        q = norm(q, q_norm_scale, q_norm_bias)
        k = norm(k, k_norm_scale, k_norm_bias)
    q = rope(q)
    k = rope(k)
    if not quantize:
        return q, k, v, None, None
    kq, ks = quantize_rows(k)
    vq, vs = quantize_rows(v)
    return q, kq, vq, ks, vs


def fused_epilogue_into_cache_plain(
    qp: Tensor, kp: Tensor, vp: Tensor,
    q_norm_scale: Optional[Tensor], q_norm_bias: Optional[Tensor],
    k_norm_scale: Optional[Tensor], k_norm_bias: Optional[Tensor],
    cos: Tensor, sin: Tensor,
    k_cache: Tensor, v_cache: Tensor,
    k_scale: Optional[Tensor], v_scale: Optional[Tensor],
    cache_end: Tensor,
    *, layer: int, num_heads: int, num_kv_heads: int, head_dim: int,
    qk_norm: bool, eps: float = 1e-5,
) -> Tensor:
    """The kernel's function in PyTorch: the epilogue, then the window's
    K, V (and scales) written into the cache by :func:`write_kv_layer`."""
    q, k, v, ks, vs = fused_epilogue_plain(
        qp, kp, vp, q_norm_scale, q_norm_bias, k_norm_scale, k_norm_bias, cos, sin,
        num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
        qk_norm=qk_norm, quantize=k_scale is not None, eps=eps)
    write_kv_layer(k_cache, k, layer, cache_end)
    write_kv_layer(v_cache, v, layer, cache_end)
    if k_scale is not None:
        write_kv_layer(k_scale, ks, layer, cache_end)
        write_kv_layer(v_scale, vs, layer, cache_end)
    return q


def fused_epilogue_into_cache(
    qp: Tensor,  # [S, T, Hq*D]
    kp: Tensor,  # [S, T, Hkv*D]
    vp: Tensor,  # [S, T, Hkv*D]
    q_norm_scale: Optional[Tensor],  # [Hq, D]
    q_norm_bias: Optional[Tensor],
    k_norm_scale: Optional[Tensor],  # [Hkv, D]
    k_norm_bias: Optional[Tensor],
    cos: Tensor,  # [S, T, D] float32
    sin: Tensor,
    k_cache: Tensor,  # [S, NL, L, Hkv, D] int8 (with scales) or bf16
    v_cache: Tensor,
    k_scale: Optional[Tensor],  # [S, NL, L, Hkv] bf16, or None (bf16 cache)
    v_scale: Optional[Tensor],
    cache_end: Tensor,  # [S] int32
    *,
    layer: int,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    qk_norm: bool,
    eps: float = 1e-5,
) -> Tensor:
    """Returns q [S, T, Hq, D]. K and V (int8 codes and bf16 scales when
    ``k_scale`` is given) go into layer ``layer`` of the caches, in place,
    at the rows :func:`write_kv_layer` picks (dynamic_update_slice's rule:
    a negative ``cache_end`` counts from the end, then the start is clamped
    to [0, L - T]); no other row changes."""
    if not qp.is_cuda:
        return fused_epilogue_into_cache_plain(
            qp, kp, vp, q_norm_scale, q_norm_bias, k_norm_scale, k_norm_bias, cos, sin,
            k_cache, v_cache, k_scale, v_scale, cache_end, layer=layer,
            num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
            qk_norm=qk_norm, eps=eps)

    S, T = qp.shape[:2]
    Hq, Hkv, D = num_heads, num_kv_heads, head_dim
    dev = qp.get_device()
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"fused_epilogue kernel takes head_dim in {_KERNEL_HEAD_DIMS}, "
                         f"got {D}")
    bf16 = torch.bfloat16
    cshape = k_cache.shape
    NL, L = (cshape[1], cshape[2]) if k_cache.dim() == 5 else (0, 0)
    quantize = k_scale is not None
    expect = [
        (qp, (S, T, Hq * D), bf16), (kp, (S, T, Hkv * D), bf16), (vp, (S, T, Hkv * D), bf16),
        (cos, (S, T, D), torch.float32), (sin, (S, T, D), torch.float32),
        (cache_end, (S,), torch.int32),
        (k_cache, (S, NL, L, Hkv, D), torch.int8 if quantize else bf16),
        (v_cache, (S, NL, L, Hkv, D), k_cache.dtype),
    ]
    if quantize:
        expect += [(k_scale, (S, NL, L, Hkv), bf16), (v_scale, (S, NL, L, Hkv), bf16)]
    elif v_scale is not None:
        raise ValueError("fused_epilogue: k_scale and v_scale go together")
    norms = (q_norm_scale, q_norm_bias, k_norm_scale, k_norm_bias)
    if qk_norm:
        expect += [(t, (H, D), bf16) for t, H in zip(norms, (Hq, Hq, Hkv, Hkv))]
    else:
        norms = (None,) * 4
    for t, shape, dtype in expect:
        # (torch.Size == tuple is several times faster than !=)
        if t is None or t.dtype != dtype or not t.shape == shape or t.get_device() != dev \
                or not t.is_contiguous():
            got = None if t is None else (tuple(t.shape), t.dtype, t.device,
                                          t.is_contiguous())
            raise ValueError(f"fused_epilogue: expected a contiguous {dtype} tensor "
                             f"{shape} on cuda:{dev}, got {got}")
    if not (0 <= layer < NL and 0 < T <= L):
        raise ValueError(f"fused_epilogue: need 0 <= layer < NL and 0 < T <= L; got "
                         f"layer={layer}, NL={NL}, T={T}, L={L}")
    ptrs = [t.data_ptr() if t is not None else None for t in (
        qp, kp, vp, *norms, cos, sin, cache_end)]
    q = qp.new_empty((S, T, Hq, D))
    outs = [t.data_ptr() if t is not None else None for t in (
        q, k_cache, v_cache, k_scale, v_scale)]
    # bf16 pairs, float2 and int8 pairs move as whole words
    if any(p % 8 for p in ptrs + outs if p):
        raise ValueError("fused_epilogue: every tensor must be 8-byte aligned")
    # the current stream's handle, as torch.cuda.current_stream(dev).cuda_stream
    # gives it, without building a Stream object (a tenth of the host time)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    rc = _entry()(*ptrs, *outs, S, T, Hq, Hkv, D, NL, L, layer, int(qk_norm), eps, dev,
                  stream)
    if rc != 0:
        raise RuntimeError(f"fused_epilogue kernel launch failed: CUDA error {rc}")
    fused_epilogue_into_cache.launches += 1
    return q


fused_epilogue_into_cache.launches = 0


def fused_epilogue(
    qp: Tensor,  # [S, T, Hq*D]
    kp: Tensor,  # [S, T, Hkv*D]
    vp: Tensor,  # [S, T, Hkv*D]
    q_norm_scale: Optional[Tensor],  # [Hq, D]
    q_norm_bias: Optional[Tensor],
    k_norm_scale: Optional[Tensor],  # [Hkv, D]
    k_norm_bias: Optional[Tensor],
    cos: Tensor,  # [S, T, D] float32
    sin: Tensor,
    *,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    qk_norm: bool,
    quantize: bool,
    eps: float = 1e-5,
) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor], Optional[Tensor]]:
    """The JAX package's signature. Returns (q [S,T,Hq,D], k, v [S,T,Hkv,D]
    int8 if ``quantize`` else the compute dtype, k_scale, v_scale [S,T,Hkv]
    bf16 or None). On CUDA, the kernel writes K and V into a one-layer,
    T-row cache with ``cache_end = 0``, whose rows are returned."""
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads,
              head_dim=head_dim, qk_norm=qk_norm, eps=eps)
    if not qp.is_cuda:
        return fused_epilogue_plain(
            qp, kp, vp, q_norm_scale, q_norm_bias, k_norm_scale, k_norm_bias,
            cos, sin, quantize=quantize, **kw)
    S, T = qp.shape[:2]
    shape = (S, 1, T, num_kv_heads, head_dim)
    k = torch.empty(shape, dtype=torch.int8 if quantize else torch.bfloat16,
                    device=qp.device)
    v = torch.empty_like(k)
    ks = vs = None
    if quantize:
        ks = torch.empty(shape[:-1], dtype=torch.bfloat16, device=qp.device)
        vs = torch.empty_like(ks)
    zero = torch.zeros((S,), dtype=torch.int32, device=qp.device)
    q = fused_epilogue_into_cache(
        qp, kp, vp, q_norm_scale, q_norm_bias, k_norm_scale, k_norm_bias, cos, sin,
        k, v, ks, vs, zero, layer=0, **kw)
    return (q, k[:, 0], v[:, 0], None if ks is None else ks[:, 0],
            None if vs is None else vs[:, 0])
