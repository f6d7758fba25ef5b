"""Fused per-layer attention epilogue: qk-norm + RoPE + int8 KV quantization.

The counterpart of ``sjd_tpu/ops/fused_epilogue.py``. On a CUDA tensor,
:func:`fused_epilogue` launches the hand-written Hopper kernel
``csrc/fused_epilogue.cu`` (which replaces the TPU kernel
``_epilogue_kernel``); on a CPU tensor it runs :func:`fused_epilogue_plain`,
the same arithmetic in plain PyTorch. There is no fallback from one to the
other: a CUDA tensor the kernel does not take raises.

What bounds the kernel on the H100, and what its design does about it, is
written at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ._build import load, ptr

Tensor = torch.Tensor
_MAX_HEAD_DIM = 256


def quantize_rows(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric int8 per-(row, head) quantization over the last axis:
    scale = max(amax / 127, 1e-8), codes round half to even, clipped to
    +-127; the scale is returned as bf16 (transformer._quantize_rows)."""
    xf = x.float()
    # a 0-d tensor on x's device, not a Python number: CUDA turns division
    # by a host scalar into a multiply by its reciprocal, which is not exact
    d127 = torch.full((), 127.0, device=x.device)
    scale = torch.clamp_min(xf.abs().amax(-1) / d127, 1e-8)
    xq = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return xq.to(torch.int8), scale.to(torch.bfloat16)


def fused_epilogue_plain(
    qp: Tensor, kp: Tensor, vp: Tensor,
    q_norm_scale: Optional[Tensor], q_norm_bias: Optional[Tensor],
    k_norm_scale: Optional[Tensor], k_norm_bias: Optional[Tensor],
    cos: Tensor, sin: Tensor,
    *, num_heads: int, num_kv_heads: int, head_dim: int, qk_norm: bool,
    quantize: bool, eps: float = 1e-5,
) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor], Optional[Tensor]]:
    """The kernel's function in PyTorch, with the TPU kernel's cast points:
    the norm output and the RoPE output each round to the compute dtype."""
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
    """Returns (q [S,T,Hq,D], k, v [S,T,Hkv,D] int8 if ``quantize`` else the
    compute dtype, k_scale, v_scale [S,T,Hkv] bf16 or None)."""
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads,
              head_dim=head_dim, qk_norm=qk_norm, quantize=quantize, eps=eps)
    if not qp.is_cuda:
        return fused_epilogue_plain(
            qp, kp, vp, q_norm_scale, q_norm_bias, k_norm_scale, k_norm_bias,
            cos, sin, **kw)

    S, T = qp.shape[:2]
    Hq, Hkv, D = num_heads, num_kv_heads, head_dim
    if D % 2 or not 2 <= D <= _MAX_HEAD_DIM:
        raise ValueError(f"fused_epilogue kernel takes an even head_dim <= "
                         f"{_MAX_HEAD_DIM}, got {D}")
    norms = (q_norm_scale, q_norm_bias, k_norm_scale, k_norm_bias)
    expect = [
        (qp, (S, T, Hq * D), torch.bfloat16), (kp, (S, T, Hkv * D), torch.bfloat16),
        (vp, (S, T, Hkv * D), torch.bfloat16), (cos, (S, T, D), torch.float32),
        (sin, (S, T, D), torch.float32),
    ]
    if qk_norm:
        expect += [(t, (H, D), torch.bfloat16)
                   for t, H in zip(norms, (Hq, Hq, Hkv, Hkv))]
    for t, shape, dtype in expect:
        if t is None or t.device != qp.device or tuple(t.shape) != shape \
                or t.dtype != dtype or not t.is_contiguous():
            got = None if t is None else (tuple(t.shape), t.dtype, t.device,
                                          t.is_contiguous())
            raise ValueError(f"fused_epilogue: expected a contiguous {dtype} "
                             f"tensor {shape} on {qp.device}, got {got}")

    kv_dt = torch.int8 if quantize else torch.bfloat16
    q = torch.empty((S, T, Hq, D), dtype=torch.bfloat16, device=qp.device)
    k = torch.empty((S, T, Hkv, D), dtype=kv_dt, device=qp.device)
    v = torch.empty((S, T, Hkv, D), dtype=kv_dt, device=qp.device)
    ks = vs = None
    if quantize:
        ks = torch.empty((S, T, Hkv), dtype=torch.bfloat16, device=qp.device)
        vs = torch.empty((S, T, Hkv), dtype=torch.bfloat16, device=qp.device)
    norm_args = norms if qk_norm else (None,) * 4

    lib = load("fused_epilogue")
    fn = lib.sjd_fused_epilogue
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    with torch.cuda.device(qp.device):
        stream = torch.cuda.current_stream(qp.device).cuda_stream
        rc = fn(ptr(qp), ptr(kp), ptr(vp), *[ptr(t) for t in norm_args],
                ptr(cos), ptr(sin), ptr(q), ptr(k), ptr(v), ptr(ks), ptr(vs),
                S, T, Hq, Hkv, D, int(qk_norm), int(quantize), eps,
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_epilogue kernel launch failed: CUDA error {rc}")
    fused_epilogue.launches += 1
    return q, k, v, ks, vs


fused_epilogue.launches = 0
