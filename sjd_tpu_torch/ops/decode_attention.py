"""Flash-decoding attention for one SJD window over the stacked KV cache.

The counterpart of ``sjd_tpu/ops/decode_attention.py``. On CUDA tensors,
:func:`decode_attention` launches the hand-written Hopper kernel
``csrc/decode_attention.cu`` (which replaces the TPU kernel
``_flash_decode_kernel``); on CPU tensors it runs
:func:`decode_attention_plain`, the same function in plain PyTorch. There is
no fallback from one to the other: CUDA tensors the kernel does not take
raise.

The attention runs after the window's K/V rows were written at
``cache_end`` (``models/transformer.py``), so rows
``[cache_end, cache_end + W)`` are live. What bounds the kernel on the H100,
and what its design does about it, is written at the top of the CUDA source.

:func:`decode_attention_tp` is the tensor-parallel call: attention is
head-parallel, so each rank of the model axis runs the same kernel on its
own head shard, with no collective (the JAX package's ``shard_map`` around
the ``pallas_call``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ._build import load, ptr

Tensor = torch.Tensor
NEG_INF = float(torch.finfo(torch.float32).min)
_KERNEL_HEAD_DIMS = (64, 100, 128)


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, the cache rows of one split (a constant
    of the CUDA source) and each head width's partial row width (D, or the
    shared-memory padding's 128 for D = 100), typed once when the library is
    loaded (not on every call: the caller's host path is the bottleneck)."""
    lib = load("decode_attention")
    fn = lib.sjd_decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.sjd_decode_attention_split_rows.restype = ctypes.c_int
    lib.sjd_decode_attention_partial_dim.restype = ctypes.c_int
    lib.sjd_decode_attention_partial_dim.argtypes = [ctypes.c_int]
    partial_dim = {d: int(lib.sjd_decode_attention_partial_dim(d)) for d in _KERNEL_HEAD_DIMS}
    return fn, int(lib.sjd_decode_attention_split_rows()), partial_dim


def partials_numel(S: int, W: int, H: int, Hkv: int, D: int, L: int) -> int:
    """f32 elements of the kernel's scratch: per split of the buffer, per
    KV head, unnormalised acc [W * group, partial width] and (m, l) per
    row."""
    _, split_rows, partial_dim = _entry()
    n_split = -(-L // split_rows)
    return S * n_split * Hkv * W * (H // Hkv) * (partial_dim[D] + 2)


def decode_masks(cache_end: Tensor, valid: Tensor, T: int, L: int) -> Tensor:
    """[S, T, L] bool: window row i may attend cache row j iff
    j <= cache_end + i and valid[j] (transformer._decode_masks)."""
    j = torch.arange(L, device=valid.device, dtype=torch.int32)[None, None, :]
    i = torch.arange(T, device=valid.device, dtype=torch.int32)[None, :, None]
    return (j <= cache_end.to(torch.int32)[:, None, None] + i) & valid[:, None, :]


def decode_attention_plain(
    q: Tensor, k_cache: Tensor, v_cache: Tensor,
    k_scale: Optional[Tensor], v_scale: Optional[Tensor],
    cache_end: Tensor, valid: Tensor, *, layer: int,
) -> Tensor:
    """The kernel's function in PyTorch, over the whole buffer in f32:
    scores = (q . k) * s_k / sqrt(D), masked with the finite NEG_INF,
    softmax, then sum_j p_j * s_v[j] * v[j]."""
    S, W, H, D = q.shape
    k = k_cache[:, layer]
    v = v_cache[:, layer]
    L, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    qg = q.float().reshape(S, W, Hkv, group, D)
    scores = torch.einsum("swhgd,slhd->shgwl", qg, k.float())
    if k_scale is not None:
        ks = k_scale[:, layer].float() / math.sqrt(D)  # [S, L, Hkv]
        scores = scores * ks.permute(0, 2, 1)[:, :, None, None, :]
    else:
        scores = scores / math.sqrt(D)
    mask = decode_masks(cache_end, valid, W, L)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        p = p * v_scale[:, layer].float().permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("shgwl,slhd->swhgd", p, v.float())
    return out.reshape(S, W, H, D).to(q.dtype)


def decode_attention(
    q: Tensor,  # [S, W, H, D]
    k_cache: Tensor,  # [S, L, Hkv, D] or the stacked [S, NL, L, Hkv, D]
    v_cache: Tensor,
    k_scale: Optional[Tensor],  # [S, (NL,) L, Hkv] bf16, or None (bf16 cache)
    v_scale: Optional[Tensor],
    cache_end: Tensor,  # [S] int32
    valid: Tensor,  # [S, L] bool
    *,
    window: int,
    layer: Optional[int] = None,  # selects the layer of a stacked cache
) -> Tensor:
    S, W, H, D = q.shape
    if window != W:
        raise ValueError(f"window={window} but q has {W} rows")
    if k_cache.dim() == 4:
        if layer is not None:
            raise ValueError("layer= is for a stacked 5-D cache")
        k_cache, v_cache = k_cache[:, None], v_cache[:, None]
        if k_scale is not None:
            k_scale, v_scale = k_scale[:, None], v_scale[:, None]
        layer = 0
    if layer is None:
        raise ValueError("a stacked 5-D cache needs layer=")
    layer = int(layer)
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, k_scale, v_scale,
                                      cache_end, valid, layer=layer)

    NL, L, Hkv = k_cache.shape[1], k_cache.shape[2], k_cache.shape[3]
    quantized = k_scale is not None
    if D not in _KERNEL_HEAD_DIMS or H % Hkv or not 0 <= layer < NL:
        raise ValueError(f"decode_attention kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, H % Hkv == 0 and 0 <= layer < NL;"
                         f" got D={D}, H={H}, Hkv={Hkv}, layer={layer}, NL={NL}")
    kv_dt = torch.int8 if quantized else torch.bfloat16
    expect = [
        (q, (S, W, H, D), torch.bfloat16), (k_cache, (S, NL, L, Hkv, D), kv_dt),
        (v_cache, (S, NL, L, Hkv, D), kv_dt), (cache_end, (S,), torch.int32),
        (valid, (S, L), torch.bool),
    ]
    if quantized:
        expect += [(k_scale, (S, NL, L, Hkv), torch.bfloat16),
                   (v_scale, (S, NL, L, Hkv), torch.bfloat16)]
    elif v_scale is not None:
        raise ValueError("k_scale and v_scale go together")
    for t, shape, dtype in expect:
        if t is None or t.device != q.device or tuple(t.shape) != shape \
                or t.dtype != dtype or not t.is_contiguous():
            got = None if t is None else (tuple(t.shape), t.dtype, t.device,
                                          t.is_contiguous())
            raise ValueError(f"decode_attention: expected a contiguous {dtype} "
                             f"tensor {shape} on {q.device}, got {got}")
    if q.data_ptr() % 16 or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention: q and the K/V caches must be 16-byte aligned")

    fn = _entry()[0]
    out = torch.empty_like(q)
    # the merge reads only the splits the kernel wrote, so no initialisation
    partials = torch.empty(partials_numel(S, W, H, Hkv, D, L), dtype=torch.float32,
                           device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(ptr(q), ptr(k_cache), ptr(v_cache), ptr(k_scale),
                ptr(v_scale), ptr(cache_end), ptr(valid), ptr(out), ptr(partials),
                S, W, H, Hkv, D, NL, L, layer, int(quantized), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {rc}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_tp(
    q: Tensor,  # [S, W, H / m, D]: this rank's query heads
    k_cache: Tensor,  # [S, L, Hkv / m, D] or the stacked [S, NL, L, Hkv / m, D]
    v_cache: Tensor,
    k_scale: Optional[Tensor],
    v_scale: Optional[Tensor],
    cache_end: Tensor,  # [S] int32, the same on every rank
    valid: Tensor,  # [S, L] bool, the same on every rank
    *,
    window: int,
    layer: Optional[int] = None,
    axis,  # the rank's model-axis ProcessGroup, or a parallel.sharding.ModelAxis
    num_heads: Optional[int] = None,  # the model's query heads, when known
    num_kv_heads: Optional[int] = None,  # its KV heads, when known
) -> Tensor:
    """:func:`decode_attention` on one rank's head shard of a model axis
    of m ranks (``sjd_tpu/ops/decode_attention.py``'s ``decode_attention_tp``,
    whose ``mesh``/``axis`` become the rank's group): the rank passes its
    own q heads and its own cache of ``Hkv / m`` heads, in the 4-D or the
    stacked 5-D layout, with or without int8 scales, and the hand-written
    kernel runs on them with no collective; the result is the rank's heads
    of the output. Refused: a GQA group that does not divide (H / m over
    Hkv / m), and, given the model's head counts, a split that is not even
    or not ``num_heads / m`` over ``num_kv_heads / m``."""
    size = axis.size if hasattr(axis, "size") else _group_size(axis)
    H, Hkv = q.shape[2], k_cache.shape[-2]
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"decode_attention_tp: {H} local query heads over {Hkv} local KV "
                         f"heads break the GQA group")
    for total, local, what in ((num_heads, H, "query"), (num_kv_heads, Hkv, "KV")):
        if total is not None and (total % size or total // size != local):
            raise ValueError(f"decode_attention_tp: {total} {what} heads over a model axis "
                             f"of {size} is not an even split into the {local} given")
    return decode_attention(q, k_cache, v_cache, k_scale, v_scale, cache_end, valid,
                            window=window, layer=layer)


def _group_size(group) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group)
