"""Products with quantized weights: W4A16/W8A16 (:func:`quant_linear_a16`)
and W4A8/W8A8 (:func:`quant_linear_a8`).

No Pallas kernel stands behind these: the JAX package leaves the quantized
products of ``linear_multi`` (``sjd_tpu/models/transformer.py:457-495``) to
XLA's dot, with the int -> bf16 convert fused into the operand read. On
CUDA tensors each wrapper launches the hand-written Hopper kernel of
``csrc/quant_linear.cu``, which reads the int8 or packed int4 bytes as they
are (dequantizing first and calling ``F.linear`` would read more bytes than
the bf16 weights); on CPU tensors it runs the plain version beside it, the
same function in PyTorch. There is no fallback from one to the other: CUDA
tensors the kernel does not take raise.

The kernel's split of the K range depends on N, K and the bits only, so a
row's output does not depend on how many rows were multiplied with it. What
bounds the kernels on the H100, and what their design does about it, is
written at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import load, ptr

Tensor = torch.Tensor


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernels' C entry points, typed once when the library is loaded."""
    lib = load("quant_linear")
    lib.sjd_quant_linear.restype = ctypes.c_int
    lib.sjd_quant_linear.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.sjd_quant_linear_splits.restype = ctypes.c_int
    lib.sjd_quant_linear_splits.argtypes = [ctypes.c_int] * 3
    return lib


@functools.lru_cache(maxsize=None)
def splits(N: int, K: int, bits: int) -> int:
    """The kernel's split of the K range for an [N, K] weight of ``bits``."""
    return int(_lib().sjd_quant_linear_splits(N, K, bits))


def unpack_int4(q4p: Tensor) -> Tensor:
    """[..., N, K/2] packed uint8 -> [..., N, K] int8 in [-8, 7]: byte
    column j holds column j in its low nibble and column j + K/2 in its high
    nibble (sjd_tpu's unpack_int4)."""
    b = q4p.to(torch.int16)
    lo = ((b & 0xF) ^ 8) - 8
    hi = ((b >> 4) ^ 8) - 8
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def _codes(q: Tensor, bits: int) -> Tensor:
    return unpack_int4(q) if bits == 4 else q


def quant_linear_a16_plain(x: Tensor, q: Tensor, s: Tensor, *, bits: int) -> Tensor:
    """x [..., K] @ codes(q) [N, K]^T summed in f32, times s [N], in x's
    dtype: JAX's ``(_dot_last(x, q.astype(x.dtype), f32) * s).astype``."""
    acc = F.linear(x.float(), _codes(q, bits).float())
    return (acc * s.float()).to(x.dtype)


def quant_linear_a8_plain(xq: Tensor, xs: Tensor, q: Tensor, s: Tensor, *, bits: int,
                          out_dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """xq int8 [..., K] @ codes(q)^T summed exactly (float64 holds every
    int32 sum), then f32(acc) * xs [..., 1] * s [N] in that order:
    JAX's ``acc.astype(f32) * xs * s.astype(f32)``."""
    acc = F.linear(xq.double(), _codes(q, bits).double())
    return (acc.float() * xs * s.float()).to(out_dtype)


def _check(name, t, shape, dtype, dev):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != dev \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor {tuple(shape)} on "
                         f"{dev}, got {(tuple(t.shape), t.dtype, t.device, t.is_contiguous())}")


def _launch(x2: Tensor, xs: Tensor, q: Tensor, s: Tensor, bits: int, a8: bool) -> Tensor:
    """The kernel on x2 [M, K] (bf16, or int8 with xs f32 [M]); y bf16 [M, N]."""
    M, K = x2.shape
    N = q.shape[0]
    dev = x2.device
    if bits not in (4, 8):
        raise ValueError(f"quant_linear: bits must be 4 or 8, got {bits}")
    if M == 0:
        raise ValueError("quant_linear: no rows")
    kb = K // 2 if bits == 4 else K
    if kb % 16 or (bits == 4 and K % 2):
        raise ValueError(f"quant_linear: the kernel takes weight rows of a multiple of 16 "
                         f"bytes; got K={K} at {bits} bits")
    _check("x", x2, (M, K), torch.int8 if a8 else torch.bfloat16, dev)
    _check("q", q, (N, kb), torch.uint8 if bits == 4 else torch.int8, dev)
    _check("s", s, (N,), torch.bfloat16, dev)
    if a8:
        _check("xs", xs, (M,), torch.float32, dev)
    if x2.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("quant_linear: x and q must be 16-byte aligned")
    y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    g = splits(N, K, bits)
    part = None
    if g > 1:
        part = torch.empty((g, M, N), dtype=torch.int32 if a8 else torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rc = _lib().sjd_quant_linear(ptr(x2), ptr(xs if a8 else None), ptr(q), ptr(s), ptr(y),
                                 ptr(part), M, N, K, bits, int(a8), stream)
    if rc != 0:
        raise RuntimeError(f"quant_linear kernel launch failed: CUDA error {rc}")
    return y


def quant_linear_a16(x: Tensor, q: Tensor, s: Tensor, *, bits: int) -> Tensor:
    """W4A16 (``bits=4``, q packed uint8 [N, K/2]) or W8A16 (``bits=8``, q
    int8 [N, K]): x [..., K] -> [..., N], scales s bf16 [N]. On CUDA: one
    launch of the kernel (x bf16, any number of rows)."""
    if not x.is_cuda:
        return quant_linear_a16_plain(x, q, s, bits=bits)
    lead, K = x.shape[:-1], x.shape[-1]
    y = _launch(x.reshape(-1, K).contiguous(), None, q, s, bits, False)
    quant_linear_a16.launches += 1
    return y.reshape(*lead, q.shape[0])


quant_linear_a16.launches = 0


def quant_linear_a8(xq: Tensor, xs: Tensor, q: Tensor, s: Tensor, *, bits: int,
                    out_dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """W4A8 or W8A8: per-token int8 activations xq [..., K] with f32 scales
    xs [..., 1] (``transformer._quantize_act``) against q -> [..., N]. On
    CUDA: one launch of the kernel, whose int32 sums are exact, so its
    output equals the plain version's bit for bit; the output is bf16."""
    if not xq.is_cuda:
        return quant_linear_a8_plain(xq, xs, q, s, bits=bits, out_dtype=out_dtype)
    if out_dtype != torch.bfloat16:
        raise ValueError(f"quant_linear_a8: the kernel writes bf16, not {out_dtype}")
    lead, K = xq.shape[:-1], xq.shape[-1]
    y = _launch(xq.reshape(-1, K).contiguous(), xs.reshape(-1).contiguous(), q, s, bits,
                True)
    quant_linear_a8.launches += 1
    return y.reshape(*lead, q.shape[0])


quant_linear_a8.launches = 0
