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

K1 (``quant_linear_a16``) runs on Hopper's wgmma: a block's 128 weight
rows against up to 256 activation rows at once (every row of the launch at
M <= 256), so the packed weights are read and widened once per launch and
the product runs near the tensor cores' rate, which bounds it at the decode
windows' rows; TMA brings each chunk's tiles. K2 (``quant_linear_a8``),
whose bound at its rows is the bytes it moves, takes 64 weight rows and 32
activation rows per block on mma.sync. Both add the split K range's
partials inside the same launch: each product is one launch. The split
depends on N, K, the bits and the kernel only, and the K order inside a row
is fixed, so a row's output does not depend on how many rows were multiplied
with it. The split sum counts arrivals on int32 counters
that this module keeps, one buffer per device, zeroed: it grows only
outside a CUDA graph capture (a call under capture that would need more
raises: run the step once eagerly first, as the engine's warm-up does) and
is never freed, since a captured graph may replay on it. The details are
at the top of the CUDA source.
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
    lib.sjd_quant_linear.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    for fn, n_args in ((lib.sjd_quant_linear_splits, 4), (lib.sjd_quant_linear_tile, 2),
                       (lib.sjd_quant_linear_resident, 2)):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * n_args
    lib.sjd_quant_linear_scratch.restype = ctypes.c_longlong
    lib.sjd_quant_linear_scratch.argtypes = [ctypes.c_int] * 5
    return lib


@functools.lru_cache(maxsize=None)
def splits(N: int, K: int, bits: int, a8: bool) -> int:
    """K1's (``a8`` False) or K2's split of the K range for an [N, K]
    weight of ``bits``."""
    return int(_lib().sjd_quant_linear_splits(N, K, bits, int(a8)))


@functools.lru_cache(maxsize=None)
def tile(a8: bool) -> tuple:
    """K1's or K2's block: (weight rows, activation rows)."""
    lib = _lib()
    return int(lib.sjd_quant_linear_tile(0, int(a8))), int(lib.sjd_quant_linear_tile(1, int(a8)))


def scratch(M: int, N: int, K: int, bits: int, a8: bool) -> int:
    """Elements of the split partials' scratch for x [M, K] against an
    [N, K] weight (0 for one split): K2's splits x M x N, K1's whole tiles."""
    return int(_lib().sjd_quant_linear_scratch(M, N, K, bits, int(a8)))


def grid(M: int, N: int, K: int, bits: int, a8: bool) -> tuple:
    """For x [M, K] against an [N, K] weight: (N tiles, 32-row M tiles,
    splits), which size the split sum's counters (K2's grid; K1's M tiles
    are fewer, of up to 256 rows)."""
    bn, bm = tile(a8)
    return -(-N // bn), -(-M // bm), splits(N, K, bits, a8)


def resident(bits: int, a8: bool) -> int:
    """Blocks of the kernel the current device holds at once."""
    n = int(_lib().sjd_quant_linear_resident(bits, int(a8)))
    if n < 0:
        raise RuntimeError(f"quant_linear occupancy query failed: CUDA error {-n}")
    return n


# one zeroed int32 counter buffer per device index; the ones it replaced
# stay alive, since a captured graph may still replay on them
_COUNTERS: dict = {}
_RETIRED: list = []


def counters(dev: torch.device, n: int) -> Tensor:
    """At least ``n`` zeroed arrival counters on ``dev``. Grows the buffer
    only outside a capture: a call under capture that needs more raises."""
    buf = _COUNTERS.get(dev.index)
    if buf is not None and buf.numel() >= n:
        return buf
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"quant_linear: the split sum needs {n} arrival counters on {dev} and has "
            f"{0 if buf is None else buf.numel()}; a buffer is not allocated inside a CUDA "
            "graph capture: run the same call once eagerly before capturing it")
    if buf is not None:
        _RETIRED.append(buf)
    size = max(n, 4096 if buf is None else 2 * buf.numel())
    buf = torch.zeros(size, dtype=torch.int32, device=dev)
    _COUNTERS[dev.index] = buf
    return buf


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
    tiles_n, tiles_m, g = grid(M, N, K, bits, a8)
    part = count = None
    if g > 1:
        count = counters(dev, tiles_n * tiles_m)
        part = torch.empty(scratch(M, N, K, bits, a8), dtype=torch.int32 if a8 else torch.float32,
                           device=dev)
    y = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rc = _lib().sjd_quant_linear(ptr(x2), ptr(xs if a8 else None), ptr(q), ptr(s), ptr(y),
                                 ptr(part), ptr(count), M, N, K, bits, int(a8), stream)
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
