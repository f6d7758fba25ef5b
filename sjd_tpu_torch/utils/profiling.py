"""Timing helpers (sjd_tpu/utils/profiling.py):

  * :class:`GenerationStats` - NFE, tokens, tokens per forward and the
    acceptance histogram of a ``GenerateResult``, with the wall time;
  * :func:`time_block` - host wall time of work that ends in
    ``torch.cuda.synchronize()`` when it ran on the card;
  * :func:`host_peak_rss_bytes` - the process's peak resident set.

Spans inside the serving and decode paths: ``utils/tracing.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Optional

import torch


def _sync(device=None) -> None:
    if torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda"):
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def time_block(label: str = "", result_holder: Optional[dict] = None, device=None):
    """Host seconds of the block, the card synchronised at its end; stored
    under ``label`` (or "elapsed") in ``result_holder``, printed when
    ``label`` is given."""
    t0 = time.perf_counter()
    yield
    _sync(device)
    dt = time.perf_counter() - t0
    if result_holder is not None:
        result_holder[label or "elapsed"] = dt
    if label:
        print(f"[{label}] {dt:.3f}s")


@dataclasses.dataclass
class GenerationStats:
    wall_s: float
    nfe: int  # forwards, the prefill included
    tokens: int  # generated tokens of the longest row
    accept_rate: float  # generated tokens per forward
    accept_hist: Optional[tuple] = None  # decode steps by committed tokens

    @classmethod
    def from_result(cls, result: Any, wall_s: float) -> "GenerationStats":
        nfe = int(result.nfe)
        tokens = int(result.gen_count.max())
        hist = getattr(result, "accept_hist", None)
        return cls(wall_s=wall_s, nfe=nfe, tokens=tokens, accept_rate=tokens / max(nfe, 1),
                   accept_hist=tuple(int(x) for x in hist) if hist is not None else None)

    def __str__(self) -> str:
        return (f"Time elapsed inner: {self.wall_s:.2f}s | gen loop num (NFE): "
                f"{self.nfe} | tokens length: {self.tokens} | "
                f"accept {self.accept_rate:.2f} tok/fwd")


def host_peak_rss_bytes() -> Optional[int]:
    """This process's peak resident set so far (``ru_maxrss``: KiB on
    Linux), or None where the ``resource`` module does not exist."""
    try:
        import resource
    except ImportError:
        return None
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
