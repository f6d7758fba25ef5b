"""Logging and metric smoothing (sjd_tpu/utils/logging.py):

  * :func:`set_logger` - stdout and an optional file handler;
  * :class:`SmoothedValue` / :class:`MetricLogger` - windowed medians and
    means with periodic printing.
"""

from __future__ import annotations

import logging
import sys
import time
from collections import defaultdict, deque
from typing import Optional


def set_logger(log_file: Optional[str] = None, level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger("sjd_tpu_torch")
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        vals = sorted(self.deque)
        return vals[len(vals) // 2] if vals else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, global_avg=self.global_avg)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: dict = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self) -> str:
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable, print_freq: int, logger=None, header: str = ""):
        log = (logger or logging.getLogger("sjd_tpu_torch")).info
        start = time.time()
        for i, obj in enumerate(iterable):
            yield obj
            if i % print_freq == 0:
                log(f"{header} [{i}] {self}  ({time.time() - start:.1f}s)")
