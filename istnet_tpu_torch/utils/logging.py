"""Logging (the port's own copy of ``istnet_tpu/utils/logging.py``): the
reference's dual-handler logger (console INFO + file WARNING), the running
averages of the training stats between two log lines (``LogBuffer``) and
the tensorboardX scalar writer (``MetricWriter``, a no-op where
tensorboardX is not installed)."""

from __future__ import annotations

import logging
import os
from collections import defaultdict


def get_logger(level_print: int = logging.INFO, level_save: int = logging.WARNING,
               path_file: str | None = None, name_logger: str = "istnet") -> logging.Logger:
    logger = logging.getLogger(name_logger)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.handlers:  # idempotent across repeated init() calls
        return logger
    formatter = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    handler_view = logging.StreamHandler()
    handler_view.setFormatter(formatter)
    handler_view.setLevel(level_print)
    logger.addHandler(handler_view)
    if path_file is not None:
        os.makedirs(os.path.dirname(path_file) or ".", exist_ok=True)
        handler_save = logging.FileHandler(path_file)
        handler_save.setFormatter(formatter)
        handler_save.setLevel(level_save)
        logger.addHandler(handler_save)
    return logger


class LogBuffer:
    """Running averages of scalar training stats between log flushes."""

    def __init__(self):
        self._sum: dict[str, float] = defaultdict(float)
        self._count: dict[str, int] = defaultdict(int)
        self.output: dict[str, float] = {}

    def update(self, scalars: dict[str, float]) -> None:
        for k, v in scalars.items():
            self._sum[k] += float(v)
            self._count[k] += 1

    def average(self) -> dict[str, float]:
        self.output = {k: self._sum[k] / max(self._count[k], 1) for k in self._sum}
        return self.output

    def clear(self) -> None:
        self._sum.clear()
        self._count.clear()
        self.output = {}


class MetricWriter:
    """Thin tensorboardX wrapper; a no-op without tensorboardX."""

    def __init__(self, log_dir: str | None):
        self._writer = None
        if log_dir is not None:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                return
            self._writer = SummaryWriter(log_dir)

    def add_scalars(self, prefix: str, scalars: dict[str, float], step: int) -> None:
        if self._writer is None:
            return
        for k, v in scalars.items():
            self._writer.add_scalar(f"{prefix}{k}", float(v), step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
