"""Logging: the reference's dual-handler logger (console INFO + file
WARNING). The port's own copy of ``istnet_tpu/utils/logging.py``; the
running averages and the scalar writer come with the solver."""

from __future__ import annotations

import logging
import os


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
