"""Logging: the JAX package's stdout logger (``ircolor_tpu/utils/logging.py``)."""

from __future__ import annotations

import logging
import sys


def get_logger(name: str = "ircolor_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers and not logging.getLogger().handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
