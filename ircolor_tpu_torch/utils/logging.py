"""Logging (``ircolor_tpu/utils/logging.py``): the stdout logger of
human-readable lines and an optional JSONL stream of durable metrics."""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import IO, Any


def get_logger(name: str = "ircolor_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers and not logging.getLogger().handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class JsonlLogger:
    """Appends one JSON object per event to a file (or any stream); a no-op
    without either."""

    def __init__(self, path: str | None = None, stream: IO[str] | None = None):
        self._file: IO[str] | None = stream
        self._owns = False
        if path is not None:
            self._file = open(path, "a", encoding="utf-8")
            self._owns = True

    def log(self, event: str, **fields: Any) -> None:
        if self._file is None:
            return
        rec = {"ts": time.time(), "event": event, **fields}
        self._file.write(json.dumps(rec, default=float) + "\n")
        self._file.flush()

    def close(self) -> None:
        if self._file is not None and self._owns:
            self._file.close()
        self._file = None

    def __enter__(self) -> "JsonlLogger":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
