"""Colored logger (copy of ``focoos_tpu/utils/logger.py``, trimmed to
``get_logger``; reference: focoos/utils/logger.py). The port keeps its own
copy so that it runs without ``focoos_tpu``."""

from __future__ import annotations

import functools
import logging
import os
import sys

_LOG_LEVEL = os.getenv("FOCOOS_TPU_LOG_LEVEL", "INFO").upper()

_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[35m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelname, "")
            return f"{color}{msg}{_RESET}"
        return msg


@functools.lru_cache(maxsize=None)
def get_logger(name: str = "focoos_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(_LOG_LEVEL)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_ColorFormatter("%(asctime)s [%(name)s] %(levelname)s: %(message)s", "%H:%M:%S"))
    logger.addHandler(handler)
    logger.propagate = False
    return logger
