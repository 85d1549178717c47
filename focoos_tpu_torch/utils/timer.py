"""Timing helpers (port of ``focoos_tpu/utils/timer.py``; reference:
focoos/utils/timer.py). Card work is queued, not done, when a call returns:
``Timer`` and ``took`` synchronize the card (once CUDA is initialized)
before they read the clock."""

from __future__ import annotations

import functools
import time
from typing import Callable

import torch

from focoos_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _clock() -> float:
    """The clock after the card's queued work is done."""
    _sync()
    return time.perf_counter()


class Timer:
    """Context-manager + cumulative timer; the card is synchronized at each
    reading of the clock."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._start = _clock()
        self._paused_at = None
        self._paused_total = 0.0

    def pause(self) -> None:
        if self._paused_at is None:
            self._paused_at = _clock()

    def resume(self) -> None:
        if self._paused_at is not None:
            self._paused_total += _clock() - self._paused_at
            self._paused_at = None

    def seconds(self) -> float:
        end = self._paused_at if self._paused_at is not None else _clock()
        return end - self._start - self._paused_total

    def __enter__(self) -> "Timer":
        self.reset()
        return self

    def __exit__(self, *a) -> None:
        self.elapsed = self.seconds()


def took(func: Callable) -> Callable:
    """Decorator logging wall-clock of each call (reference @took), the card
    synchronized at both ends."""

    @functools.wraps(func)
    def wrapped(*args, **kwargs):
        t0 = _clock()
        result = func(*args, **kwargs)
        logger.info(f"{func.__name__} took {(_clock() - t0) * 1000:.1f} ms")
        return result

    return wrapped
