"""Out-of-memory retry (port of ``focoos_tpu/utils/memory.py``; reference:
focoos/utils/memory.py:25-83)."""

from __future__ import annotations

import functools
from typing import Callable

import torch

from focoos_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def retry_if_oom(func: Callable) -> Callable:
    """Call ``func``; on ``torch.OutOfMemoryError`` empty the caching
    allocator's cache and call it once more; an OOM there propagates.

    The JAX package then retries a third time on the CPU
    (focoos_tpu/utils/memory.py:40-44); the port leaves that out on purpose:
    a fallback that quietly moves the work off the card hides the device
    (ROADMAP Queue 1 item 5)."""

    @functools.wraps(func)
    def wrapped(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except torch.OutOfMemoryError:
            logger.warning(f"{func.__name__}: device OOM, emptying the cache and retrying")
            torch.cuda.empty_cache()
        return func(*args, **kwargs)

    return wrapped
