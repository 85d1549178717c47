"""Environment-driven configuration (port of focoos_tpu/config.py; reference:
focoos/config.py:26-69).

A plain dataclass read from the same ``FOCOOS_*`` variables as the JAX
package's. Its readers are the CLI's ``settings`` verb and the hub client
(the API key and host URL), as in the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from focoos_tpu_torch.ports import PROD_API_URL, RuntimeType


def _env(name: str, default):
    raw = os.getenv(name)
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(raw)
    return raw


@dataclass
class FocoosConfig:
    """The ``FOCOOS_*`` variables, as the JAX package reads them. Only the hub
    client reads ``focoos_api_key`` and ``default_host_url``. The other four
    are kept for parity with the JAX package's ``settings``, which reports
    them, and nothing in the port reads them: ``runtime_type`` (default
    ``CUDA_BF16``, the counterpart of ``XLA_TPU_BF16``; ``export`` takes
    ``--runtime``), ``warmup_iter``, ``focoos_log_level`` and
    ``compile_cache_enabled`` (the kernels' builds, ``ops/cuda_build.py``,
    are always cached in ``focoos_tpu_torch/_build/``, keyed by a hash of
    their sources, and eager PyTorch compiles no programs)."""

    focoos_api_key: str = field(default_factory=lambda: _env("FOCOOS_API_KEY", ""))
    focoos_log_level: str = field(default_factory=lambda: _env("FOCOOS_LOG_LEVEL", "INFO"))
    default_host_url: str = field(default_factory=lambda: _env("FOCOOS_HOST_URL", PROD_API_URL))
    runtime_type: RuntimeType = field(
        default_factory=lambda: RuntimeType(_env("FOCOOS_RUNTIME_TYPE", RuntimeType.CUDA_BF16.value))
    )
    warmup_iter: int = field(default_factory=lambda: _env("FOCOOS_WARMUP_ITER", 2))
    compile_cache_enabled: bool = field(default_factory=lambda: _env("FOCOOS_COMPILE_CACHE", True))


FOCOOS_CONFIG = FocoosConfig()
