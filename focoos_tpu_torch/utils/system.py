"""System introspection (port of focoos_tpu/utils/system.py; reference:
focoos/utils/system.py:159-249).

``get_system_info()`` reports what the CLI's ``checks`` prints: Python,
torch and its CUDA, each visible card (name, memory, compute capability),
this process's rank and the world (``parallel/mesh.py``) and the versions of
numpy, scipy and einops. ``seed_all_rng`` is the JAX package's: Python's
``random`` and numpy's global state.
"""

from __future__ import annotations

import os
import platform
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class DeviceInfo:
    id: int
    kind: str
    platform: str
    memory_gb: Optional[float] = None
    compute_capability: Optional[str] = None


@dataclass
class SystemInfo:
    focoos_tpu_torch_version: str = ""
    python_version: str = ""
    system: str = ""
    torch_version: str = ""
    cuda_version: Optional[str] = None
    backend: str = ""
    device_count: int = 0
    devices: List[DeviceInfo] = field(default_factory=list)
    process_index: int = 0
    process_count: int = 1
    packages: Dict[str, str] = field(default_factory=dict)

    def pretty_print(self) -> None:
        for k in ("focoos_tpu_torch_version", "python_version", "system", "torch_version", "cuda_version", "backend",
                  "device_count", "process_index", "process_count"):
            print(f"{k}: {getattr(self, k)}")
        for d in self.devices:
            mem = f" {d.memory_gb:.1f} GB" if d.memory_gb else ""
            cc = f" sm_{d.compute_capability.replace('.', '')}" if d.compute_capability else ""
            print(f"  device {d.id}: {d.kind} ({d.platform}){mem}{cc}")
        for name, ver in self.packages.items():
            print(f"  {name}: {ver}")


def get_system_info() -> SystemInfo:
    import torch

    import focoos_tpu_torch
    from focoos_tpu_torch.parallel import mesh

    devices = []
    cuda = torch.cuda.is_available()
    for i in range(torch.cuda.device_count() if cuda else 0):
        p = torch.cuda.get_device_properties(i)
        devices.append(DeviceInfo(id=i, kind=p.name, platform="cuda", memory_gb=p.total_memory / 1e9,
                                  compute_capability=f"{p.major}.{p.minor}"))
    if not devices:
        devices.append(DeviceInfo(id=0, kind=platform.processor() or platform.machine(), platform="cpu"))

    packages = {}
    for name in ("numpy", "scipy", "einops"):
        try:
            mod = __import__(name)
            packages[name] = getattr(mod, "__version__", "?")
        except ImportError:
            pass

    return SystemInfo(
        focoos_tpu_torch_version=focoos_tpu_torch.__version__,
        python_version=sys.version.split()[0],
        system=f"{platform.system()} {platform.release()}",
        torch_version=torch.__version__,
        cuda_version=torch.version.cuda,
        backend="cuda" if cuda else "cpu",
        device_count=torch.cuda.device_count() if cuda else 0,
        devices=devices,
        process_index=mesh.get_rank(),
        process_count=mesh.get_world_size(),
        packages=packages,
    )


def seed_all_rng(seed: Optional[int] = None) -> int:
    """Seed python/numpy RNGs; returns the seed (derives one from os.urandom
    when None — reference: utils/env.py:21)."""
    import random as _random

    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
    _random.seed(seed)
    np.random.seed(seed % (2**32))
    return seed
