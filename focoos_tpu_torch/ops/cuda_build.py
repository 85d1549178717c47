"""Build and load the hand-written CUDA kernels in ``focoos_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with ``ctypes``: no PyTorch headers, so
nvcc compiles the kernel and nothing else. The build happens at first use,
never at import, into ``focoos_tpu_torch/_build/``, and is keyed by a hash of
the sources and flags: a checkout builds everything it needs from its own
files, and an edited source is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per library: seconds spent in nvcc (0.0 when the .so was already built) and
# the compiler's report (ptxas registers / shared memory / spills)
build_seconds: Dict[str, float] = {}
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        candidates.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for cand in candidates:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    for path in [src, *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _so_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(CSRC_DIR / f'{name}.cu')}.so"


def _build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless its hash has a build; the seconds nvcc took."""
    src = CSRC_DIR / f"{name}.cu"
    so = _so_path(name)
    if so.is_file():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}\n{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its hash has no build yet, then load it."""
    with _lock:
        if name in _libs:
            return _libs[name]
        seconds = _build(name)
        so = _so_path(name)
        log = so.with_suffix(".log")
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        build_seconds.setdefault(name, seconds)
        build_log[name] = log.read_text() if log.is_file() else ""
        return lib


def load_libraries(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build every named kernel with one nvcc each, all started together, then load them."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for name, seconds in zip(names, pool.map(_build, names)):
            build_seconds[name] = seconds
    return {name: load_library(name) for name in names}


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a kernel's C function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {"float32": 0, "bfloat16": 1}
