"""The latency loops behind ``FocoosModel.benchmark`` / ``end2end_benchmark``
and the serving runtimes' (``infer/``): one loop for the card's time of a
call, one for a request's time on the host clock, both summarized into one
``LatencyMetrics``."""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch

from focoos_tpu_torch.ports import LatencyMetrics


def latency_metrics(times_ms: Sequence[float], engine: str, im_size: int, device: torch.device) -> LatencyMetrics:
    arr = np.asarray(times_ms, dtype=np.float64)
    return LatencyMetrics(
        fps=int(round(1000.0 / arr.mean())),
        engine=engine,
        min=round(float(arr.min()), 3),
        max=round(float(arr.max()), 3),
        mean=round(float(arr.mean()), 3),
        std=round(float(arr.std()), 3),
        im_size=int(im_size),
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    )


def cuda_event_latency(fn: Callable[[], object], iterations: int, engine: str, im_size: int,
                       device: torch.device) -> LatencyMetrics:
    """Device time of ``fn()``: CUDA events around each of ``iterations``
    calls after three warm-up calls (first launches, kernel builds, cuDNN
    autotune). Raises off the card: a CPU time is not a device number."""
    if device.type != "cuda":
        raise RuntimeError(f"benchmark times the card with CUDA events, not {device}")
    for _ in range(3):
        fn()
    times = []
    for _ in range(iterations):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return latency_metrics(times, engine, im_size, device)


def end2end_latency(call: Callable[[list], object], size: int, iterations: int, engine: str,
                    device: torch.device) -> LatencyMetrics:
    """Host time of ``call([image])`` on one seeded size² uint8 image, after
    one warm-up call; ``call`` synchronizes the card before it returns."""
    img = np.random.default_rng(0).integers(0, 255, (size, size, 3), dtype=np.uint8)
    call([img])
    times = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        call([img])
        times.append((time.perf_counter() - t0) * 1000)
    return latency_metrics(times, engine, size, device)
