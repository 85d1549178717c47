"""Device time from ``torch.profiler`` traces (port of
``focoos_tpu/utils/profiling.py``; reference TorchProfiler:
focoos/trainer/hooks/hook.py:359, Chrome-trace export).

The trace is parsed on the host to recover the card's kernel time: the number
that separates a kernel regression from the host's weather. The device track
is the trace's kernel, memcpy and memset events (Kineto's ``cat``). Ranges
the code annotates on the card's timeline (``gpu_user_annotation``) are not
kernels and are left out, as ``chip_smoke.py::device_busy`` leaves them out
of the profiler's in-memory events: both take the union through ``busy_us``.
"""

from __future__ import annotations

import collections
import gzip
import json
import os
import shutil
import tempfile
from typing import Iterable, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(path: str) -> list:
    """The device track's complete (``ph`` X) events of the Chrome trace file
    ``path`` (plain or ``.gz``)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    return [e for e in events if e.get("ph") == "X" and e.get("dur") and e.get("cat") in DEVICE_CATEGORIES]


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals: nested or
    overlapping spans (two streams) count once."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, t in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def parse_trace(path: str):
    """→ ``(dur, meta)``: summed microseconds per device kernel name over the
    whole trace file, and the first ``args`` seen for each name."""
    dur: collections.Counter = collections.Counter()
    meta: dict = {}
    for e in device_events(path):
        dur[e["name"]] += e["dur"]
        if e.get("args") and e["name"] not in meta:
            meta[e["name"]] = e["args"]
    return dur, meta


def parse_trace_busy_us(path: str) -> float:
    """Device busy microseconds: the union of the device events' intervals."""
    return busy_us((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device_events(path))


def device_op_ms(run, n_calls: int = 1, per: int = 1) -> float:
    """Device busy milliseconds of ``n_calls`` calls of ``run()`` under the
    profiler (CPU and CUDA activity; the card synchronized before and after),
    divided by ``n_calls * per`` (``per``: the work items one call holds).
    Raises without a card: there is no device time to read."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_op_ms needs a CUDA device: without one the profiler records no device time")
    trace_dir = tempfile.mkdtemp(prefix="focoos_devms_")
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(n_calls):
                run()
            torch.cuda.synchronize()
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        return parse_trace_busy_us(path) / (n_calls * per) / 1e3
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
