"""Hooks and metric writers of the port's trainer (copy of
``focoos_tpu/trainer/hooks.py``, trimmed to what the port runs: ``HookBase``,
``EventWriter``, ``CommonMetricPrinter``, ``JSONWriter``, ``IterationTimer``,
``PeriodicWriter`` and the period helpers they call).

The port keeps its own copy so that it runs without ``focoos_tpu``; the JAX
package's module also holds hooks that import JAX. Same 4-phase lifecycle as
the reference (focoos/trainer/hooks/base.py:5-48): before_train /
before_step / after_step / after_train, driven by the TrainerLoop.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import List, Optional

from focoos_tpu_torch.trainer.events import get_event_storage
from focoos_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def _period_hit(trainer, period: int) -> bool:
    """True when any completed iteration of this host call lands on the period
    boundary: some multiple of ``period`` lies in (iter, iter + steps_per_call].

    With multi-step dispatch (steps_per_call=K>1) the loop advances K optimizer
    iterations per host call; a strict ``(iter+1) % period`` check fires late or
    never for periods not aligned to K (ADVICE r1 medium). For K=1 this reduces
    exactly to ``(iter+1) % period == 0``.
    """
    if period <= 0:
        return False
    k = max(1, int(getattr(trainer, "steps_per_call", 1)))
    return (trainer.iter + k) // period > trainer.iter // period


def _is_final_call(trainer) -> bool:
    """True when this host call completes the last training iteration."""
    k = max(1, int(getattr(trainer, "steps_per_call", 1)))
    return trainer.iter + k >= trainer.max_iter


class HookBase:
    trainer = None  # set by TrainerLoop.register_hooks

    def before_train(self):
        pass

    def after_train(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------


class EventWriter:
    def write(self):
        raise NotImplementedError

    def close(self):
        pass


class CommonMetricPrinter(EventWriter):
    """Console metrics line (reference: hooks/metrics_printer.py:14)."""

    def __init__(self, max_iter: Optional[int] = None, window_size: int = 20):
        self.max_iter = max_iter
        self.window_size = window_size

    def write(self):
        storage = get_event_storage()
        iteration = storage.iter
        try:
            data_time = storage.history("data_time").avg(self.window_size)
        except KeyError:
            data_time = None
        try:
            iter_time = storage.history("time").global_avg()
        except KeyError:
            iter_time = None
        eta = ""
        if iter_time is not None and self.max_iter:
            eta_seconds = iter_time * (self.max_iter - iteration - 1)
            eta = f"eta: {datetime.timedelta(seconds=int(eta_seconds))}  "
        losses = "  ".join(
            f"{k}: {v:.4g}"
            for k, (v, _) in sorted(storage.latest_with_smoothing_hint(self.window_size).items())
            if "loss" in k
        )
        lr = storage.latest().get("lr", (None, None))[0]
        lr_str = f"lr: {lr:.3e}  " if lr is not None else ""
        t_str = f"time: {iter_time:.4f}  " if iter_time is not None else ""
        d_str = f"data_time: {data_time:.4f}  " if data_time is not None else ""
        logger.info(f"{eta}iter: {iteration}  {losses}  {t_str}{d_str}{lr_str}")


class JSONWriter(EventWriter):
    """metrics.json JSONL writer (reference: hooks/metrics_json_writer.py:13)."""

    def __init__(self, json_file: str, window_size: int = 20):
        os.makedirs(os.path.dirname(json_file) or ".", exist_ok=True)
        self._file = open(json_file, "a")
        self.window_size = window_size

    def write(self):
        storage = get_event_storage()
        to_save = {"iteration": storage.iter}
        to_save.update({k: v for k, (v, _) in storage.latest_with_smoothing_hint(self.window_size).items()})
        self._file.write(json.dumps(to_save) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()


# ---------------------------------------------------------------------------
# hooks
# ---------------------------------------------------------------------------


class IterationTimer(HookBase):
    """time / data_time metrics (reference: hooks/hook.py:84)."""

    def __init__(self, warmup_iter: int = 3):
        self._warmup_iter = warmup_iter
        self._start_time = time.perf_counter()
        self._step_start = None

    def before_train(self):
        self._start_time = time.perf_counter()

    def before_step(self):
        self._step_start = time.perf_counter()

    def after_step(self):
        if self._step_start is not None:
            get_event_storage().put_scalar("time", time.perf_counter() - self._step_start, smoothing_hint=True)

    def after_train(self):
        total = time.perf_counter() - self._start_time
        logger.info(f"Total training time: {datetime.timedelta(seconds=int(total))}")


class PeriodicWriter(HookBase):
    """Flush writers every ``period`` iters (reference: hooks/hook.py:156)."""

    def __init__(self, writers: List[EventWriter], period: int = 20):
        self._writers = writers
        self._period = period

    def after_step(self):
        t = self.trainer
        if _period_hit(t, self._period) or _is_final_call(t):
            for w in self._writers:
                w.write()

    def after_train(self):
        for w in self._writers:
            w.write()
            w.close()
