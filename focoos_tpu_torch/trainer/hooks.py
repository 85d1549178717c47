"""Hooks and metric writers of the port's trainer (port of
``focoos_tpu/trainer/hooks.py``, trimmed to what the port runs).

The port keeps its own copy so that it runs without ``focoos_tpu``. Same
4-phase lifecycle as the reference (focoos/trainer/hooks/base.py:5-48):
before_train / before_step / after_step / after_train, driven by the
TrainerLoop. The JAX-specific hooks map to torch: ``MemoryStatsHook`` reads
``torch.cuda.memory_allocated``, ``ProfilerHook`` (JAX's ``JaxProfilerHook``)
runs ``torch.profiler``; ``TensorboardWriter`` writes through ``tensorboardX``
as JAX's does. The hub sync is not ported (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from focoos_tpu_torch.parallel import mesh
from focoos_tpu_torch.trainer.events import get_event_storage
from focoos_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


class EarlyStopException(Exception):
    """Raised to abort the training loop (reference: hooks/early_stop.py:5)."""


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


class TensorboardWriter(EventWriter):
    """TensorBoard writer via tensorboardX (reference: hooks/tensorboard_writer.py:7).
    Raises ImportError where tensorboardX is missing; the trainer then goes without it."""

    def __init__(self, log_dir: str, window_size: int = 20):
        from tensorboardX import SummaryWriter

        self._writer = SummaryWriter(log_dir)
        self.window_size = window_size
        self._last_write = -1

    def write(self):
        storage = get_event_storage()
        new_last = self._last_write
        for k, (v, itr) in storage.latest_with_smoothing_hint(self.window_size).items():
            if itr > self._last_write:
                self._writer.add_scalar(k, v, itr)
                new_last = max(new_last, itr)
        self._last_write = new_last
        for name, img, itr in storage._vis_data:
            self._writer.add_image(name, img, itr, dataformats="HWC")
        storage.clear_images()
        for h in storage._histograms:
            self._writer.add_histogram_raw(
                tag=h["tag"],
                min=float(h["edges"][0]),
                max=float(h["edges"][-1]),
                num=int(h["counts"].sum()),
                sum=0.0,
                sum_squares=0.0,
                bucket_limits=h["edges"][1:].tolist(),
                bucket_counts=h["counts"].tolist(),
                global_step=h["global_step"],
            )
        storage.clear_histograms()

    def close(self):
        self._writer.close()


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


class LRSchedulerHook(HookBase):
    """Log the scheduled LR; the solver applies it (reference: hooks/hook.py:297)."""

    def __init__(self, schedule_fn: Callable[[int], float]):
        self._schedule = schedule_fn

    def after_step(self):
        get_event_storage().put_scalar("lr", float(self._schedule(self.trainer.iter)), smoothing_hint=False)


class PeriodicCheckpointerHook(HookBase):
    """(reference: hooks/hook.py:188)"""

    def __init__(self, periodic_checkpointer):
        self._pc = periodic_checkpointer

    def after_step(self):
        stride = max(1, int(getattr(self.trainer, "steps_per_call", 1)))
        self._pc.step(self.trainer.iter, self.trainer.state, stride=stride,
                      hooks=self.trainer.hook_state_dict())


class BestCheckpointer(HookBase):
    """Track a validation metric and save model_best (reference: hooks/hook.py:207)."""

    def __init__(self, checkpointer, val_metric: str, mode: str = "max", file_prefix: str = "model_best"):
        self._checkpointer = checkpointer
        self._metric = val_metric
        self._mode = mode
        self._prefix = file_prefix
        self.best_value: Optional[float] = None
        self.best_iter: Optional[int] = None

    def _update_best(self, val: float, iteration: int) -> bool:
        if val is None or np.isnan(val) or np.isinf(val):
            return False
        if self.best_value is None or (val > self.best_value if self._mode == "max" else val < self.best_value):
            self.best_value, self.best_iter = float(val), int(iteration)
            return True
        return False

    def after_step(self):
        storage = get_event_storage()
        latest = storage.latest().get(self._metric)
        if latest is None:
            return
        val, itr = latest
        if itr == storage.iter and self._update_best(val, itr):
            self._checkpointer.save(self._prefix, self.trainer.state, iteration=itr, best_metric=self.best_value)
            logger.info(f"Saved best model at iter {itr} with {self._metric}={self.best_value:.4f}")

    def state_dict(self):
        return {"best_value": self.best_value, "best_iter": self.best_iter}

    def load_state_dict(self, state):
        self.best_value = state.get("best_value")
        self.best_iter = state.get("best_iter")


class EvalHook(HookBase):
    """Run eval_fn every ``period`` iters + at the end (reference: hooks/hook.py:498)."""

    def __init__(self, period: int, eval_fn: Callable[[], Optional[Dict[str, float]]]):
        self._period = period
        self._fn = eval_fn

    def _do_eval(self):
        results = self._fn()
        if results:
            storage = get_event_storage()
            for k, v in _flatten_metrics(results).items():
                try:
                    storage.put_scalar(k, float(v), smoothing_hint=False)
                except (TypeError, ValueError):
                    pass

    def after_step(self):
        t = self.trainer
        if _period_hit(t, self._period) and not _is_final_call(t):
            self._do_eval()

    def after_train(self):
        if self.trainer.iter >= self.trainer.max_iter - 1:
            self._do_eval()


class EarlyStoppingHook(HookBase):
    """Abort when a watched metric stops improving (reference: hooks/early_stop.py:10-76)."""

    def __init__(self, patience: int, metric: str, mode: str = "max"):
        self._patience = patience
        self._metric = metric
        self._mode = mode
        self._best: Optional[float] = None
        self._since_best = 0

    def after_step(self):
        storage = get_event_storage()
        latest = storage.latest().get(self._metric)
        if latest is None:
            return
        val, itr = latest
        if itr != storage.iter:
            return
        improved = self._best is None or (val > self._best if self._mode == "max" else val < self._best)
        if improved:
            self._best = val
            self._since_best = 0
        else:
            self._since_best += 1
            if self._since_best >= self._patience:
                logger.warning(
                    f"Early stopping at iter {storage.iter}: {self._metric} did not improve "
                    f"for {self._patience} evaluations (best {self._best:.4f})"
                )
                raise EarlyStopException()

    def state_dict(self):
        return {"best": self._best, "since_best": self._since_best}

    def load_state_dict(self, state):
        self._best = state.get("best")
        self._since_best = state.get("since_best", 0)


class MemoryStatsHook(HookBase):
    """Device memory in use, ``device_mem_mb`` (reference TorchMemoryStats:
    hooks/hook.py:562). Records nothing off the card, as the JAX package
    records nothing where the device has no ``memory_stats``."""

    def __init__(self, device: torch.device, period: int = 20):
        self._device = torch.device(device)
        self._period = period

    def after_step(self):
        if self._device.type != "cuda" or not _period_hit(self.trainer, self._period):
            return
        get_event_storage().put_scalar("device_mem_mb", torch.cuda.memory_allocated(self._device) / 1e6,
                                       smoothing_hint=False)


class ProfilerHook(HookBase):
    """``torch.profiler`` over iterations ``[start_iter, start_iter + num_iters)``
    (JAX's ``JaxProfilerHook``; reference TorchProfiler: hooks/hook.py:359):
    CPU activity, and CUDA activity on a machine with a card, which is
    synchronized when the window opens and when it closes. The Chrome trace
    goes to ``output_dir/profile_iter_<first>-<last>.pt.trace.json``
    (``trace_path``); ``profiler`` keeps the profiler for its in-memory
    events. Under ``steps_per_call`` K > 1 the window opens before the call
    that holds ``start_iter`` and closes after the call that reaches the
    window's end, so it covers whole calls; with K = 1 that is JAX's
    ``iter == start_iter`` and ``iter + 1 >= start_iter + num_iters``. In a
    process group rank 0 writes its trace."""

    def __init__(self, output_dir: str, start_iter: int = 10, num_iters: int = 5):
        self._dir = output_dir
        self._start = start_iter
        self._stop = start_iter + num_iters
        self._active = False
        self._first = None
        self.profiler = None
        self.trace_path: Optional[str] = None

    @staticmethod
    def _sync() -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def before_step(self):
        it, k = self.trainer.iter, max(1, int(getattr(self.trainer, "steps_per_call", 1)))
        if not self._active and self.profiler is None and it <= self._start < it + k:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._sync()
            self.profiler = torch.profiler.profile(activities=activities)
            self.profiler.__enter__()
            self._active, self._first = True, it

    def after_step(self):
        it, k = self.trainer.iter, max(1, int(getattr(self.trainer, "steps_per_call", 1)))
        if self._active and it + k >= self._stop:
            self._close(it + k - 1)

    def after_train(self):
        if self._active:  # the run ended inside the window
            self._close(self.trainer.iter - 1)

    def _close(self, last: int) -> None:
        self._sync()
        self.profiler.__exit__(None, None, None)
        self._active = False
        if not mesh.is_main_process():  # every rank profiles, rank 0 writes its trace
            return
        os.makedirs(self._dir, exist_ok=True)
        self.trace_path = os.path.join(self._dir, f"profile_iter_{self._first}-{last}.pt.trace.json")
        self.profiler.export_chrome_trace(self.trace_path)
        logger.info(f"Saved profiler trace to {self.trace_path}")


class VisualizationHook(HookBase):
    """Render N validation predictions into a mosaic every period
    (reference: hooks/visualization.py:39)."""

    def __init__(self, period: int, render_fn: Callable[[], Optional[np.ndarray]], name: str = "val_predictions"):
        self._period = period
        self._render = render_fn
        self._name = name

    def after_step(self):
        if not _period_hit(self.trainer, self._period):
            return
        img = self._render()
        if img is not None:
            get_event_storage().put_image(self._name, img)


def _flatten_metrics(d: dict, prefix: str = "") -> Dict[str, float]:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_metrics(v, prefix=f"{key}/"))
        else:
            out[key] = v
    return out
