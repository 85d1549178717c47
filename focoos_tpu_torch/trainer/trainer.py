"""FocoosTrainer and its iteration loop (port of focoos_tpu/trainer/trainer.py;
reference: focoos/trainer/trainer.py).

The loop feeds batches to the eager train step (``train_step.py``), stamps
its metrics into ``trainer/events.py``'s ``EventStorage`` (plain numpy) one step
late, so that the copy of step k's metrics waits on the card only after step
k+1 has been queued, and stops on a non-finite loss. The trainer writes
``model_info.json`` at each status change and the final weights (the EMA's
when enabled, with the live BatchNorm statistics) as ``model_final.npz`` in
the JAX package's layout. Periodic checkpoints and resume, evaluation and its
hooks, multi-step dispatch and sharding are not ported yet: asking for them
raises ``NotImplementedError``.
"""

from __future__ import annotations

import importlib
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from focoos_tpu_torch.ports import ArtifactName, ModelStatus, TrainerArgs
from focoos_tpu_torch.trainer import hooks as hooks_mod
from focoos_tpu_torch.trainer.events import EventStorage
from focoos_tpu_torch.utils.logger import get_logger
from focoos_tpu_torch.data.loaders import build_train_loader
from focoos_tpu_torch.trainer.solver import Solver, ema_decay_schedule
from focoos_tpu_torch.trainer.train_step import TrainState, build_train_step, create_train_state, unpack_metrics
from focoos_tpu_torch.utils.weights import to_jax_variables

logger = get_logger(__name__)


class TrainerLoop:
    """Iteration-based loop (reference: trainer/trainer.py:587-905)."""

    def __init__(
        self,
        step_fn: Callable,
        state: TrainState,
        data_iter: Iterable,
        max_iter: int,
        device: torch.device,
        gather_metric_period: int = 1,
    ):
        self.step_fn = step_fn
        self.state = state
        self._data_iter = iter(data_iter)
        self.max_iter = max_iter
        self.device = device
        self.iter = 0
        self.gather_metric_period = gather_metric_period
        self.steps_per_call = 1  # read by the hooks' period arithmetic (trainer/hooks.py)
        self.hooks: List[hooks_mod.HookBase] = []
        self.storage: Optional[EventStorage] = None
        self._pending = None

    def register_hooks(self, hooks: List[hooks_mod.HookBase]) -> None:
        for h in hooks:
            h.trainer = self
        self.hooks.extend(hooks)

    def train(self) -> None:
        logger.info(f"Starting training from iteration 0 to {self.max_iter}")
        with EventStorage(0) as self.storage:
            try:
                for h in self.hooks:
                    h.before_train()
                self.iter = 0
                while self.iter < self.max_iter:
                    self.storage.iter = self.iter
                    for h in self.hooks:
                        h.before_step()
                    self.run_step()
                    for h in self.hooks:
                        h.after_step()
                    self.iter += 1
            finally:
                self._flush(force=True)
                for h in self.hooks:
                    h.after_train()

    def run_step(self) -> None:
        t0 = time.perf_counter()
        images, targets = next(self._data_iter)
        images = images.to(self.device, non_blocking=True)
        targets = targets.to(self.device, non_blocking=True)
        data_time = time.perf_counter() - t0
        lr = self.state.solver.schedule(self.state.step)
        prev = self._pending
        keys, packed = self.step_fn(self.state, images, targets)
        # one-step-delayed fetch: step k's metrics are copied after step k+1 is queued
        self._pending = (keys, packed, data_time, lr, self.iter)
        if prev is not None and (prev[-1] + 1) % self.gather_metric_period == 0:
            self._flush_one(prev)

    def _flush(self, force: bool = False) -> None:
        if self._pending is None:
            return
        prev, self._pending = self._pending, None
        if force or (prev[-1] + 1) % self.gather_metric_period == 0:
            self._flush_one(prev)

    def _flush_one(self, pending) -> None:
        keys, packed, data_time, lr, rec_iter = pending
        metrics = unpack_metrics(keys, packed)
        total = metrics["total_loss"]
        if not np.isfinite(total):
            raise FloatingPointError(f"Loss became {total} at iteration {rec_iter}; aborting (NaN guard)")
        cur = self.storage.iter
        self.storage.iter = rec_iter
        try:
            self.storage.put_scalar("data_time", data_time, smoothing_hint=True)
            self.storage.put_scalar("lr", lr, smoothing_hint=False)
            for k, v in metrics.items():
                self.storage.put_scalar(k, v, smoothing_hint=True)
        finally:
            self.storage.iter = cur


def _versioned_run_dir(output_dir: str, run_name: str) -> str:
    """run-dir versioning (reference: trainer/trainer.py:84-93)."""
    base = os.path.join(output_dir, run_name)
    path, v = base, 1
    while os.path.exists(path) and os.listdir(path):
        path = f"{base}.v{v}"
        v += 1
    os.makedirs(path, exist_ok=True)
    return path


def _freeze_prefixes(model) -> tuple:
    """Parameter-name prefixes that ``freeze_at=N`` freezes: the stem and
    res2..res{N+1} (reference: nn/backbone/resnet.py:221-224)."""
    freeze_at = getattr(getattr(model.config, "backbone_config", None), "freeze_at", -1)
    if freeze_at is None or freeze_at < 0:
        return ()
    prefixes = ["pixel_decoder.backbone.conv1."]
    prefixes += [f"pixel_decoder.backbone.res_layers.{i}." for i in range(min(int(freeze_at), 4))]
    return tuple(prefixes)


def _unsupported(args: TrainerArgs, val_dataset) -> List[str]:
    """What ``args`` asks for that the port does not do yet (ROADMAP Queue 1 item 6)."""
    asks = {
        "evaluation during training (val_dataset)": val_dataset is not None,
        "resume": args.resume,
        "init_checkpoint": bool(args.init_checkpoint),
        "ckpt_dir": bool(args.ckpt_dir),
        f"periodic checkpoints (checkpointer_period {args.checkpointer_period} < max_iters {args.max_iters};"
        " set it to max_iters or more)": 0 < args.checkpointer_period < args.max_iters,
        f"steps_per_call {args.steps_per_call}": args.steps_per_call > 1,
        f"sharding {args.sharding!r}": args.sharding != "dp",
        f"mesh_shape {args.mesh_shape}": bool(args.mesh_shape),
        f"num_devices {args.num_devices}": args.num_devices not in (-1, 0, 1),
        "freeze_bn": args.freeze_bn,
        "sync_to_hub": args.sync_to_hub,
    }
    return [what for what, asked in asks.items() if asked]


class FocoosTrainer:
    """Training orchestration (reference: trainer/trainer.py:59-584) on the
    model's device, one process. It trains in the model's compute dtype
    (``ModelManager.get(..., dtype=)``), as the JAX trainer does: the forward
    and backward in that dtype, the parameters, gradients, clipping, AdamW
    state and EMA in fp32. ``TrainerArgs.amp_enabled`` is not read (the JAX
    trainer ignores it too)."""

    def __init__(self, model, args: TrainerArgs, train_dataset, val_dataset=None):
        missing = _unsupported(args, val_dataset)
        if missing:
            raise NotImplementedError(f"not ported yet (ROADMAP Queue 1 item 6): {', '.join(missing)}")
        family = model.model_info.model_family.value
        try:
            self.loss_module = importlib.import_module(f"focoos_tpu_torch.models.{family}.loss")
        except ModuleNotFoundError as e:
            raise NotImplementedError(f"training {family} is not ported yet (ROADMAP Queue 1)") from e
        self.model = model
        self.args = args
        self.train_dataset = train_dataset
        self.run_dir = _versioned_run_dir(args.output_dir, args.run_name)
        self.model_info = model.model_info

    def _set_status(self, status: ModelStatus, failure_reason: Optional[str] = None) -> None:
        """Status persisted to model_info.json (reference: trainer/trainer.py:558-584)."""
        self.model_info.status = status
        if failure_reason:
            self.model_info.description = f"{self.model_info.description or ''} [FAILED: {failure_reason[:300]}]"
        self.model_info.dump_json(self.run_dir)

    def train(self) -> Dict[str, Any]:
        args, model = self.args, self.model
        torch.manual_seed(args.seed)
        np.random.seed(args.seed)
        self._set_status(ModelStatus.TRAINING_STARTING)
        module = model.module
        solver = Solver(module, args, freeze_prefixes=_freeze_prefixes(model))
        state = create_train_state(module, solver, ema_enabled=args.ema_enabled)
        ema_fn = ema_decay_schedule(args.ema_decay, args.ema_warmup) if args.ema_enabled else None
        step_fn = build_train_step(self.loss_module.make_loss_fn(module, model.config), ema_fn)
        model.processor.train(True)
        loader = build_train_loader(
            self.train_dataset, model.processor, args.batch_size, seed=args.seed,
            max_instances=args.max_instances_per_image, pin_memory=model.device.type == "cuda",
        )
        self.loop = loop = TrainerLoop(step_fn, state, loader, args.max_iters, model.device,
                                       gather_metric_period=args.gather_metric_period)
        loop.register_hooks([
            hooks_mod.IterationTimer(),
            hooks_mod.PeriodicWriter([
                hooks_mod.CommonMetricPrinter(max_iter=args.max_iters),
                hooks_mod.JSONWriter(os.path.join(self.run_dir, ArtifactName.METRICS.value)),
            ], period=args.log_period),
        ])
        self._set_status(ModelStatus.TRAINING_RUNNING)
        try:
            loop.train()
        except Exception as e:
            self._set_status(ModelStatus.TRAINING_ERROR, failure_reason=str(e))
            raise
        finally:
            module.eval()
            model.processor.train(False)

        if state.ema_params is not None:  # the final weights are the EMA's
            with torch.no_grad():
                torch._foreach_copy_(list(module.parameters()), state.ema_params)
        weights_path = os.path.join(self.run_dir, ArtifactName.WEIGHTS.value)
        sd = {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}
        np.savez(weights_path, **to_jax_variables(sd, self.model_info.model_family.value))
        self.model_info.weights_uri = weights_path
        self._set_status(ModelStatus.TRAINING_COMPLETED)
        logger.info(f"Training complete. Artifacts in {self.run_dir}")
        return {"run_dir": self.run_dir, "metrics": {}, "iterations": loop.iter}


def run_train(model, args: TrainerArgs, train_dataset, val_dataset=None) -> Dict[str, Any]:
    """Entry point (reference: trainer/trainer.py:921)."""
    return FocoosTrainer(model, args, train_dataset, val_dataset).train()
