"""FocoosTrainer and its iteration loop (port of focoos_tpu/trainer/trainer.py;
reference: focoos/trainer/trainer.py).

The loop feeds batches to the eager train step (``train_step.py``), K of them
per host call with ``TrainerArgs.steps_per_call = K`` (their metrics averaged
on the card, ``iter`` advancing by K; the last call takes ``max_iter - iter``
where fewer than K steps are left, so a run takes ``max_iter`` optimizer
steps, where the JAX package's loop takes K), stamps the metrics into
``trainer/events.py``'s ``EventStorage`` (plain numpy) one call late, so that
the copy of call k's metrics waits on the card only after call k+1 has been
queued, stops on a non-finite loss and ends cleanly on ``EarlyStopException``.
The trainer registers the JAX package's hooks: the LR log, device memory, the
TensorBoard writer where ``tensorboardX`` imports, in-training validation
with the best checkpoint, early stopping and prediction mosaics, and periodic
checkpoints (``trainer/checkpointer.py``) that ``resume`` restarts from. It writes
``model_info.json`` at each status change, the final weights (the EMA's when
enabled, with the live BatchNorm statistics) as ``model_final.npz`` in the
JAX package's layout, and the final validation metrics into
``model_info.json``.

In a process group (``parallel/launch.py``; ``FocoosModel.train`` launches
one with ``num_devices`` > 1) each rank trains on its share of every batch
through the module wrapped for ``TrainerArgs.sharding``: ``dp``
(DistributedDataParallel) or ``fsdp`` (FSDP2 on a copy of the module, whose
full weights go back into the model for validation and at the end). The
losses and norms reduce over the global batch (``parallel/mesh.py``), so
the step is the one-process step on the global batch. Rank 0 alone writes
``model_info.json``, the weights, checkpoints, metrics, TensorBoard events,
mosaics and profiler traces, and syncs the run to the hub
(``sync_to_hub``); every rank validates its share of the validation set and
returns the merged metrics. ``init_checkpoint`` and tensor parallelism
(``tp``, ``fsdp_tp``, a 2-D ``mesh_shape``) are not ported yet: asking for
them raises ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import importlib
import math
import os
import time
import traceback
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from focoos_tpu_torch.data.loaders import build_train_loader
from focoos_tpu_torch.nn.layers.common import BatchNorm, MaskedBatchNorm1d, clear_cast_caches
from focoos_tpu_torch.parallel import mesh
from focoos_tpu_torch.parallel.sharding import apply_sharding, check_mode, full, full_state_dict, load_full_state_dict
from focoos_tpu_torch.ports import ArtifactName, ModelStatus, Task, TrainerArgs
from focoos_tpu_torch.trainer import hooks as hooks_mod
from focoos_tpu_torch.trainer.checkpointer import Checkpointer, PeriodicCheckpointerMixin
from focoos_tpu_torch.trainer.events import EventStorage
from focoos_tpu_torch.trainer.solver import Solver, ema_decay_schedule
from focoos_tpu_torch.trainer.train_step import (
    TrainState,
    build_multi_train_step,
    build_train_step,
    create_train_state,
    unpack_metrics,
)
from focoos_tpu_torch.utils.logger import get_logger
from focoos_tpu_torch.utils.system import seed_all_rng

logger = get_logger(__name__)

TASK_METRICS = {
    Task.DETECTION: "bbox/AP",
    Task.SEMSEG: "sem_seg/mIoU",
    Task.INSTANCE_SEGMENTATION: "segm/AP",
    Task.CLASSIFICATION: "classification/f1",
    Task.KEYPOINT: "keypoints/AP",
}


class TrainerLoop:
    """Iteration-based loop (reference: trainer/trainer.py:587-905)."""

    def __init__(
        self,
        step_fn: Callable,
        state: TrainState,
        data_iter: Iterable,
        max_iter: int,
        device: torch.device,
        start_iter: int = 0,
        gather_metric_period: int = 1,
        steps_per_call: int = 1,
    ):
        """``step_fn(state, images, targets)``, or with ``steps_per_call`` K > 1
        ``step_fn(state, [(images, targets)] * K)`` (``build_multi_train_step``)."""
        self.step_fn = step_fn
        self.state = state
        self._data_iter = iter(data_iter)
        self.max_iter = max_iter
        self.device = device
        self.start_iter = start_iter
        self.iter = start_iter
        self.gather_metric_period = gather_metric_period
        self.steps_per_call = max(1, int(steps_per_call))  # also read by the hooks' period arithmetic
        self.hooks: List[hooks_mod.HookBase] = []
        self.storage: Optional[EventStorage] = None
        self._pending = None

    def register_hooks(self, hooks: List[hooks_mod.HookBase]) -> None:
        for h in hooks:
            h.trainer = self
        self.hooks.extend(hooks)

    def hook_state_dict(self) -> dict:
        return {type(h).__name__: h.state_dict() for h in self.hooks if h.state_dict()}

    def load_hook_state_dict(self, state: dict) -> None:
        for h in self.hooks:
            if type(h).__name__ in state:
                h.load_state_dict(state[type(h).__name__])

    def train(self) -> None:
        logger.info(f"Starting training from iteration {self.start_iter} to {self.max_iter}")
        with EventStorage(self.start_iter) as self.storage:
            try:
                for h in self.hooks:
                    h.before_train()
                self.iter = self.start_iter
                while self.iter < self.max_iter:
                    self.storage.iter = self.iter
                    for h in self.hooks:
                        h.before_step()
                    self.run_step()
                    for h in self.hooks:
                        h.after_step()
                    self.iter += hooks_mod._call_steps(self)
            except hooks_mod.EarlyStopException:
                logger.info("Early stopping triggered")
            except Exception:
                logger.error(f"Exception during training:\n{traceback.format_exc()}")
                raise
            finally:
                self._flush(force=True)
                for h in self.hooks:
                    h.after_train()

    def run_step(self) -> None:
        t0 = time.perf_counter()
        batches = []
        for _ in range(hooks_mod._call_steps(self)):  # K, or the fewer left before max_iter
            images, targets = next(self._data_iter)
            batches.append((images.to(self.device, non_blocking=True), targets.to(self.device, non_blocking=True)))
        data_time = time.perf_counter() - t0
        prev = self._pending
        if self.steps_per_call == 1:
            keys, packed = self.step_fn(self.state, *batches[0])
        else:
            keys, packed = self.step_fn(self.state, batches)
        # one-call-delayed fetch: call k's metrics are copied after call k+1 is queued
        self._pending = (keys, packed, data_time, self.iter)
        if prev is not None and (prev[-1] + 1) % self.gather_metric_period == 0:
            self._flush_one(prev)

    def _flush(self, force: bool = False) -> None:
        if self._pending is None:
            return
        prev, self._pending = self._pending, None
        if force or (prev[-1] + 1) % self.gather_metric_period == 0:
            self._flush_one(prev)

    def _flush_one(self, pending) -> None:
        keys, packed, data_time, rec_iter = pending
        metrics = unpack_metrics(keys, packed)
        total = metrics["total_loss"]
        if not np.isfinite(total):
            raise FloatingPointError(f"Loss became {total} at iteration {rec_iter}; aborting (NaN guard)")
        cur = self.storage.iter
        self.storage.iter = rec_iter
        try:
            self.storage.put_scalar("data_time", data_time, smoothing_hint=True)
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


def _unsupported(args: TrainerArgs) -> List[str]:
    """What ``args`` asks for that the port does not do yet, each with its ROADMAP Queue 1 item."""
    asks = {
        "init_checkpoint (item 5; the JAX trainer reads it nowhere)": bool(args.init_checkpoint),
        f"sharding {args.sharding!r} (item 9: tensor parallelism)": args.sharding in ("tp", "fsdp_tp"),
        f"mesh_shape {args.mesh_shape} (item 9: a 2-D mesh)": bool(args.mesh_shape) and len(args.mesh_shape) > 1,
    }
    return [what for what, asked in asks.items() if asked]


def check_ported(args: TrainerArgs) -> None:
    """Raise on what ``args`` asks for that the port does not do yet (``NotImplementedError``,
    naming its ROADMAP item) or does not know (``ValueError``)."""
    missing = _unsupported(args)
    if missing:
        raise NotImplementedError(f"not ported yet (ROADMAP Queue 1): {', '.join(missing)}")
    check_mode(args.sharding)


def requested_world(args: TrainerArgs, device: torch.device) -> int:
    """The number of ranks ``args`` asks for: a 1-D ``mesh_shape``'s size,
    else ``num_devices`` (-1: every local CUDA device for a model on the
    card, one on the CPU; 0: one)."""
    if args.mesh_shape:
        return int(args.mesh_shape[0])
    if args.num_devices == -1:
        return max(torch.cuda.device_count(), 1) if torch.device(device).type == "cuda" else 1
    return max(int(args.num_devices), 1)


class _StepModule(torch.nn.Module):
    """The model and its loss under one forward, so that DDP's reducer and
    FSDP's root see every parameter the loss reaches (rtmo's criterion runs
    DCC after the model's forward)."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, images, targets):
        return self.loss_fn(images, targets)


class FocoosTrainer:
    """Training orchestration (reference: trainer/trainer.py:59-584) on the
    model's device, one process. It trains in the model's compute dtype
    (``ModelManager.get(..., dtype=)``), as the JAX trainer does: the forward
    and backward in that dtype, the parameters, gradients, clipping,
    optimizer state and EMA in fp32. ``TrainerArgs.amp_enabled`` is not read
    (the JAX trainer ignores it too)."""

    def __init__(self, model, args: TrainerArgs, train_dataset, val_dataset=None, hub=None):
        """``hub``: the ``FocoosHUB`` that ``args.sync_to_hub`` syncs to (default: ``FocoosHUB()``)."""
        check_ported(args)
        asked, world = requested_world(args, model.device), mesh.get_world_size()
        explicit = bool(args.mesh_shape) or args.num_devices > 1
        if (explicit and asked != world) or (not mesh.is_initialized() and asked > 1):
            raise ValueError(f"args ask for {asked} ranks, this process group has {world}: "
                             "train through FocoosModel.train or parallel.launch")
        self.loss_module = importlib.import_module(f"focoos_tpu_torch.models.{model.model_info.model_family.value}.loss")
        self.model = model
        self.args = args
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.run_dir = mesh.broadcast_object(
            _versioned_run_dir(args.output_dir, args.run_name) if mesh.is_main_process() else None)
        self.model_info = model.model_info
        self.hub = hub
        self._hub_hook: Optional[hooks_mod.SyncToHubHook] = None  # rank 0's, where args.sync_to_hub
        self._train_module = model.module

    def _set_status(self, status: ModelStatus, failure_reason: Optional[str] = None) -> None:
        """Status persisted to model_info.json (reference: trainer/trainer.py:558-584)."""
        self.model_info.status = status
        if failure_reason:
            self.model_info.description = f"{self.model_info.description or ''} [FAILED: {failure_reason[:300]}]"
        if mesh.is_main_process():
            self.model_info.dump_json(self.run_dir)

    def train(self) -> Dict[str, Any]:
        args, model = self.args, self.model
        # Python's and numpy's global states, as JAX's trainer seeds them, each rank its own (its augmentations
        # where no worker maps); torch's from the seed alone
        seed_all_rng(args.seed + mesh.get_rank())
        torch.manual_seed(args.seed)
        self._set_status(ModelStatus.TRAINING_STARTING)
        module = model.module
        if mesh.is_initialized() and args.sharding == "fsdp":
            # FSDP turns the parameters into shards for good: it trains a copy, and the full module stays for
            # the rank-sharded validation (a sharded forward is a collective; the ranks' shares differ in
            # length). A rank thus holds the full parameters twice during a step (sharding.py)
            clear_cast_caches(module)
            self._train_module = copy.deepcopy(module)
        train_module = self._train_module
        model.processor.train(True)
        # freeze_bn: every BatchNorm takes its running statistics in training
        # too (JAX's FREEZE_ALL_BN), and the solver leaves its parameters alone
        frozen = [m for m in train_module.modules() if isinstance(m, (BatchNorm, MaskedBatchNorm1d)) and not m.frozen
                  ] if args.freeze_bn else []
        for m in frozen:
            m.frozen = True
        loss_fn = self.loss_module.make_loss_fn(train_module, model.config)
        if mesh.is_initialized():
            loss_fn = apply_sharding(_StepModule(train_module, loss_fn), train_module, args.sharding, model.device)
            logger.info(f"{args.sharding} over {mesh.get_world_size()} ranks, "
                        f"{args.batch_size // mesh.get_world_size()} images a rank a step")
        solver = Solver(train_module, args, freeze_prefixes=_freeze_prefixes(model))
        state = create_train_state(train_module, solver, ema_enabled=args.ema_enabled)
        ema_fn = ema_decay_schedule(args.ema_decay, args.ema_warmup) if args.ema_enabled else None
        step_fn = build_train_step(loss_fn, ema_fn)
        spc = max(1, int(args.steps_per_call))
        if spc > 1:
            step_fn = build_multi_train_step(step_fn, spc)
            logger.info(f"Multi-step dispatch: {spc} optimizer steps per host call")

        checkpointer = Checkpointer(state, args.ckpt_dir or os.path.join(self.run_dir, "ckpt"))
        start_iter, resume_extra = 0, {}
        if args.resume:
            loaded, ok = checkpointer.resume_or_load(None, resume=True)
            if ok:
                state, resume_extra = loaded
                start_iter = int(resume_extra.get("iteration", -1)) + 1
                logger.info(f"Resumed from iteration {start_iter}")
        # as the JAX trainer's, a resumed run's loader starts its seeded stream from the beginning
        loader = build_train_loader(
            self.train_dataset, model.processor, args.batch_size, num_workers=args.workers, seed=args.seed,
            max_instances=args.max_instances_per_image, pin_memory=model.device.type == "cuda",
            timeout=args.workers_timeout,
        )
        self.loop = loop = TrainerLoop(step_fn, state, loader, args.max_iters, model.device, start_iter=start_iter,
                                       gather_metric_period=args.gather_metric_period, steps_per_call=spc)
        self._register_hooks(loop, checkpointer, solver.schedule)
        if start_iter > 0 and isinstance(resume_extra.get("hooks"), dict):
            loop.load_hook_state_dict(resume_extra["hooks"])

        self._set_status(ModelStatus.TRAINING_RUNNING)
        try:
            loop.train()
        except Exception as e:
            self._set_status(ModelStatus.TRAINING_ERROR, failure_reason=str(e))
            self._sync_to_hub(loop.iter - 1)
            raise
        finally:
            loader.close()
            for m in frozen:
                m.frozen = False
            module.eval()
            model.processor.train(False)

        self._sync_weights()
        if state.ema_params is not None:  # the final weights are the EMA's
            ema = full(state.ema_params)
            with torch.no_grad():
                torch._foreach_copy_(list(module.parameters()), ema)
        weights_path = os.path.join(self.run_dir, ArtifactName.WEIGHTS.value)
        if mesh.is_main_process():
            model.save_weights(weights_path)
        self.model_info.weights_uri = weights_path
        self._set_status(ModelStatus.TRAINING_COMPLETED)
        metrics = self._final_metrics()
        self._sync_to_hub(loop.iter - 1)
        logger.info(f"Training complete. Artifacts in {self.run_dir}")
        return {"run_dir": self.run_dir, "metrics": metrics, "iterations": loop.iter}

    def _register_hooks(self, loop: TrainerLoop, checkpointer: Checkpointer, schedule) -> None:
        """(reference: trainer/trainer.py:472-556)"""
        args = self.args
        writers = []
        if mesh.is_main_process():  # the metrics are the ranks' mean already
            writers = [
                hooks_mod.CommonMetricPrinter(max_iter=args.max_iters),
                hooks_mod.JSONWriter(os.path.join(self.run_dir, ArtifactName.METRICS.value)),
            ]
            try:  # as JAX registers it: skipped where tensorboardX is missing
                writers.append(hooks_mod.TensorboardWriter(os.path.join(self.run_dir, "tb")))
                logger.info(f"TensorBoard events in {os.path.join(self.run_dir, 'tb')}")
            except ImportError:
                logger.info("tensorboardX is not installed: no TensorBoard events")
        periodic = PeriodicCheckpointerMixin(
            checkpointer, args.checkpointer_period, args.max_iters, args.checkpointer_max_to_keep
        )
        primary_metric = TASK_METRICS.get(self.model.task, "total_loss")
        hooks: List[hooks_mod.HookBase] = [
            hooks_mod.IterationTimer(),
            hooks_mod.LRSchedulerHook(schedule),
            hooks_mod.MemoryStatsHook(self.model.device, period=args.log_period),
        ]
        if self.val_dataset is not None and args.eval_period > 0:
            hooks.append(hooks_mod.EvalHook(args.eval_period, self._val))
            hooks.append(hooks_mod.BestCheckpointer(checkpointer, primary_metric))
            if args.early_stop:
                hooks.append(hooks_mod.EarlyStoppingHook(args.patience, primary_metric))
            hooks.append(hooks_mod.VisualizationHook(
                args.eval_period, lambda: self._render_val_samples(loop, args.samples)))
        hooks.append(hooks_mod.PeriodicCheckpointerHook(periodic))
        hooks.append(hooks_mod.PeriodicWriter(writers, period=args.log_period))
        if args.sync_to_hub and mesh.is_main_process():
            # (reference: trainer.py:549 SyncToHubHook; JAX trainer.py:461-470) network failures are swallowed
            # inside the hook, so training never dies on the uplink; rank 0 alone syncs
            try:
                from focoos_tpu_torch.hub.focoos_hub import FocoosHUB

                hub = self.hub if self.hub is not None else FocoosHUB()
                remote = hub.get_remote_model(self.model_info.focoos_model or self.model_info.name)
                self._hub_hook = hooks_mod.SyncToHubHook(remote, self.run_dir, period=max(args.log_period, 60))
                hooks.append(self._hub_hook)
            except Exception as e:
                logger.warning(f"sync_to_hub requested but hub unavailable: {e}")
        loop.register_hooks(hooks)

    def _val(self) -> Optional[Dict[str, float]]:
        """In-training validation (reference: trainer/trainer.py:441-470) on
        the live parameters, not the EMA, as JAX's ``_val`` swaps in
        ``state.params``. The next step puts the module back in train mode."""
        from focoos_tpu_torch.trainer.evaluation import evaluate_dataset

        self._sync_weights()
        self.model.module.eval()
        self.model.processor.train(False)
        try:
            return evaluate_dataset(self.model, self.val_dataset, batch_size=max(1, self.args.batch_size // 2))
        finally:
            clear_cast_caches(self.model.module)  # a second copy of every weight, stale after the next step
            self.model.processor.train(True)

    def _sync_weights(self) -> None:
        """Under FSDP: the trained copy's full weights into the model (every rank calls it)."""
        if self._train_module is not self.model.module:
            load_full_state_dict(self.model.module, full_state_dict(self._train_module))

    def _render_val_samples(self, loop: TrainerLoop, n: int) -> Optional[np.ndarray]:
        """Annotated-prediction mosaic over the first N val images
        (reference: hooks/visualization.py:39), written to
        ``run_dir/visualizations/`` and stored as an EventStorage image, by
        rank 0. Drawing needs cv2: without it training goes on and this warns."""
        if self.val_dataset is None or n <= 0:
            return None
        self._sync_weights()
        if not mesh.is_main_process():
            return None
        from focoos_tpu_torch.utils.vision import annotate_image

        self.model.module.eval()
        self.model.processor.train(False)
        try:
            tiles = []
            rs = self.model.im_size[0]
            for i in range(min(n, len(self.val_dataset))):
                img = self.val_dataset[i].image
                if img is None:
                    continue
                img = np.asarray(img)
                if img.shape[:2] != (rs, rs):
                    import cv2

                    img = cv2.resize(img, (rs, rs), interpolation=cv2.INTER_LINEAR)
                dets = self.model.infer(img, threshold=0.3)
                tiles.append(annotate_image(img, dets, task=self.model.task, classes=self.model.classes))
        except Exception as e:  # visualization must never kill training
            logger.warning(f"visualization render failed: {e}")
            return None
        finally:
            clear_cast_caches(self.model.module)
            self.model.processor.train(True)
        if not tiles:
            return None
        cols = int(math.ceil(math.sqrt(len(tiles))))
        rows = int(math.ceil(len(tiles) / cols))
        th = max(t.shape[0] for t in tiles)
        tw = max(t.shape[1] for t in tiles)
        mosaic = np.zeros((rows * th, cols * tw, 3), np.uint8)
        for k, t in enumerate(tiles):
            r, c = divmod(k, cols)
            mosaic[r * th : r * th + t.shape[0], c * tw : c * tw + t.shape[1]] = t
        vis_dir = os.path.join(self.run_dir, "visualizations")
        os.makedirs(vis_dir, exist_ok=True)
        try:
            import cv2

            cv2.imwrite(os.path.join(vis_dir, f"iter_{loop.iter:07d}.jpg"), mosaic[..., ::-1])
        except Exception:
            pass
        return mosaic

    def _sync_to_hub(self, iteration: int) -> None:
        """The run's final status (and metrics) to the hub, once it is set."""
        if self._hub_hook is not None:
            self._hub_hook.sync(iteration)

    def _final_metrics(self) -> Dict[str, float]:
        """The final weights on ``val_dataset``, also written to model_info.json
        (reference: trainer/trainer.py:360-416)."""
        if self.val_dataset is None:
            return {}
        from focoos_tpu_torch.trainer.evaluation import evaluate_dataset

        self.model.processor.train(False)
        results = evaluate_dataset(self.model, self.val_dataset, batch_size=max(1, self.args.batch_size // 2))
        self.model_info.val_metrics = hooks_mod._flatten_metrics(results) if results else None
        if mesh.is_main_process():
            self.model_info.dump_json(self.run_dir)
        return results or {}


def run_train(model, args: TrainerArgs, train_dataset, val_dataset=None, hub=None) -> Dict[str, Any]:
    """Entry point (reference: trainer/trainer.py:921)."""
    return FocoosTrainer(model, args, train_dataset, val_dataset, hub=hub).train()


def run_eval(model, args: TrainerArgs, val_dataset) -> Dict[str, Any]:
    """Standalone evaluation (reference: trainer/trainer.py:956, FocoosTrainer.eval :226)."""
    from focoos_tpu_torch.trainer.evaluation import evaluate_dataset

    model.module.eval()
    model.processor.train(False)
    return evaluate_dataset(model, val_dataset, batch_size=args.batch_size) or {}
