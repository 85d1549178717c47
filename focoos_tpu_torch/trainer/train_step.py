"""One training step (port of focoos_tpu/trainer/train_step.py; reference:
focoos/trainer/trainer.py:723-773 run_step).

forward in train mode → criterion → backward → clip → AdamW update → EMA.
PyTorch runs it eagerly, so the step is a Python function over a
``TrainState`` that owns the module, the solver and the EMA copy. The module
computes in its compute dtype; its parameters, their gradients (autograd
through the casts), the AdamW state and the EMA are fp32. The metrics
stay on the device as one stacked fp32 tensor (JAX's ``_pack_metrics``), so a
step does not wait on a dozen scalar copies. ``build_multi_train_step`` runs
K steps per host call and averages their metrics on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from focoos_tpu_torch.trainer.solver import Solver


@dataclass
class TrainState:
    """The module (params and batch statistics, updated in place), its solver,
    the 0-based step, and the EMA of the params (not of the batch statistics)."""

    module: nn.Module
    solver: Solver
    step: int = 0
    ema_params: Optional[List[torch.Tensor]] = None

    def state_dict(self) -> dict:
        """What a training checkpoint holds: the parameters and buffers
        (BatchNorm statistics), the optimizer's state, the EMA and the step."""
        return {"module": self.module.state_dict(), "optimizer": self.solver.optimizer.state_dict(),
                "ema": self.ema_params, "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s output in place, onto the tensors' own devices."""
        self.module.load_state_dict(state["module"], strict=True)
        self.solver.optimizer.load_state_dict(state["optimizer"])
        if (state["ema"] is None) != (self.ema_params is None):
            raise ValueError("the checkpoint and this run disagree on whether the EMA is enabled")
        if self.ema_params is not None:
            with torch.no_grad():
                for e, saved in zip(self.ema_params, state["ema"], strict=True):
                    e.copy_(saved)
        self.step = int(state["step"])


def create_train_state(module: nn.Module, solver: Solver, ema_enabled: bool = False) -> TrainState:
    ema = [p.detach().clone() for p in module.parameters()] if ema_enabled else None
    return TrainState(module=module, solver=solver, ema_params=ema)


def build_train_step(
    loss_fn: Callable,  # (images, targets) -> (total, {key: 0-d tensor})
    ema_decay_fn: Optional[Callable[[int], float]] = None,
) -> Callable:
    """→ ``step_fn(state, images, targets) -> (keys, metrics [K] fp32 on the
    device)``; the metrics are the losses, ``total_loss`` and ``grad_norm``
    (the global norm of the unclipped gradients), in sorted key order."""

    def step_fn(state: TrainState, images: torch.Tensor, targets) -> Tuple[Tuple[str, ...], torch.Tensor]:
        module = state.module
        module.train()
        for p in module.parameters():
            p.grad = None
        total, metrics = loss_fn(images, targets)
        total.backward()
        grad_norm = state.solver.step(state.step)
        if state.ema_params is not None and ema_decay_fn is not None:
            d = ema_decay_fn(state.step)  # from the pre-increment step
            params = [p.detach() for p in module.parameters()]
            torch._foreach_mul_(state.ema_params, d)
            torch._foreach_add_(state.ema_params, params, alpha=1.0 - d)
        state.step += 1
        metrics = dict(metrics, total_loss=total.detach(), grad_norm=grad_norm)
        keys = tuple(sorted(metrics))
        return keys, torch.stack([metrics[k].detach().float() for k in keys])

    return step_fn


def build_multi_train_step(step_fn: Callable, steps_per_call: int) -> Callable:
    """K optimizer steps per host call (JAX's ``build_multi_train_step``):
    ``multi_fn(state, batches)`` runs ``step_fn`` on each of the K
    ``(images, targets)`` pairs in turn, so the LR schedule and the EMA
    advance per inner step, and returns the mean of the K steps' metrics,
    still on the device. JAX stacks the K batches for a ``lax.scan``; eager
    PyTorch runs K ordinary steps, so batches of different shapes need no
    fallback."""

    def multi_fn(state: TrainState, batches) -> Tuple[Tuple[str, ...], torch.Tensor]:
        if len(batches) != steps_per_call:
            raise ValueError(f"{len(batches)} batches for steps_per_call={steps_per_call}")
        packed = [step_fn(state, images, targets) for images, targets in batches]
        keys = packed[0][0]
        return keys, torch.stack([m for _, m in packed]).mean(0)

    return multi_fn


def unpack_metrics(keys: Tuple[str, ...], packed: torch.Tensor) -> Dict[str, float]:
    """One device→host copy for every scalar of a step."""
    return dict(zip(keys, packed.cpu().tolist()))
