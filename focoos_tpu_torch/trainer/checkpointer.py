"""Training checkpoints (port of focoos_tpu/trainer/checkpointer.py; reference:
focoos/trainer/checkpointer.py).

The JAX package's API and names: ``save`` / ``load`` / ``resume_or_load`` /
``has_checkpoint`` / ``all_checkpoints``, checkpoints ``model_{iter:07d}``,
``model_final`` and ``model_best``, each a directory of the save dir, the
hooks' state beside it as ``<name>.extra.npz``, the ``last_checkpoint`` tag
naming the newest, and ``PeriodicCheckpointerMixin``'s ``max_to_keep`` GC that
spares the tagged one. The payload is torch's own file
(``<name>/state.pt``) in place of orbax's: ``TrainState.state_dict()``, that
is the parameters and buffers (BatchNorm statistics), the optimizer's state,
the EMA and the step.

In a process group every rank calls ``save`` (under FSDP the state is
gathered from the shards first, a collective), rank 0 alone writes, and the
ranks meet at a barrier before going on; every rank loads, each taking its
own layout (``TrainState.load_state_dict``).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from focoos_tpu_torch.parallel import mesh
from focoos_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

_LAST_CHECKPOINT_TAG = "last_checkpoint"
_STATE_FILE = "state.pt"


class Checkpointer:
    """Saves and restores a ``TrainState`` (``state_template``, restored in place) under ``save_dir``."""

    def __init__(self, state_template: Any, save_dir: str):
        self.save_dir = save_dir
        self._template = state_template
        os.makedirs(save_dir, exist_ok=True)

    def save(self, name: str, state: Any, **extra: Any) -> str:
        """Save ``state`` (a TrainState) and ``extra`` (hook states, the
        iteration) under ``name``; every rank calls it, rank 0 writes."""
        path = os.path.abspath(os.path.join(self.save_dir, name))
        payload = state.state_dict()
        if mesh.is_main_process():
            if os.path.exists(path):
                shutil.rmtree(path)
            os.makedirs(path)
            torch.save(payload, os.path.join(path, _STATE_FILE))
            if extra:
                np.savez(os.path.join(self.save_dir, f"{name}.extra.npz"), **_flatten_extra(extra))
            with open(os.path.join(self.save_dir, _LAST_CHECKPOINT_TAG), "w") as f:
                f.write(name)
            logger.info(f"Saved checkpoint to {path}")
        mesh.synchronize()
        return path

    def load(self, name_or_path: str) -> tuple:
        """→ (the template state, restored in place; the extras)."""
        path = name_or_path
        if not os.path.isabs(path):
            path = os.path.abspath(os.path.join(self.save_dir, path))
        self._template.load_state_dict(torch.load(os.path.join(path, _STATE_FILE), map_location="cpu", weights_only=True))
        extra_path = path + ".extra.npz"
        extra: Dict[str, Any] = {}
        if os.path.isfile(extra_path):
            # the extras are this module's own file: hook states pickled as 0-d object arrays
            with np.load(extra_path, allow_pickle=True) as data:
                extra = {k: data[k].item() if data[k].ndim == 0 else data[k] for k in data.files}
        logger.info(f"Loaded checkpoint from {path}")
        return self._template, extra

    def has_checkpoint(self) -> bool:
        return os.path.isfile(os.path.join(self.save_dir, _LAST_CHECKPOINT_TAG))

    def get_checkpoint_file(self) -> Optional[str]:
        tag = os.path.join(self.save_dir, _LAST_CHECKPOINT_TAG)
        if not os.path.isfile(tag):
            return None
        with open(tag) as f:
            return f.read().strip()

    def resume_or_load(self, path: Optional[str], resume: bool = True):
        """reference semantics (checkpointer.py:203): if resume and a last
        checkpoint exists, load it; else load nothing."""
        if resume and self.has_checkpoint():
            return self.load(self.get_checkpoint_file()), True
        return None, False

    def all_checkpoints(self) -> List[str]:
        return sorted(
            d for d in os.listdir(self.save_dir)
            if os.path.isdir(os.path.join(self.save_dir, d)) and d.startswith("model_")
        )


def _flatten_extra(extra: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v if isinstance(v, np.ndarray) else np.asarray(v) for k, v in extra.items()}


class PeriodicCheckpointerMixin:
    """max_to_keep GC (reference: checkpointer.py:284-361)."""

    def __init__(self, checkpointer: Checkpointer, period: int, max_iter: int, max_to_keep: int = 1):
        self.checkpointer = checkpointer
        self.period = period
        self.max_iter = max_iter
        self.max_to_keep = max_to_keep
        self._recent: List[str] = []

    def step(self, iteration: int, state: Any, stride: int = 1, **extra: Any) -> None:
        """Every rank calls it; rank 0 alone removes old checkpoints."""
        # fire when a multiple of ``period`` falls in (iteration, iteration + stride];
        # the name and the saved iteration are the last completed one, so that
        # resume (start_iter = saved + 1) replays no step
        last = iteration + stride - 1
        if self.period > 0 and (iteration + stride) // self.period > iteration // self.period:
            name = f"model_{last:07d}"
            self.checkpointer.save(name, state, iteration=last, **extra)
            self._recent.append(name)
            while len(self._recent) > self.max_to_keep:
                old = self._recent.pop(0)
                if not mesh.is_main_process():
                    continue
                path = os.path.join(self.checkpointer.save_dir, old)
                if os.path.isdir(path) and old != self.checkpointer.get_checkpoint_file():
                    shutil.rmtree(path, ignore_errors=True)
                    extra_f = path + ".extra.npz"
                    if os.path.isfile(extra_f):
                        os.remove(extra_f)
        if iteration + stride >= self.max_iter:
            self.checkpointer.save("model_final", state, iteration=last, **extra)
