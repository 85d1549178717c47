"""Checkpoints, resume and the checkpoint-driven hooks of the port's trainer,
on the CPU, against the JAX package's ``PeriodicCheckpointerMixin``,
``BestCheckpointer`` and ``EarlyStoppingHook``.

Tolerances: ``save`` → ``load`` is bit-equal (hook state included); a run
resumed from a checkpoint agrees with the straight run within 1e-6 relative
(× max|ref| of each tensor): on the CPU the two run the same kernels on the
same batch, so in practice they are equal.
"""

import copy
import functools
import os
import sys
import types

import numpy as np
import pytest
import torch
from torch import nn

from focoos_tpu.trainer import hooks as jax_hooks
from focoos_tpu.trainer.checkpointer import Checkpointer as JaxCheckpointer
from focoos_tpu.trainer.checkpointer import PeriodicCheckpointerMixin as JaxPeriodic
from focoos_tpu.trainer.events import EventStorage as JaxEventStorage
from focoos_tpu_torch import ModelManager
from focoos_tpu_torch.nn.layers.common import BatchNorm
from focoos_tpu_torch.ports import DatasetEntry, TrainerArgs
from focoos_tpu_torch.structures import Boxes, Instances
from focoos_tpu_torch.trainer import hooks
from focoos_tpu_torch.trainer.checkpointer import Checkpointer, PeriodicCheckpointerMixin
from focoos_tpu_torch.trainer.events import EventStorage
from focoos_tpu_torch.trainer.solver import Solver
from focoos_tpu_torch.trainer.train_step import create_train_state
from focoos_tpu_torch.trainer.trainer import FocoosTrainer

SIZE = 64
RESUME_RTOL = 1e-6


@pytest.fixture
def few_threads():
    """Two intra-op threads for a test: under pytest-xdist several workers
    share the CPU's cores, and torch's default of one thread per core in each
    of them oversubscribes it (a training test then runs ~50x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def few_threads_module():
    """``few_threads`` for a whole module, its module-scoped fixtures (model
    builds, references) included: a test file that imports it runs on two
    intra-op threads throughout."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("few_threads")
# fai-detr on ResNet-18 with a 64-wide encoder and decoder: each checkpoint ~0.2 GB
MINI = dict(image_size=SIZE, num_queries=10, transformer_predictor_dec_layers=1, num_classes=5,
            pixel_decoder_feat_dim=64, pixel_decoder_out_dim=64, pixel_decoder_dim_feedforward=128,
            transformer_predictor_hidden_dim=64, transformer_predictor_out_dim=64,
            transformer_predictor_dim_feedforward=128, head_out_dim=64,
            backbone_config={"model_type": "resnet", "depth": 18, "variant": "d", "freeze_norm": False})


@functools.lru_cache(maxsize=1)
def _built():
    return ModelManager.get("fai-detr-l-coco", device="cpu", **MINI)


def _tiny_model():
    """A fresh copy of one seeded model (a copy costs less than a second seeded init)."""
    return copy.deepcopy(_built())


def _one_entry():
    rng = np.random.default_rng(0)
    boxes = np.array([[4, 6, 30, 40], [20, 10, 60, 50]], np.float32)
    return [DatasetEntry(image=rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8), height=SIZE, width=SIZE,
                         instances=Instances((SIZE, SIZE), boxes=Boxes(boxes), classes=np.array([3, 1])))]


def _args(tmp, name, max_iters, **kw):
    kw = dict(dict(checkpointer_period=2, checkpointer_max_to_keep=1, log_period=1, workers_timeout=120), **kw)
    return TrainerArgs(run_name=name, output_dir=str(tmp), batch_size=1, max_iters=max_iters, ema_enabled=True,
                       ema_warmup=3, max_instances_per_image=4, learning_rate=1e-3, **kw)


def _tensors(state):
    """Every tensor a resume must restore: parameters and BatchNorm statistics,
    the optimizer's moments and step counts, the EMA."""
    out = {f"module/{k}": v for k, v in state.module.state_dict().items()}
    for i, s in state.solver.optimizer.state_dict()["state"].items():
        out.update({f"optimizer/{i}/{k}": torch.as_tensor(v) for k, v in s.items()})
    out.update({f"ema/{i}": e for i, e in enumerate(state.ema_params)})
    return out


def _payload(path):
    """A checkpoint's state.pt as {name: value}: module/…, optimizer/<i>/…, ema/<i>, step."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    out = {f"module/{k}": v for k, v in state["module"].items()}
    for i, s in state["optimizer"]["state"].items():
        out.update({f"optimizer/{i}/{k}": v for k, v in s.items()})
    out.update({f"ema/{i}": e for i, e in enumerate(state["ema"])})
    out["step"] = state["step"]
    return out


class _DirOnlyCheckpointer:
    """orbax's StandardCheckpointer reduced to the directory it writes (the
    JAX Checkpointer's names, extras and tag stay its own code)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def save(self, path, state):
        os.makedirs(path)


def _jax_periodic_names(tmp, period, max_iter, keep, monkeypatch):
    """The files JAX's PeriodicCheckpointerMixin and Checkpointer leave, driven by the loop's calls."""
    fake = types.SimpleNamespace(StandardCheckpointer=_DirOnlyCheckpointer)
    monkeypatch.setitem(sys.modules, "orbax", types.SimpleNamespace(checkpoint=fake))
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", fake)
    ckpt = JaxCheckpointer({"w": np.zeros(3, np.float32)}, str(tmp))
    periodic = JaxPeriodic(ckpt, period, max_iter, keep)
    for it in range(max_iter):
        periodic.step(it, {"w": np.full(3, it, np.float32)}, hooks={})
    return sorted(os.listdir(tmp))


def test_resume_is_exact_and_names_match_jax(tmp_path, monkeypatch):
    """One image, batch 1: 3 steps straight, against 2 steps then a second
    trainer with resume=True to 3. The resumed trainer starts at iteration 2
    from the checkpoint of iteration 1 and ends with the same parameters,
    BatchNorm statistics, optimizer moments, EMA and step. The checkpoint
    directory holds the files JAX's logic names (max_to_keep 1)."""
    straight = FocoosTrainer(_tiny_model(), _args(tmp_path, "straight", 3, checkpointer_period=10), _one_entry())
    straight.train()
    ckpt = str(tmp_path / "ckpt")
    first = FocoosTrainer(_tiny_model(), _args(tmp_path, "first", 2, checkpointer_period=1, ckpt_dir=ckpt),
                          _one_entry())
    first.train()
    assert sorted(os.listdir(ckpt)) == _jax_periodic_names(tmp_path / "jax2", 1, 2, 1, monkeypatch)
    resumed = FocoosTrainer(_tiny_model(), _args(tmp_path, "resumed", 3, ckpt_dir=ckpt, resume=True,
                                                 checkpointer_period=10), _one_entry())
    res = resumed.train()
    assert resumed.loop.start_iter == 2 and res["iterations"] == 3
    # the last step's whole state as each run saved it (before the EMA replaces the weights)
    ref, got = (_payload(os.path.join(d, "model_final", "state.pt"))
                for d in (os.path.join(straight.run_dir, "ckpt"), ckpt))
    assert sorted(got) == sorted(ref) and ref["step"] == got["step"] == 3
    for k, r in ref.items():
        r, g = torch.as_tensor(r).double(), torch.as_tensor(got[k]).double()
        assert torch.allclose(g, r, rtol=0, atol=RESUME_RTOL * float(r.abs().max())), k
    assert any("exp_avg_sq" in k for k in ref) and any(k.startswith("ema/") for k in ref)


@pytest.mark.parametrize("period,max_iter,keep", [(2, 5, 1), (3, 10, 2), (4, 4, 1)])
def test_periodic_checkpoint_names_match_jax(tmp_path, monkeypatch, period, max_iter, keep):
    module = nn.Sequential(nn.Conv2d(3, 4, 3), BatchNorm(4))
    state = create_train_state(module, Solver(module, TrainerArgs(run_name="x", max_iters=max_iter)), ema_enabled=True)
    periodic = PeriodicCheckpointerMixin(Checkpointer(state, str(tmp_path / "port")), period, max_iter, keep)
    for it in range(max_iter):
        periodic.step(it, state, hooks={})
    assert sorted(os.listdir(tmp_path / "port")) == _jax_periodic_names(tmp_path / "jax", period, max_iter, keep, monkeypatch)


@pytest.mark.parametrize("optimizer", ["ADAMW", "SGD", "RMSPROP"])
def test_save_load_is_bit_equal(tmp_path, optimizer):
    """A state after two updates (BatchNorm statistics moved, the optimizer's
    state and the EMA filled) and the hooks' state round-trip exactly; the
    loaded state is the template's own tensors."""
    module = nn.Sequential(nn.Conv2d(3, 8, 3), BatchNorm(8), nn.Conv2d(8, 4, 1))
    args = TrainerArgs(run_name="x", optimizer=optimizer, ema_enabled=True)
    state = create_train_state(module, Solver(module, args), ema_enabled=True)
    for _ in range(2):
        module(torch.randn(2, 3, 9, 9, generator=torch.Generator().manual_seed(state.step))).square().mean().backward()
        state.solver.step(state.step)
        torch._foreach_lerp_(state.ema_params, [p.detach() for p in module.parameters()], 0.1)
        state.step += 1
    before = {k: v.clone() for k, v in _tensors(state).items()}
    hook_state = {"BestCheckpointer": {"best_value": 41.25, "best_iter": 3},
                  "EarlyStoppingHook": {"best": 41.25, "since_best": 2}}
    ckpt = Checkpointer(state, str(tmp_path / "c"))
    ckpt.save("model_0000001", state, iteration=1, hooks=hook_state)
    with torch.no_grad():  # move everything away from the saved values
        for p in state.module.parameters():
            p.add_(1.0)
        for e in state.ema_params:
            e.zero_()
    state.solver.optimizer.state.clear()
    state.step = 0
    loaded, extra = ckpt.load(ckpt.get_checkpoint_file())
    assert loaded is state and state.step == 2
    assert extra["iteration"] == 1 and extra["hooks"] == hook_state
    after = _tensors(state)
    assert sorted(after) == sorted(before)
    for k, v in before.items():
        assert torch.equal(after[k], v), k


class _Loop:
    """What a hook reads of its loop: ``iter``, ``max_iter``, ``state``."""

    def __init__(self, max_iter):
        self.iter, self.max_iter, self.state, self.steps_per_call = 0, max_iter, None, 1


class _Saves:
    def __init__(self):
        self.saved = []

    def save(self, name, state, **extra):
        self.saved.append((name, extra["iteration"]))


def _drive(pkg, seq, patience):
    """Feed ``seq`` (one value per iteration, None = no evaluation) to a
    package's BestCheckpointer and EarlyStoppingHook → (saves, best iter,
    the iteration that stopped or None)."""
    mod, storage_cls = (jax_hooks, JaxEventStorage) if pkg == "jax" else (hooks, EventStorage)
    loop, saves = _Loop(len(seq)), _Saves()
    best = mod.BestCheckpointer(saves, "bbox/AP")
    stop = mod.EarlyStoppingHook(patience, "bbox/AP")
    for h in (best, stop):
        h.trainer = loop
    with storage_cls(0) as storage:
        for it, v in enumerate(seq):
            loop.iter = storage.iter = it
            if v is not None:
                storage.put_scalar("bbox/AP", v, smoothing_hint=False)
            best.after_step()
            try:
                stop.after_step()
            except mod.EarlyStopException:
                return saves.saved, best.best_iter, it
    return saves.saved, best.best_iter, None


@pytest.mark.parametrize(
    "seq,patience",
    [([None, 10.0, None, 12.0, None, 11.0, None, 11.5, None, 9.0, None, 13.0], 3),
     ([5.0, 5.0, 5.0, 5.0, 6.0], 2),
     ([1.0, float("nan"), 2.0, float("inf"), 1.5, 0.5, 0.25], 2),
     ([3.0, 2.0, 1.0, 4.0, 3.5], 5)],
    ids=["periodic", "ties", "non-finite", "no-stop"],
)
def test_best_checkpointer_and_early_stopping_match_jax(seq, patience):
    ref = _drive("jax", seq, patience)
    got = _drive("port", seq, patience)
    assert got == ref
    assert ref[1] is not None


def test_trainer_stops_cleanly_on_early_stopping(tmp_path):
    """A validation metric that stops improving ends training through
    EarlyStopException, with the final weights written; with freeze_bn the
    BatchNorms' running statistics stay as they were and every BatchNorm is
    thawed again afterwards."""
    model = _tiny_model()
    stats = {k: v.clone() for k, v in model.module.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    args = _args(tmp_path, "stop", 6, eval_period=1, patience=2, freeze_bn=True, checkpointer_period=10, samples=0)
    trainer = FocoosTrainer(model, args, _one_entry(), _one_entry())
    trainer._val = lambda: {"bbox": {"AP": 5.0}}  # never improves after the first evaluation
    res = trainer.train()
    assert res["iterations"] == 2 and trainer.loop.iter == 2  # evaluations after steps 0, 1, 2: the third stops
    assert os.path.isfile(os.path.join(res["run_dir"], "model_final.npz"))
    assert all(torch.equal(model.module.state_dict()[k], v) for k, v in stats.items())
    assert not any(m.frozen for m in model.module.modules() if isinstance(m, BatchNorm))
