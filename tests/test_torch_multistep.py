"""Multi-step calls (``TrainerArgs.steps_per_call = K``) of the port against
the JAX package's ``build_multi_train_step`` and its loop, on the CPU in fp32,
on the tiny fai-detr of tests/test_torch_train.py (96², ResNet-18-D, 20
queries, 2 decoder layers, B=2).

JAX stacks K batches for a ``lax.scan``; the port runs K ordinary steps in
one call. Per call both advance the LR schedule and the EMA per inner step
and report the mean of the K steps' metrics. Tolerances: the losses and the
gradient norm, as tests/test_torch_train.py's one step (``LOSS_RTOL``,
``GRAD_NORM_RTOL``); the port's K=2 call against its own two K=1 steps is
bit-equal. The checkpoint and period arithmetic is pure Python: equal.

The JAX comparison trains with SGD. Adam's first step moves every parameter
by about ±lr whatever the size of its gradient, so a gradient within fp32
noise of 0 takes either sign in the two frameworks, and the second step's
losses then differ past ``LOSS_RTOL`` (loss_bbox's two-step mean 3.7e-4
relative with AdamW at lr 5e-4). AdamW's multi-step call is held bit-equal
to the port's own K=1 steps, whose single step tests/test_torch_train.py
holds to JAX's.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_checkpoint import few_threads  # noqa: F401 (a fixture)
from test_torch_fai_detr import SIZE, _flat, _perturb, _tiny_configs
from test_torch_train import (
    GRAD_NORM_RTOL,
    LOSS_RTOL,
    N_TARGETS,
    _dataset,
    _jax_targets,
    _port_targets,
    _targets,
    _trainer_args,
)

from focoos_tpu.models.fai_detr.loss import make_loss_fn as jax_make_loss_fn
from focoos_tpu.models.fai_detr.modelling import FAIDetr as JaxFAIDetr
from focoos_tpu.nn.backbone.resnet import ResNet as JaxResNet
from focoos_tpu.ports import TrainerArgs as JaxTrainerArgs
from focoos_tpu.trainer import hooks as jax_hooks
from focoos_tpu.trainer.checkpointer import PeriodicCheckpointerMixin as JaxPeriodic
from focoos_tpu.trainer.solver import build_optimizer
from focoos_tpu.trainer.solver import ema_decay_schedule as jax_ema_decay_schedule
from focoos_tpu.trainer.train_step import build_multi_train_step as jax_build_multi_train_step
from focoos_tpu.trainer.train_step import create_train_state as jax_create_train_state
from focoos_tpu.trainer.trainer import TrainerLoop as JaxTrainerLoop
from focoos_tpu.utils.checkpoint import unflatten_tree
from focoos_tpu.utils.torch_convert import convert_state_dict
from focoos_tpu_torch import ModelManager
from focoos_tpu_torch.models.fai_detr.loss import make_loss_fn
from focoos_tpu_torch.models.fai_detr.modelling import FAIDetr
from focoos_tpu_torch.nn.backbone.resnet import ResNet
from focoos_tpu_torch.ports import TrainerArgs
from focoos_tpu_torch.trainer import hooks
from focoos_tpu_torch.trainer.checkpointer import PeriodicCheckpointerMixin
from focoos_tpu_torch.trainer.solver import Solver, ema_decay_schedule
from focoos_tpu_torch.trainer.train_step import build_multi_train_step, build_train_step, create_train_state
from focoos_tpu_torch.trainer.trainer import FocoosTrainer, TrainerLoop
from focoos_tpu_torch.utils.weights import from_jax_variables

pytestmark = pytest.mark.usefixtures("few_threads")
K = 2


@pytest.fixture(scope="module")
def two_batches():
    """The port's seeded init as JAX variables (perturbed), and two batches."""
    _, pcfg = _tiny_configs()
    port = FAIDetr(pcfg, ResNet(pcfg.backbone_config))
    port.init_weights(torch.Generator().manual_seed(0))
    tree, _ = convert_state_dict({k: v.numpy() for k, v in port.state_dict().items()}, "fai_detr", verbose=False)
    flat = _perturb(_flat(tree), seed=0)
    batches = [(np.random.default_rng(10 + i).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8), _targets(20 + i))
               for i in range(K)]
    return flat, batches


def _sgd(cls):
    return dataclasses.replace(_trainer_args(cls), optimizer="SGD", optimizer_extra={"momentum": 0.9})


def _port_loop(flat, batches, steps_per_call, max_iter, args=None):
    """The port's TrainerLoop over ``batches`` (AdamW unless ``args``) → (the
    loop after train(), its module, its state)."""
    _, pcfg = _tiny_configs()
    module = FAIDetr(pcfg, ResNet(pcfg.backbone_config))
    module.load_state_dict(from_jax_variables(flat, "fai_detr"), strict=True)
    args = args or _trainer_args()
    state = create_train_state(module, Solver(module, args), ema_enabled=True)
    step = build_train_step(make_loss_fn(module, pcfg), ema_decay_schedule(args.ema_decay, args.ema_warmup))
    if steps_per_call > 1:
        step = build_multi_train_step(step, steps_per_call)
    data = [(torch.from_numpy(im), _port_targets(*t)) for im, t in batches]
    loop = TrainerLoop(step, state, iter(data), max_iter, torch.device("cpu"), steps_per_call=steps_per_call)
    loop.train()
    return loop, module, state


def _scalars(loop) -> dict:
    """{iteration: {metric: value}} of the loop's storage, ``time`` and ``data_time`` left out."""
    out = {}
    for name, buf in loop.storage.histories().items():
        if name not in ("data_time", "time"):
            for v, it in buf.values():
                out.setdefault(int(it), {})[name] = v
    return out


def test_multi_step_call_matches_jax(two_batches):
    """One K=2 call on both sides (SGD with momentum, warm-up and EMA): the
    mean of the two steps' losses and gradient norms; the port's call runs 2
    optimizer steps and iter is 2."""
    flat, batches = two_batches
    jcfg, _ = _tiny_configs()
    jmodel = JaxFAIDetr(config=jcfg, backbone=JaxResNet(config=jcfg.backbone_config))
    jvars = unflatten_tree(flat)
    args = _sgd(JaxTrainerArgs)
    tx, _ = build_optimizer(jvars["params"], args)
    state = jax_create_train_state(dict(jvars), tx, ema_enabled=True)
    multi = jax_build_multi_train_step(jax_make_loss_fn(jmodel, jcfg), tx, K,
                                       ema_decay_fn=jax_ema_decay_schedule(args.ema_decay, args.ema_warmup),
                                       donate=False)
    stacked = (jnp.stack([jnp.asarray(im) for im, _ in batches]),
               jax.tree.map(lambda *xs: jnp.stack(xs), *[_jax_targets(*t) for _, t in batches]))
    jstate, jmetrics = multi(state, stacked, jax.random.PRNGKey(0))
    ref = {k: float(v) for k, v in jmetrics.items()}
    assert int(jstate.step) == K

    loop, _, pstate = _port_loop(flat, batches, K, max_iter=K, args=_sgd(TrainerArgs))
    got = _scalars(loop)
    assert list(got) == [0] and pstate.step == K and loop.iter == K
    assert sorted(got[0]) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[0][k], v, rtol=GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL, err_msg=k)


def test_multi_step_call_equals_two_single_steps(two_batches):
    """The port's K=2 call against its own K=1 loop over the same two batches:
    parameters, buffers and EMA bit-equal; the call's metrics are the fp32
    mean of the two steps'."""
    flat, batches = two_batches
    loop2, module2, state2 = _port_loop(flat, batches, K, max_iter=K)
    loop1, module1, state1 = _port_loop(flat, batches, 1, max_iter=K)
    assert state1.step == state2.step == K
    sd1, sd2 = module1.state_dict(), module2.state_dict()
    for k, v in sd1.items():
        assert torch.equal(sd2[k], v), k
    for e1, e2 in zip(state1.ema_params, state2.ema_params, strict=True):
        assert torch.equal(e1, e2)
    one, two = _scalars(loop1), _scalars(loop2)
    assert list(one) == [0, 1] and list(two) == [0]
    for k, v in two[0].items():
        mean = (np.float32(one[0][k]) + np.float32(one[1][k])) / np.float32(2)
        assert np.float32(v) == mean, (k, v, mean)


class _Stub:
    """A loop's step counter: the step function both loops call."""

    def __init__(self):
        self.steps = 0


def test_max_iter_not_a_multiple_of_k_overshoots_as_jax():
    """max_iter=3 at K=2: JAX's loop runs two calls, 4 optimizer steps, and
    ends with iter clamped to 3 (focoos_tpu/trainer/trainer.py:99-108, ROADMAP
    Queue 3); the port mirrors it."""
    jstub, pstub = _Stub(), _Stub()

    def jax_step(state, batch, rng):
        jstub.steps += batch.shape[0]  # the stacked [K, ...] batch: K steps in one call
        return state, {"total_loss": jnp.float32(1.0)}

    jloop = JaxTrainerLoop(jax_step, None, iter([jnp.zeros(2)] * 8), max_iter=3, steps_per_call=K)
    jloop.train()

    def port_step(state, batches):
        pstub.steps += len(batches)
        return ("total_loss",), torch.ones(1)

    ploop = TrainerLoop(port_step, None, iter([(torch.zeros(2), torch.zeros(2))] * 8), 3, torch.device("cpu"),
                        steps_per_call=K)
    ploop.train()
    assert jstub.steps == pstub.steps == 4
    assert jloop.iter == ploop.iter == 3


class _Saves:
    def __init__(self):
        self.saved, self.save_dir = [], "/nonexistent"

    def save(self, name, state, **extra):
        self.saved.append((name, int(extra["iteration"])))

    def get_checkpoint_file(self):
        return self.saved[-1][0] if self.saved else None


class _Loop:
    def __init__(self, max_iter):
        self.iter, self.max_iter, self.state, self.steps_per_call = 0, max_iter, None, K

    def hook_state_dict(self):
        return {}


@pytest.mark.parametrize("max_iter", [6, 7, 8])
def test_checkpoints_and_periods_match_jax_at_k2(max_iter):
    """Period 3 at K=2: the calls on which ``_period_hit`` and
    ``_is_final_call`` fire, and the checkpoints saved (named by the last
    completed iteration), equal the JAX package's."""
    out = {}
    for name, mod, periodic in (("jax", jax_hooks, JaxPeriodic), ("port", hooks, PeriodicCheckpointerMixin)):
        loop, saves = _Loop(max_iter), _Saves()
        hook = mod.PeriodicCheckpointerHook(periodic(saves, 3, max_iter, max_to_keep=10))
        hook.trainer = loop
        fired = []
        while loop.iter < max_iter:
            fired.append((loop.iter, mod._period_hit(loop, 3), mod._is_final_call(loop)))
            hook.after_step()
            loop.iter += K
        out[name] = (fired, saves.saved)
    assert out["port"] == out["jax"]
    assert ("model_0000003", 3) in out["port"][1] and ("model_0000005", 5) in out["port"][1]


def test_focoos_model_trains_two_steps_a_call_and_resumes(tmp_path):
    """FocoosModel.train with steps_per_call=2, checkpointer_period=3 and
    max_iters=4: two calls, model_0000003 and model_final at iteration 3; a
    resume to 6 starts at iteration 4 and takes one call."""
    model = ModelManager.get(
        "fai-detr-l-coco", device="cpu", image_size=SIZE, num_queries=10, transformer_predictor_dec_layers=1,
        backbone_config={"model_type": "resnet", "depth": 18, "variant": "d", "freeze_norm": False},
    )
    ckpt = str(tmp_path / "ckpt")

    def args(iters, **kw):
        return TrainerArgs(run_name="k2", output_dir=str(tmp_path), batch_size=2, max_iters=iters, steps_per_call=K,
                           checkpointer_period=3, log_period=1, workers=0, ckpt_dir=ckpt,
                           max_instances_per_image=N_TARGETS, **kw)

    res = model.train(args(4), _dataset(4))
    assert res["iterations"] == 4
    assert {"model_0000003", "model_final"} <= set(os.listdir(ckpt))
    trainer = FocoosTrainer(model, args(6, resume=True), _dataset(4))
    res = trainer.train()
    assert trainer.loop.start_iter == 4 and res["iterations"] == 6
    assert trainer.loop.state.step == 6
    assert sorted(trainer.loop.storage.history("total_loss").values(), key=lambda v: v[1])[-1][1] == 4
