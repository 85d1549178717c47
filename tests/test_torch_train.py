"""Port parity for the fai-detr training step: the port (focoos_tpu_torch) and
the JAX package run the same numpy weights, images and targets on the CPU, in
fp32, at the tiny config of tests/test_torch_fai_detr.py (96², ResNet-18-D,
20 queries, 2 decoder layers, B=2, up to 5 targets per image).

Tolerances, each stated where it is used: values that pass through the whole
model (losses, gradients, updated statistics) differ by the order of fp32
sums in two frameworks; the optimizer on identical gradients agrees to 1e-6;
after one AdamW step a parameter may differ by up to 2·lr·mult, because
Adam's first step moves each parameter by about ±lr·mult whatever the size
of its gradient, so a gradient near 0 may take either sign.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_checkpoint import few_threads  # noqa: F401 (a fixture)
from test_torch_fai_detr import NUM_CLASSES, SIZE, _flat, _perturb, _tiny_configs

from focoos_tpu.data.loaders import TrainingSampler as JaxTrainingSampler
from focoos_tpu.models.fai_detr.loss import detr_criterion as jax_detr_criterion
from focoos_tpu.models.fai_detr.loss import make_loss_fn as jax_make_loss_fn
from focoos_tpu.models.fai_detr.modelling import FAIDetr as JaxFAIDetr
from focoos_tpu.models.fai_detr.ports import DETRAuxOutputs as JaxAux
from focoos_tpu.models.fai_detr.ports import DETRTargets as JaxTargets
from focoos_tpu.models.fai_detr.processor import DETRProcessor as JaxDETRProcessor
from focoos_tpu.nn.backbone.resnet import ResNet as JaxResNet
from focoos_tpu.nn.backbone.resnet import ResnetConfig as JaxResnetConfig
from focoos_tpu.nn.layers.common import BatchNorm as JaxBatchNorm
from focoos_tpu.ops.matching import batched_auction_assign as jax_auction
from focoos_tpu.ports import DatasetEntry as JaxDatasetEntry
from focoos_tpu.ports import TrainerArgs as JaxTrainerArgs
from focoos_tpu.structures import Boxes as JaxBoxes
from focoos_tpu.structures import Instances as JaxInstances
from focoos_tpu.trainer.solver import build_optimizer, leaf_hyperparams
from focoos_tpu.trainer.solver import build_schedule as jax_build_schedule
from focoos_tpu.trainer.solver import ema_decay_schedule as jax_ema_decay_schedule
from focoos_tpu.utils.checkpoint import unflatten_tree
from focoos_tpu.utils.torch_convert import convert_state_dict
from focoos_tpu_torch import ModelManager
from focoos_tpu_torch.data.loaders import TrainingSampler, build_train_loader
from focoos_tpu_torch.models.fai_detr.loss import detr_criterion, make_loss_fn
from focoos_tpu_torch.models.fai_detr.modelling import FAIDetr
from focoos_tpu_torch.models.fai_detr.ports import DETRAuxOutputs, DETRTargets
from focoos_tpu_torch.models.fai_detr.processor import DETRProcessor
from focoos_tpu_torch.nn.backbone.resnet import ResNet, ResnetConfig
from focoos_tpu_torch.nn.layers.common import BatchNorm
from focoos_tpu_torch.ops.matching import batched_auction_assign
from focoos_tpu_torch.ports import DatasetEntry, TrainerArgs
from focoos_tpu_torch.structures import Boxes, Instances
from focoos_tpu_torch.trainer.solver import Solver, build_schedule, ema_decay_schedule, param_hyperparams
from focoos_tpu_torch.trainer.train_step import build_train_step, create_train_state as torch_train_state
from focoos_tpu_torch.utils.weights import from_jax_variables, to_jax_variables

N_TARGETS = 5
# Gradients of the train-mode model, fp32 on both sides, per tensor:
# ||port - JAX|| <= GRAD_TOL ||JAX|| + 1e-6 sqrt(size). A ReLU unit whose
# pre-activation lies within fp32 noise of 0 switches between the frameworks,
# and train-mode BatchNorms over B·H·W = 18 values (res5 at 96²) amplify such
# differences: measured <= 2.3e-2. A decoder without JAX's gradient stops
# gives > 1 (measured 2.5). The floor covers tensors whose gradient is 0 in
# exact arithmetic (a key bias under softmax; a BatchNorm bias before a norm).
GRAD_TOL = 5e-2
LOSS_RTOL = 1e-4  # every loss, relative: the forward agrees to ~1e-5
GRAD_NORM_RTOL = 1e-3  # the global norm of the gradients, relative


def _targets(seed, b=2, n=N_TARGETS):
    """Padded targets: image i has n - 2 + i valid boxes (3 and 4 of 5 at b=2)."""
    rng = np.random.default_rng(seed)
    cxcy = rng.uniform(0.25, 0.75, (b, n, 2))
    wh = rng.uniform(0.1, 0.4, (b, n, 2))
    valid = np.arange(n)[None, :] < (n - 2 + np.arange(b))[:, None]
    labels = rng.integers(0, NUM_CLASSES, (b, n)) * valid
    boxes = (np.concatenate([cxcy, wh], -1) * valid[..., None]).astype(np.float32)
    return labels.astype(np.int64), boxes, valid


def _jax_targets(labels, boxes, valid):
    return JaxTargets(labels=jnp.asarray(labels, jnp.int32), boxes=jnp.asarray(boxes), valid=jnp.asarray(valid))


def _port_targets(labels, boxes, valid):
    return DETRTargets(torch.from_numpy(labels), torch.from_numpy(boxes), torch.from_numpy(valid))


def _trainer_args(cls=TrainerArgs):
    """The same arguments as the port's TrainerArgs, or the JAX package's (``cls``)."""
    return cls(run_name="tiny", learning_rate=5e-4, weight_decay=0.02, weight_decay_norm=0.01,
                       clip_gradients=0.1, backbone_multiplier=0.1, scheduler="MULTISTEP",
                       scheduler_extra={"warmup_iters": 1, "warmup_factor": 0.5}, ema_enabled=True, ema_decay=0.999,
                       ema_warmup=20, max_iters=100)


def _assert_grads_close(got: dict, ref: dict):
    assert sorted(got) == sorted(ref), "grads: keys differ"
    for k, r in ref.items():
        err, scale = np.linalg.norm(got[k] - r), np.linalg.norm(r)
        assert err <= GRAD_TOL * scale + 1e-6 * np.sqrt(r.size), f"grad {k}: ||port - JAX|| {err:.3e}, ||JAX|| {scale:.3e}"


def _assert_tree_close(got: dict, ref: dict, tol: float, what: str, floor: float = 0.0):
    """Per key: |got - ref| <= tol x max|ref| + floor."""
    assert sorted(got) == sorted(ref), f"{what}: keys differ"
    for k in ref:
        g, r = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        assert g.shape == r.shape, f"{what} {k}: shape {g.shape} vs {r.shape}"
        np.testing.assert_allclose(g, r, rtol=0, atol=tol * np.abs(r).max() + floor, err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def tiny():
    """JAX module + perturbed weights (numpy), targets and images; the JAX
    step's grads, losses, updated batch stats and post-step state."""
    jcfg, pcfg = _tiny_configs()
    jmodel = JaxFAIDetr(config=jcfg, backbone=JaxResNet(config=jcfg.backbone_config))
    # the JAX tree's structure by tracing alone; the values are the port's
    # seeded init carried over by torch_convert (a JAX init would cost a compile)
    abstract = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    shapes = {"/".join(str(k.key) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_leaves_with_path(abstract)}
    port = FAIDetr(pcfg, ResNet(pcfg.backbone_config))
    port.init_weights(torch.Generator().manual_seed(0))
    tree, _ = convert_state_dict({k: v.numpy() for k, v in port.state_dict().items()}, "fai_detr", verbose=False)
    flat = _perturb(_flat(tree), seed=0)
    assert {k: v.shape for k, v in flat.items()} == shapes
    images = np.random.default_rng(1).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    tgt = _targets(2)
    jvars = unflatten_tree(flat)
    batch = (jnp.asarray(images), _jax_targets(*tgt))
    loss_fn = jax_make_loss_fn(jmodel, jcfg)
    rng = jax.random.PRNGKey(0)

    def total_fn(params):
        return loss_fn({"params": params, "batch_stats": jvars["batch_stats"]}, batch, rng)

    (total, (losses, new_model_state)), grads = jax.jit(jax.value_and_grad(total_fn, has_aux=True))(jvars["params"])
    # the rest of the step as focoos_tpu/trainer/train_step.py:_make_step_body
    # composes it (one compile of the model, not two): the optax chain of
    # build_optimizer, apply_updates, the EMA with the decay of step 0
    args = _trainer_args(JaxTrainerArgs)
    tx, _ = build_optimizer(jvars["params"], args)
    update = jax.jit(tx.update)
    updates, _ = update(grads, tx.init(jvars["params"]), jvars["params"])
    params_after = optax.apply_updates(jvars["params"], updates)
    d = float(jax_ema_decay_schedule(args.ema_decay, args.ema_warmup)(jnp.asarray(0)))
    ema_after = jax.tree.map(lambda e, p: e * d + p * (1.0 - d), jvars["params"], params_after)
    metrics = dict(losses, total_loss=total, grad_norm=jax.jit(optax.global_norm)(grads))
    return dict(
        jcfg=jcfg, pcfg=pcfg, flat=flat, shapes=shapes, images=images, targets=tgt, args=_trainer_args(),
        total=float(total), losses={k: float(v) for k, v in losses.items()},
        grads=_flat({"params": grads}), batch_stats=_flat({"batch_stats": new_model_state["batch_stats"]}),
        metrics={k: float(v) for k, v in metrics.items()},
        params_after=_flat({"params": params_after}), ema_after=_flat({"params": ema_after}),
        tx=tx, update=update,
    )


def _port_module(tiny):
    module = FAIDetr(tiny["pcfg"], ResNet(tiny["pcfg"].backbone_config))
    module.load_state_dict(from_jax_variables(tiny["flat"], "fai_detr"), strict=True)
    return module.train()


def _port_grads(module) -> dict:
    """The port's .grad of every parameter in JAX's flat layout (transposed,
    q/k/v split) through to_jax_variables; a parameter without a gradient is 0."""
    sd = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy() for n, p in module.named_parameters()}
    return to_jax_variables(sd, "fai_detr")


def _port_state(module, collection: str) -> dict:
    flat = to_jax_variables({k: v.detach().numpy() for k, v in module.state_dict().items()}, "fai_detr")
    return {k: v for k, v in flat.items() if k.startswith(collection + "/")}


# --------------------------------------------------------------------------- BatchNorm, ResNet
def test_batchnorm_train_step_matches_flax():
    """Two train-mode steps: outputs and running statistics. flax moves the
    running variance toward the biased batch variance; torch's own
    BatchNorm2d would take the unbiased one (~1/(n-1) more: 1/17 here)."""
    rng = np.random.default_rng(3)
    xs = [(rng.standard_normal((2, 3, 3, 4)) * 2 + 0.5).astype(np.float32) for _ in range(2)]
    jbn = JaxBatchNorm()
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), train=True)
    flat = _perturb(_flat(variables), seed=4)
    jvars = unflatten_tree(flat)
    port = BatchNorm(4)
    with torch.no_grad():
        for name, key in (("weight", "params/bn/scale"), ("bias", "params/bn/bias"),
                          ("running_mean", "batch_stats/bn/mean"), ("running_var", "batch_stats/bn/var")):
            getattr(port, name).copy_(torch.from_numpy(flat[key]))
    port.train()
    for x in xs:
        y, new = jbn.apply(jvars, jnp.asarray(x), train=True, mutable=["batch_stats"])
        jvars = {"params": jvars["params"], "batch_stats": new["batch_stats"]}
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(y), rtol=0, atol=1e-5)
        np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(new["batch_stats"]["bn"]["mean"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(port.running_var.numpy(), np.asarray(new["batch_stats"]["bn"]["var"]), rtol=1e-6)


def test_resnet_train_features_and_statistics_match_flax():
    """res2–res5 in train mode (batch statistics, the plain stem) and every
    updated running statistic, against flax apply(train=True, mutable=...)."""
    jcfg = JaxResnetConfig(depth=18, variant="d", freeze_norm=False, use_pretrained=False)
    jmodel = JaxResNet(config=jcfg)
    x = np.random.default_rng(18).standard_normal((2, 67, 75, 3)).astype(np.float32)
    flat = _perturb(_flat(jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(x[:1]))), seed=18)
    ref, new = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))(
        unflatten_tree(flat), jnp.asarray(x))
    port = ResNet(ResnetConfig(depth=18, variant="d", freeze_norm=False))
    port.load_state_dict(from_jax_variables(flat, "resnet"), strict=True)
    got = port.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in ("res2", "res3", "res4", "res5"):
        r = np.asarray(ref[k])
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).detach().numpy(), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=k)
    ref_stats = from_jax_variables(_flat({"batch_stats": new["batch_stats"]}), "resnet")
    got_stats = {k: v.numpy() for k, v in port.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    # a batch mean or variance is a sum over B·H·W values: 1e-5 of the largest
    _assert_tree_close(got_stats, {k: v.numpy() for k, v in ref_stats.items() if k in got_stats or "running" in k},
                       1e-5, "batch_stats", floor=1e-6)


# --------------------------------------------------------------------------- matching, criterion
@pytest.mark.parametrize("max_iters", [500, 3], ids=["converged", "capped-fill"])
def test_auction_matches_jax(max_iters):
    """Batched problems of DETR's shape with invalid rows (one problem all
    invalid); capped at 3 rounds, the unassigned rows take free columns."""
    rng = np.random.default_rng(max_iters)
    p, n, q = 6, 7, 20
    cost = rng.standard_normal((p, n, q)).astype(np.float32) * rng.uniform(0.1, 10.0, (p, 1, 1)).astype(np.float32)
    valid = rng.uniform(size=(p, n)) < 0.7
    valid[0] = False
    valid[1] = True
    ref = np.asarray(jax_auction(jnp.asarray(cost), jnp.asarray(valid), max_iters=max_iters))
    got = batched_auction_assign(torch.from_numpy(cost), torch.from_numpy(valid), max_iters=max_iters).numpy()
    np.testing.assert_array_equal(np.where(valid, got, -1), np.where(valid, ref, -1))
    for i in range(p):  # each valid row holds its own column
        cols = got[i][valid[i]]
        assert len(set(cols.tolist())) == len(cols) and ((cols >= 0) & (cols < q)).all()
    assert batched_auction_assign.rounds <= max_iters


def _random_aux(seed, layers=2, b=2, q=20):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((layers + 1, b, q, NUM_CLASSES)).astype(np.float32) * 2
    boxes = (1 / (1 + np.exp(-rng.standard_normal((layers + 1, b, q, 4)) * 1.5))).astype(np.float32)
    return logits, boxes


def test_detr_criterion_matches_jax():
    """Every loss key, and the gradient of the total with respect to every
    aux output (the matching cost and the VFL IoU target carry none)."""
    logits, boxes = _random_aux(5)
    labels, tboxes, valid = _targets(6)
    jcfg, pcfg = _tiny_configs()

    def jax_total(lg, bx):
        aux = JaxAux(dec_logits=lg[:-1], dec_boxes=bx[:-1], enc_logits=lg[-1], enc_boxes=bx[-1])
        losses = jax_detr_criterion(aux, _jax_targets(labels, tboxes, valid), jcfg)
        return losses["total"], losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True))(
        jnp.asarray(logits), jnp.asarray(boxes))
    lg, bx = torch.from_numpy(logits).requires_grad_(), torch.from_numpy(boxes).requires_grad_()
    losses = detr_criterion(DETRAuxOutputs(lg[:-1], bx[:-1], lg[-1], bx[-1]), _port_targets(labels, tboxes, valid), pcfg)
    losses["total"].backward()
    assert sorted(losses) == sorted(jlosses) and "loss_vfl_enc" in losses and "loss_giou_0" in losses
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k].detach()), float(jlosses[k]), rtol=1e-5, err_msg=k)
    for name, g, r in (("d logits", lg.grad, jgrads[0]), ("d boxes", bx.grad, jgrads[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5 * np.abs(np.asarray(r)).max(), err_msg=name)


# --------------------------------------------------------------------------- solver
def test_param_hyperparams_match_leaf_hyperparams(tiny):
    """lr multiplier and weight decay of every parameter: the port's policy on
    torch names, mapped leaf for leaf onto the JAX tree through
    torch_convert, equals leaf_hyperparams on the flax tree (non-default
    multipliers; with and without freeze_at=1)."""
    module = _port_module(tiny)
    names = [n for n, _ in module.named_parameters()]
    # which torch parameter each JAX leaf comes from: convert a state_dict of ids
    ids = {n: np.full(tuple(p.shape), i, np.float32) for i, (n, p) in enumerate(module.named_parameters())}
    source = {k: names[int(v.flat[0])] for k, v in
              _flat({"params": convert_state_dict(ids, "fai_detr", verbose=False)[0]["params"]}).items()}
    params = unflatten_tree(tiny["flat"])["params"]
    kw = dict(base_wd=0.02, wd_norm=0.01, wd_embed=0.03, backbone_multiplier=0.1, decoder_multiplier=0.5,
              head_multiplier=2.0)
    for freeze_paths, freeze_prefixes in (((), ()), (("backbone/conv1", "backbone/res2_"),
                                                     ("pixel_decoder.backbone.conv1.", "pixel_decoder.backbone.res_layers.0."))):
        lr_tree, wd_tree = leaf_hyperparams(params, freeze_paths=freeze_paths, **kw)
        hp = param_hyperparams(module, freeze_prefixes=freeze_prefixes, **kw)
        assert sorted(source) == sorted(_flat({"params": lr_tree}))
        for i, ref_tree in enumerate((lr_tree, wd_tree)):
            for k, ref in _flat({"params": ref_tree}).items():
                assert hp[source[k]][i] == pytest.approx(float(ref), rel=1e-6), (k, source[k], i)


@pytest.mark.parametrize(
    "name,extra",
    [("MULTISTEP", {"warmup_iters": 10, "warmup_factor": 0.1}), ("MULTISTEP", {"milestones": [0.5, 0.75]}),
     ("POLY", {"warmup_iters": 5, "power": 0.9}), ("COSINE", {}), ("FIXED", {"warmup_iters": 3, "warmup_factor": 0.5})],
)
def test_schedules_and_ema_ramp_match_jax(name, extra):
    ref = jax_build_schedule(name, 1e-3, 100, extra)
    got = build_schedule(name, 1e-3, 100, extra)
    for step in (0, 1, 2, 4, 9, 10, 49, 50, 51, 74, 75, 99):
        # rtol for fp32 in JAX; atol where a cosine ends near 0
        np.testing.assert_allclose(got(step), float(ref(jnp.asarray(step))), rtol=1e-6, atol=1e-10,
                                   err_msg=f"{name} step {step}")
    jema, ema = jax_ema_decay_schedule(0.999, 20), ema_decay_schedule(0.999, 20)
    for step in (0, 1, 19, 100):
        np.testing.assert_allclose(ema(step), float(jema(jnp.asarray(step))), rtol=1e-6)


def test_solver_update_matches_optax_chain(tiny):
    """Two updates on identical gradients (the first clipped, the second not)
    equal the JAX package's optax chain to 1e-6."""
    module = _port_module(tiny)
    solver = Solver(module, tiny["args"])
    params = unflatten_tree(tiny["flat"])["params"]
    opt_state, update = tiny["tx"].init(params), tiny["update"]
    rng = np.random.default_rng(9)
    for scale in (1e-2, 1e-5):  # global norm ≫ and ≪ clip_gradients=0.1
        grads = {n: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32) * scale)
                 for n, p in module.named_parameters()}
        jgrads = unflatten_tree({k: v for k, v in to_jax_variables({n: g.numpy() for n, g in grads.items()},
                                                                    "fai_detr").items()})["params"]
        updates, opt_state = update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for n, p in module.named_parameters():
            p.grad = grads[n].clone()
        norm = solver.step(int(solver.optimizer.state_dict()["state"].get(0, {}).get("step", 0)))
        ref_norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
        np.testing.assert_allclose(float(norm), ref_norm, rtol=1e-5)  # fp32 sums of ~3M squares
    got = _port_state(module, "params")
    _assert_tree_close(got, _flat({"params": params}), 0.0, "params after two updates", floor=1e-6)


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize(
    "optimizer,extra",
    [("SGD", {"momentum": 0.9}), ("SGD", {"momentum": 0.8, "nesterov": True}), ("RMSPROP", {"alpha": 0.95})],
    ids=["sgd", "sgd-nesterov", "rmsprop"],
)
def test_sgd_and_rmsprop_match_optax_chain(tiny, optimizer, extra):
    """Three updates on identical gradients (the first clipped) with the
    tiny args' lr multipliers, weight decay and warmup: the parameters equal
    build_optimizer's optax chain (clip, trace / scale_by_rms, + wd·p, ×
    mult, × -lr) to 1e-6 of each tensor's largest value. The first RMS
    update divides by sqrt(ν + 1e-8) with ν ~ 1e-12: torch.optim.RMSprop's
    sqrt(ν) + eps would move these parameters ~50x further."""
    args = _trainer_args()
    args.optimizer, args.optimizer_extra = optimizer, extra
    jargs = _trainer_args(JaxTrainerArgs)
    jargs.optimizer, jargs.optimizer_extra = optimizer, extra
    module = _port_module(tiny)
    solver = Solver(module, args)
    # the leaves of every 16th layer (backbone and encoder convs, BatchNorms, the
    # decoder's attention and a LayerNorm, a predictor conv) carry a gradient; the
    # others' are 0 on both sides, so the global norm is the same (fewer leaves: a
    # shorter compile)
    layers = sorted({k.rsplit("/", 1)[0] for k in tiny["flat"] if k.startswith("params/")})[::16]
    keys = sorted(k for k in tiny["flat"] if k.rsplit("/", 1)[0] in layers)
    params = unflatten_tree({k: tiny["flat"][k] for k in keys})["params"]
    tx, _ = build_optimizer(params, jargs)
    update = jax.jit(tx.update)
    opt_state = tx.init(params)
    rng = np.random.default_rng(10)
    for step, scale in enumerate((1e-2, 1e-5, 3e-6)):
        flat = {k: (rng.standard_normal(tiny["flat"][k].shape) * scale).astype(np.float32) for k in keys}
        updates, opt_state = update(unflatten_tree(flat)["params"], opt_state, params)
        params = optax.apply_updates(params, updates)
        grads = from_jax_variables({k: flat.get(k, np.zeros_like(v)) for k, v in tiny["flat"].items()}, "fai_detr")
        for n, p in module.named_parameters():
            p.grad = grads[n].clone()
        solver.step(step)
    got = {k: v for k, v in _port_state(module, "params").items() if k in keys}
    _assert_tree_close(got, _flat({"params": params}), 1e-6, f"{optimizer} params")


@pytest.mark.usefixtures("few_threads")
def test_freeze_bn_matches_jax(tiny):
    """freeze_bn: the lr multiplier and weight decay of every parameter equal
    leaf_hyperparams(freeze_bn=True)'s, which spare the twelve input
    projections' BatchNorm parameters (their JAX paths are not under /bn/;
    ROADMAP Queue 3); one step leaves every running statistic and every
    frozen parameter unchanged."""
    module = _port_module(tiny)
    names = [n for n, _ in module.named_parameters()]
    ids = {n: np.full(tuple(p.shape), i, np.float32) for i, (n, p) in enumerate(module.named_parameters())}
    source = {k: names[int(v.flat[0])] for k, v in
              _flat({"params": convert_state_dict(ids, "fai_detr", verbose=False)[0]["params"]}).items()}
    lr_tree, wd_tree = leaf_hyperparams(unflatten_tree(tiny["flat"])["params"], base_wd=0.02, freeze_bn=True)
    hp = param_hyperparams(module, 0.02, freeze_bn=True)
    for i, ref_tree in enumerate((lr_tree, wd_tree)):
        for k, ref in _flat({"params": ref_tree}).items():
            assert hp[source[k]][i] == pytest.approx(float(ref), rel=1e-6), (k, source[k], i)
    spared = [f"{mn}.{pn}" for mn, m in module.named_modules() if isinstance(m, BatchNorm) and "input_proj" in mn
              for pn, _ in m.named_parameters(recurse=False)]
    assert len(spared) == 12 and all(hp[n][0] > 0 for n in spared)
    frozen = [n for n, (m, _) in hp.items() if m == 0.0]
    assert len(frozen) > 50

    args = _trainer_args()
    args.freeze_bn = True
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.frozen = True
    before = {k: v.clone() for k, v in module.state_dict().items()}
    state = torch_train_state(module, Solver(module, args))
    build_train_step(make_loss_fn(module, tiny["pcfg"]))(
        state, torch.from_numpy(tiny["images"]), _port_targets(*tiny["targets"]))
    after = module.state_dict()
    for k, v in before.items():
        if k.endswith(("running_mean", "running_var")) or k in frozen:
            assert torch.equal(after[k], v), k
    assert not all(torch.equal(after[k], before[k]) for k in spared)


# --------------------------------------------------------------------------- the model and one step
def test_decoder_train_mode_grads_match_jax(tiny):
    """The gradient of the criterion through the train-mode model reaches the
    decoder, its heads and the encoder's query selection as JAX's does:
    stopped at the selected queries and first boxes and at each layer's
    refined boxes before they feed the next layer."""
    module = _port_module(tiny)
    total, _ = make_loss_fn(module, tiny["pcfg"])(torch.from_numpy(tiny["images"]), _port_targets(*tiny["targets"]))
    total.backward()
    got = {k: v for k, v in _port_grads(module).items() if k.startswith("params/predictor/")}
    ref = {k: v for k, v in tiny["grads"].items() if k.startswith("params/predictor/")}
    _assert_grads_close(got, ref)


def test_train_step_matches_jax(tiny):
    """One training step on both sides: losses, total_loss,
    grad_norm, every gradient, the params after the AdamW update, their EMA,
    and the BatchNorm statistics the forward moved."""
    module = _port_module(tiny)
    images, targets = torch.from_numpy(tiny["images"]), _port_targets(*tiny["targets"])
    total, losses = make_loss_fn(module, tiny["pcfg"])(images, targets)
    total.backward()
    _assert_grads_close(_port_grads(module), tiny["grads"])
    np.testing.assert_allclose(float(total), tiny["total"], rtol=LOSS_RTOL)

    module = _port_module(tiny)
    args = tiny["args"]
    state = torch_train_state(module, Solver(module, args), ema_enabled=True)
    step = build_train_step(make_loss_fn(module, tiny["pcfg"]), ema_decay_schedule(args.ema_decay, args.ema_warmup))
    keys, packed = step(state, images, targets)
    metrics = dict(zip(keys, packed.tolist()))
    assert sorted(metrics) == sorted(tiny["metrics"]) and state.step == 1
    for k, v in tiny["metrics"].items():
        np.testing.assert_allclose(metrics[k], v, rtol=GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL, err_msg=k)
    # Adam's first step: ±lr·mult per parameter, either sign where the gradient is ~0
    bound = 2 * args.learning_rate + 1e-6
    _assert_tree_close(_port_state(module, "params"), tiny["params_after"], 0.0, "params after", floor=bound)
    ema = to_jax_variables({n: e.numpy() for (n, _), e in zip(module.named_parameters(), state.ema_params)}, "fai_detr")
    _assert_tree_close(ema, tiny["ema_after"], 0.0, "ema after", floor=bound)
    _assert_tree_close(_port_state(module, "batch_stats"), tiny["batch_stats"], 1e-5, "batch_stats", floor=1e-6)


# --------------------------------------------------------------------------- data and the trainer
def _dataset(n, seed=0, jax_package=False):
    """n seeded entries, built from the port's DatasetEntry/Instances/Boxes or,
    with ``jax_package``, from the JAX package's (the same values)."""
    entry_cls, inst_cls, boxes_cls = (JaxDatasetEntry, JaxInstances, JaxBoxes) if jax_package else (
        DatasetEntry, Instances, Boxes)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, N_TARGETS + 3))  # some images have more boxes than max_instances
        xy = rng.uniform(0, SIZE * 0.7, (k, 2))
        boxes = np.concatenate([xy, np.minimum(xy + rng.uniform(8, SIZE * 0.3, (k, 2)), SIZE)], 1).astype(np.float32)
        inst = inst_cls((SIZE, SIZE), boxes=boxes_cls(boxes), classes=rng.integers(0, NUM_CLASSES, k))
        out.append(entry_cls(image=rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8), height=SIZE,
                                width=SIZE, instances=inst))
    return out


def test_loader_matches_jax_sampler_and_processor():
    """Same sampler stream as the JAX package's, and batches equal to its
    processor's preprocess_entries on the same entries."""
    ref = iter(JaxTrainingSampler(7, seed=3))
    got = iter(TrainingSampler(7, seed=3))
    order = [next(got) for _ in range(21)]
    assert order == [next(ref) for _ in range(21)]
    ds, jds = _dataset(7), _dataset(7, jax_package=True)
    jcfg, pcfg = _tiny_configs()
    jproc = JaxDETRProcessor(jcfg, SIZE).train(True)
    loader = build_train_loader(ds, DETRProcessor(pcfg, SIZE).train(True), 3, seed=3, max_instances=N_TARGETS)
    for i in range(2):
        images, targets = next(loader)
        jb, jt = jproc.preprocess_entries([jds[j] for j in order[3 * i: 3 * i + 3]], max_instances=N_TARGETS)
        np.testing.assert_array_equal(images.numpy(), jb)
        assert images.dtype == torch.uint8
        for f in ("labels", "boxes", "valid"):
            np.testing.assert_array_equal(getattr(targets, f).numpy(), np.asarray(getattr(jt, f)), err_msg=f)


def test_focoos_model_train_writes_jax_layout_weights(tiny, tmp_path):
    """FocoosModel.train for 2 iterations on the CPU: status and weights land in
    the run dir; model_final.npz has exactly the JAX tree's keys and shapes,
    and round-trips through from_jax_variables / to_jax_variables."""
    model = ModelManager.get(
        "fai-detr-l-coco", device="cpu", image_size=SIZE, num_queries=20, transformer_predictor_dec_layers=2,
        num_classes=NUM_CLASSES, backbone_config={"model_type": "resnet", "depth": 18, "variant": "d", "freeze_norm": False},
    )
    args = TrainerArgs(run_name="tiny", output_dir=str(tmp_path), batch_size=2, max_iters=2, ema_enabled=True,
                       workers_timeout=120,
                       checkpointer_period=2, log_period=1, max_instances_per_image=N_TARGETS)
    res = model.train(args, _dataset(4))
    assert res["iterations"] == 2
    with open(os.path.join(res["run_dir"], "model_info.json")) as f:
        assert json.load(f)["status"] == "TRAINING_COMPLETED"
    with np.load(os.path.join(res["run_dir"], "model_final.npz")) as data:
        flat = {k: data[k] for k in data.files}
    assert {k: v.shape for k, v in flat.items()} == tiny["shapes"]  # the JAX model's own tree
    sd = from_jax_variables(flat, "fai_detr")
    live = model.module.state_dict()
    for k, v in live.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)
    back = to_jax_variables({k: v.numpy() for k, v in sd.items()}, "fai_detr")
    assert sorted(back) == sorted(flat) and all(np.array_equal(back[k], flat[k]) for k in flat)
    assert not model.module.training and all(np.isfinite(v).all() for v in flat.values())


def test_trainer_refuses_what_is_not_ported(tmp_path):
    """Each refusal names its ROADMAP Queue 1 item; ``sync_to_hub`` is
    ported (tests/test_torch_hub.py) and no longer refused."""
    model = ModelManager.get(
        "fai-detr-l-coco", device="cpu", image_size=SIZE, num_queries=10, transformer_predictor_dec_layers=1,
        backbone_config={"model_type": "resnet", "depth": 18, "variant": "d", "freeze_norm": False},
    )
    for kw, item in (({"init_checkpoint": "x.npz"}, 5), ({"sharding": "tp"}, 9),
                     ({"mesh_shape": (2, 1)}, 9), ({"sharding": "fsdp_tp"}, 9)):
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            model.train(TrainerArgs(run_name="x", output_dir=str(tmp_path), **kw), _dataset(2))
    from focoos_tpu_torch.trainer.trainer import check_ported

    check_ported(TrainerArgs(run_name="x", sync_to_hub=True))
    with pytest.raises(NotImplementedError, match="Optimizer"):
        model.train(TrainerArgs(run_name="x", output_dir=str(tmp_path), optimizer="LAMB"), _dataset(2))
