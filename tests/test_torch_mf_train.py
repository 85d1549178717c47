"""Port parity for fai_mf training on the CPU: the point sampling, the
matcher, the deep-supervision criterion, the training targets, one train
step and the solver's groups, against the JAX package on the same numpy
weights and inputs; then FocoosModel.train through the port's trainer.

The tiny model is ``fai-mf-s-coco-ins`` cut to a ResNet-18-D backbone, one
pre-norm res5 layer, 10 queries, 2 masked decoder layers (3 prediction
sets), 11 classes, 100 loss points, at 96² (mask features 24²), B=2 with 4
and 6 valid targets of 6. The JAX side's random draws are made
deterministic without editing it: ``_matcher_coords`` is patched to seeded
numpy points, and what ``uncertainty_sampled_coords``, the auction and
``_attn_allowed_from_masks`` return is recorded and carried into the port.

Tolerances: point samples 1e-6 abs; the uncertainty pick and the matcher's
assignment equal; pair costs and criterion keys 1e-5 rel; the fp32 step's
losses 1e-5 rel and BatchNorm statistics 1e-5 abs. Gradients are compared
with both packages in fp64 (JAX under ``enable_x64`` with ``dtype=float64``,
the port cast to fp64), each within 1e-4 x its max |ref| + 1e-7: in fp32 a
ReLU whose input lies within rounding of 0 switches between the frameworks
behind train-mode BatchNorms over 18-72 values, which moves the backbone's
gradients by more than that on this model. The floor covers the attention
key biases, whose gradient is 0 in exact arithmetic (softmax is shift
invariant) and only noise from the fp32 softmax both packages keep.
"""

import json
import os
import sys
from contextlib import contextmanager
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_checkpoint import few_threads  # noqa: F401 (a fixture)
from test_torch_fai_detr import _flat, _perturb

import focoos_tpu.models.fai_mf.loss as jax_loss
import focoos_tpu.models.fai_mf.modelling as jax_mf_modelling
from focoos_tpu.data.auto_dataset import AutoDataset as JaxAutoDataset
from focoos_tpu.data.default_aug import get_default_by_task as jax_get_default_by_task
from focoos_tpu.model_manager import BackboneManager as JaxBackboneManager
from focoos_tpu.model_manager import ConfigManager as JaxConfigManager
from focoos_tpu.models.fai_mf.modelling import FAIMaskFormer as JaxFAIMaskFormer
from focoos_tpu.models.fai_mf.ports import MaskFormerAuxOutputs as JaxAux
from focoos_tpu.models.fai_mf.ports import MaskFormerModelOutput as JaxMFOutput
from focoos_tpu.models.fai_mf.ports import MaskFormerTargets as JaxTargets
from focoos_tpu.models.fai_mf.processor import MaskFormerProcessor as JaxMFProcessor
from focoos_tpu.ops.point_sample import point_sample as jax_point_sample
from focoos_tpu.ops.point_sample import uncertainty_sampled_coords as jax_uncertainty_sampled_coords
from focoos_tpu.ports import DatasetEntry as JaxDatasetEntry
from focoos_tpu.ports import DatasetLayout as JaxDatasetLayout
from focoos_tpu.ports import DatasetSplitType as JaxSplit
from focoos_tpu.ports import Task as JaxTask
from focoos_tpu.structures import BitMasks as JaxBitMasks
from focoos_tpu.structures import Instances as JaxInstances
from focoos_tpu.trainer.evaluation.evaluators import InstanceSegmentationEvaluator as JaxSegmEvaluator
from focoos_tpu.trainer.solver import leaf_hyperparams
from focoos_tpu.trainer.trainer import _freeze_paths_for
from focoos_tpu.utils import native as jax_native
from focoos_tpu.utils.checkpoint import flatten_tree, unflatten_tree
from focoos_tpu.utils.torch_convert import convert_state_dict
from focoos_tpu_torch import ModelManager
from focoos_tpu_torch.data.auto_dataset import AutoDataset
from focoos_tpu_torch.data.default_aug import get_default_by_task
from focoos_tpu_torch.model_manager import BackboneManager, ConfigManager
from focoos_tpu_torch.models.bisenetformer.processor import BisenetFormerProcessor
from focoos_tpu_torch.models.fai_mf.loss import CriterionDraws, _pair_bce, _pair_dice, make_loss_fn, match
from focoos_tpu_torch.models.fai_mf.loss import maskformer_criterion
from focoos_tpu_torch.models.fai_mf.modelling import FAIMaskFormer
from focoos_tpu_torch.models.fai_mf.ports import MaskFormerAuxOutputs, MaskFormerModelOutput, MaskFormerTargets
from focoos_tpu_torch.models.fai_mf.processor import MaskFormerProcessor
from focoos_tpu_torch.nn.layers.common import set_compute_dtype
from focoos_tpu_torch.ops.point_sample import pick_uncertain_coords, point_sample, uncertainty_sampled_coords
from focoos_tpu_torch.ports import DatasetEntry, DatasetLayout, DatasetSplitType, Task, TrainerArgs
from focoos_tpu_torch.structures import BitMasks, Instances
from focoos_tpu_torch.trainer.evaluation import InstanceSegmentationEvaluator
from focoos_tpu_torch.trainer.solver import param_hyperparams
from focoos_tpu_torch.trainer.trainer import _freeze_prefixes
from focoos_tpu_torch.utils import native
from focoos_tpu_torch.utils.weights import from_jax_variables, to_jax_variables

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

NUM_CLASSES = 11
SIZE = 96
N_TARGETS = 6
POINTS = 100
LOSS_RTOL = 1e-5
STATS_TOL = 1e-5
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-7
CARDS = os.path.join(os.path.dirname(__file__), "..", "focoos_tpu_torch", "model_registry")
R18 = {"model_type": "resnet", "depth": 18, "variant": "d", "freeze_norm": False}
TINY_MF = dict(num_classes=NUM_CLASSES, num_queries=10, transformer_predictor_dec_layers=2,
               pixel_decoder_transformer_layers=1, criterion_num_points=POINTS, backbone_config=R18)


def tiny_configs(family: str, card: str, **over):
    """(JAX config, port config) of ``card`` with ``over``."""
    with open(os.path.join(CARDS, f"{card}.json")) as f:
        d = json.load(f)["config"]
    return JaxConfigManager.from_dict(family, d, **over), ConfigManager.from_dict(family, d, **over)


def seeded_flat(port_module, family: str, jax_module, size: int = SIZE) -> dict:
    """The port module's seeded init carried into the JAX tree (every key and
    shape the JAX tree's, no key unmatched), perturbed."""
    abstract = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32))
    shapes = {"/".join(str(k.key) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_leaves_with_path(abstract)}
    port_module.init_weights(torch.Generator().manual_seed(0))
    tree, unmatched = convert_state_dict({k: v.numpy() for k, v in port_module.state_dict().items()}, family,
                                         verbose=False)
    assert unmatched == []
    flat = _perturb(_flat(tree), seed=3)
    assert {k: v.shape for k, v in flat.items()} == shapes
    return flat


def mask_targets(seed: int, b: int = 2, n: int = N_TARGETS, hm: int = SIZE // 4, wm: int = SIZE // 4):
    """Padded numpy targets: image i has n - 2 + 2i valid masks (4 and 6 of 6 at B=2), soft at the edges."""
    rng = np.random.default_rng(seed)
    valid = np.arange(n)[None, :] < (n - 2 + 2 * np.arange(b))[:, None]
    labels = (rng.integers(0, NUM_CLASSES, (b, n)) * valid).astype(np.int64)
    masks = np.zeros((b, n, hm, wm), np.float32)
    for i in range(b):
        for j in range(n):
            if valid[i, j]:
                y0, x0 = rng.integers(0, hm // 2), rng.integers(0, wm // 2)
                masks[i, j, y0:y0 + rng.integers(3, hm // 2), x0:x0 + rng.integers(3, wm // 2)] = 1.0
                masks[i, j, y0, :] *= 0.5
    return labels, masks, valid


def jax_targets(labels, masks, valid) -> JaxTargets:
    return JaxTargets(labels=jnp.asarray(labels, jnp.int32), masks=jnp.asarray(masks), valid=jnp.asarray(valid))


def port_targets(labels, masks, valid) -> MaskFormerTargets:
    return MaskFormerTargets(torch.from_numpy(labels), torch.from_numpy(masks), torch.from_numpy(valid))


@contextmanager
def recorded_jax_draws(match_pts: np.ndarray):
    """Patches the JAX package for one trace: ``_matcher_coords`` returns
    ``match_pts[layer]``; the loss points, the auction's assignments and the
    cross-attention masks are appended to the lists yielded (traced values:
    return them from the traced function)."""
    rec = {"loss_coords": [], "assign": [], "allowed": []}
    calls = []
    real_unc, real_auction = jax_loss.uncertainty_sampled_coords, jax_loss.batched_auction_assign
    real_allowed = jax_mf_modelling._attn_allowed_from_masks

    def matcher_coords(rng, b, num_points):
        calls.append(None)
        return jnp.asarray(match_pts[len(calls) - 1])

    def unc(*a, **kw):
        rec["loss_coords"].append(real_unc(*a, **kw))
        return rec["loss_coords"][-1]

    def auction(cost, valid):
        rec["assign"].append(real_auction(cost, valid))
        return rec["assign"][-1]

    def allowed(masks, hw):
        rec["allowed"].append(real_allowed(masks, hw))
        return rec["allowed"][-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loss, "_matcher_coords", matcher_coords)
        mp.setattr(jax_loss, "uncertainty_sampled_coords", unc)
        mp.setattr(jax_loss, "batched_auction_assign", auction)
        mp.setattr(jax_mf_modelling, "_attn_allowed_from_masks", allowed)
        yield rec


def jax_train_step(jmodel, jcfg, flat: dict, images, targets, match_pts, x64: bool = False) -> dict:
    """``jax.value_and_grad`` of the JAX package's ``make_loss_fn`` on ``flat``
    (fp64 weights and compute with ``x64``) → losses, total, gradients and
    moved statistics (flat numpy), and the recorded draws and masks."""
    loss_fn = jax_loss.make_loss_fn(jmodel, jcfg)
    dt = np.float64 if x64 else np.float32
    jv = unflatten_tree({k: v.astype(dt) for k, v in flat.items()})
    batch = (jnp.asarray(images), jax_targets(*targets))
    with recorded_jax_draws(match_pts) as rec:
        def total_fn(params):
            total, (losses, state) = loss_fn({"params": params, "batch_stats": jv["batch_stats"]}, batch,
                                             jax.random.PRNGKey(0))
            return total, (losses, state, {k: list(v) for k, v in rec.items()})

        (total, (losses, state, drawn)), grads = jax.jit(jax.value_and_grad(total_fn, has_aux=True))(jv["params"])
    return dict(
        total=float(total), losses={k: float(v) for k, v in losses.items()},
        grads={k: np.asarray(v, np.float64) for k, v in flatten_tree(grads, prefix="params/").items()},
        batch_stats={k: np.asarray(v, np.float64) for k, v in
                     flatten_tree(state["batch_stats"], prefix="batch_stats/").items()},
        loss_coords=np.stack([np.asarray(c) for c in drawn["loss_coords"]]),
        assign=np.stack([np.asarray(a) for a in drawn["assign"]]),
        allowed=[np.asarray(a) for a in drawn["allowed"]],
    )


def port_train_step(module, cfg, images, targets, ref: dict, match_pts, family: str, dtype=torch.float32) -> dict:
    """The port's train-mode forward and criterion on JAX's attention masks
    and points, then backward → losses, the assignment it solved, its
    gradients and moved statistics in JAX's flat layout."""
    if dtype == torch.float64:
        module.double()
    set_compute_dtype(module, dtype)
    module.train()
    _, aux = module(torch.from_numpy(images), allowed=[torch.from_numpy(a) for a in ref["allowed"]])
    rows = targets[2].reshape(-1)  # the criterion's loss points are the valid rows'
    losses, used = maskformer_criterion(aux, port_targets(*targets), cfg, carried=CriterionDraws(
        match_coords=torch.from_numpy(match_pts), loss_coords=torch.from_numpy(ref["loss_coords"][:, rows])))
    losses["total"].backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy() for n, p in module.named_parameters()}
    state = {k: v.detach().numpy() for k, v in module.state_dict().items()}
    return dict(losses={k: float(v.detach()) for k, v in losses.items()}, assign=used.assign.numpy(),
                grads=to_jax_variables(grads, family),
                batch_stats={k: v for k, v in to_jax_variables(state, family).items() if k.startswith("batch_stats/")})


def assert_step_matches(got: dict, ref: dict, targets, what: str, loss_rtol: float = LOSS_RTOL) -> None:
    """Losses ``loss_rtol``, the assignment equal on valid rows, statistics 1e-5 abs."""
    valid = targets[2]
    assert sorted(got["losses"]) == sorted(ref["losses"]) + ["total"]
    for k, v in dict(ref["losses"], total=ref["total"]).items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=loss_rtol, err_msg=f"{what} {k}")
    for layer in range(ref["assign"].shape[0]):
        np.testing.assert_array_equal(got["assign"][layer][valid], ref["assign"][layer][valid], err_msg=f"{what} assign")
    assert sorted(got["batch_stats"]) == sorted(ref["batch_stats"])
    for k, v in ref["batch_stats"].items():
        np.testing.assert_allclose(got["batch_stats"][k], v, rtol=0, atol=STATS_TOL, err_msg=f"{what} {k}")


def assert_grads_match(got: dict, ref: dict) -> None:
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=0, atol=GRAD_TOL * np.abs(r).max() + GRAD_FLOOR, err_msg=k)


@pytest.fixture(scope="module")
def tiny():
    """The JAX module and config, the perturbed weights, images, targets and
    matcher points; JAX's step in fp32 and in fp64 (one compile each)."""
    jcfg, pcfg = tiny_configs("fai_mf", "fai-mf-s-coco-ins", **TINY_MF)
    jmodel = JaxFAIMaskFormer(config=jcfg, backbone=JaxBackboneManager.from_config(jcfg.backbone_config))
    flat = seeded_flat(FAIMaskFormer(pcfg, BackboneManager.from_config(pcfg.backbone_config)), "fai_mf", jmodel)
    images = np.random.default_rng(1).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    targets = mask_targets(2)
    match_pts = np.random.default_rng(4).random((3, 2, 1, POINTS, 2)).astype(np.float32)
    ref32 = jax_train_step(jmodel, jcfg, flat, images, targets, match_pts)
    with jax.enable_x64(True):
        j64 = JaxFAIMaskFormer(config=jcfg, backbone=JaxBackboneManager.from_config(jcfg.backbone_config),
                               dtype=jnp.float64)
        ref64 = jax_train_step(j64, jcfg, flat, images, targets, match_pts, x64=True)
    return dict(jcfg=jcfg, pcfg=pcfg, flat=flat, images=images, targets=targets, match_pts=match_pts,
                ref32=ref32, ref64=ref64)


def _port_module(tiny):
    m = FAIMaskFormer(tiny["pcfg"], BackboneManager.from_config(tiny["pcfg"].backbone_config))
    m.load_state_dict(from_jax_variables(tiny["flat"], "fai_mf"), strict=True)
    return m


# --------------------------------------------------------------------------- point sampling
def test_point_sample_matches_jax():
    """Random maps at coordinates 0 and 1, on pixel centres and edges, inside
    and outside [0, 1] (zero padding)."""
    rng = np.random.default_rng(0)
    m, h, w = 3, 7, 9
    maps = rng.standard_normal((m, h, w)).astype(np.float32)
    xs = np.concatenate([[0.0, 1.0], (np.arange(w) + 0.5) / w, np.arange(w + 1) / w, [-0.3, -0.05, 1.04, 1.5]])
    ys = np.concatenate([[0.0, 1.0], (np.arange(h) + 0.5) / h, np.arange(h + 1) / h, [-0.3, -0.05, 1.04, 1.5]])
    grid = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    coords = np.concatenate([np.broadcast_to(grid, (m, *grid.shape)), rng.uniform(-0.2, 1.2, (m, 50, 2))], 1)
    coords = coords.astype(np.float32)
    ref = np.asarray(jax_point_sample(jnp.asarray(maps), jnp.asarray(coords)))
    got = point_sample(torch.from_numpy(maps), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    half = np.array([0.5 / w, 0.5 / h])
    outside = np.any((coords[:, -50:] < -half) | (coords[:, -50:] > 1 + half), -1)
    assert outside.any() and np.all(got[:, -50:][outside] == 0.0)


def test_point_sample_broadcasts_one_point_set():
    """[S, B, Q, H, W] maps at one [S, B, 1, P, 2] set per image equal each
    row sampled at that set."""
    rng = np.random.default_rng(1)
    maps = torch.from_numpy(rng.standard_normal((2, 3, 4, 6, 5)).astype(np.float32))
    coords = torch.from_numpy(rng.random((2, 3, 1, 11, 2)).astype(np.float32))
    got = point_sample(maps, coords)
    ref = point_sample(maps.reshape(24, 6, 5), coords.expand(-1, -1, 4, -1, -1).reshape(24, 11, 2))
    assert torch.equal(got.reshape(24, 11), ref)


@pytest.mark.parametrize("kind", ["random", "all-ties", "half-ties"])
def test_uncertainty_pick_matches_jax(kind):
    """The deterministic half of the point selection on JAX's own draws
    (the same key split as ``uncertainty_sampled_coords``): the picked
    points equal JAX's, ties (|logit| equal, here exactly 0) taken lower
    index first as ``jax.lax.top_k`` does."""
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 12, 10)).astype(np.float32) * 3
    if kind == "all-ties":
        logits[:] = 0.0
    elif kind == "half-ties":
        logits[:, :, :5] = 0.0
    key, p = jax.random.PRNGKey(5), 40
    ref = np.asarray(jax_uncertainty_sampled_coords(key, jnp.asarray(logits), p, 3.0, 0.75))
    r1, r2 = jax.random.split(key)
    coords = np.asarray(jax.random.uniform(r1, (4, 120, 2), jnp.float32))
    extra = np.asarray(jax.random.uniform(r2, (4, 10, 2), jnp.float32))
    got = pick_uncertain_coords(torch.from_numpy(logits), torch.from_numpy(coords), 30, torch.from_numpy(extra))
    np.testing.assert_array_equal(got.numpy(), ref)
    if kind == "all-ties":
        np.testing.assert_array_equal(ref[:, :30], coords[:, :30])


def test_uncertainty_sampled_coords_draws_from_the_generator():
    """Shape [M, P, 2] in [0, 1); one seed gives the same points."""
    logits = torch.randn(3, 8, 8, generator=torch.Generator().manual_seed(0))
    a = uncertainty_sampled_coords(torch.Generator().manual_seed(7), logits, 21)
    b = uncertainty_sampled_coords(torch.Generator().manual_seed(7), logits, 21)
    assert a.shape == (3, 21, 2) and torch.equal(a, b) and float(a.min()) >= 0.0 and float(a.max()) < 1.0


# --------------------------------------------------------------------------- criterion
def _random_aux(seed, layers=3, b=2, q=10, hm=12, wm=10):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((layers, b, q, NUM_CLASSES + 1)).astype(np.float32) * 2
    masks = rng.standard_normal((layers, b, q, hm, wm)).astype(np.float32) * 3
    return logits, masks


def test_pair_costs_match_jax():
    rng = np.random.default_rng(3)
    out = rng.standard_normal((10, 50)).astype(np.float32) * 4
    tgt = (rng.random((6, 50)) > 0.5).astype(np.float32) * rng.uniform(0.5, 1, (6, 50)).astype(np.float32)
    for fn, jfn in ((_pair_bce, jax_loss._pair_bce), (_pair_dice, jax_loss._pair_dice)):
        ref = np.asarray(jfn(jnp.asarray(out), jnp.asarray(tgt)))
        np.testing.assert_allclose(fn(torch.from_numpy(out), torch.from_numpy(tgt)).numpy(), ref, rtol=1e-5,
                                   atol=1e-7, err_msg=fn.__name__)


def test_matcher_matches_jax():
    """Every layer's assignment on the same matcher points equals JAX's
    ``_match_one_layer`` (one batched auction against JAX's per layer)."""
    cfg_j, cfg_p = tiny_configs("fai_mf", "fai-mf-s-coco-ins", **TINY_MF)
    logits, masks = _random_aux(4)
    targets = mask_targets(5, hm=12, wm=10)
    pts = np.random.default_rng(6).random((3, 2, 1, POINTS, 2)).astype(np.float32)
    got = match(MaskFormerAuxOutputs(torch.from_numpy(logits), torch.from_numpy(masks)), port_targets(*targets), cfg_p,
                torch.from_numpy(pts)).numpy()
    valid = targets[2]
    for layer in range(3):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_loss, "_matcher_coords", lambda rng, b, p, layer=layer: jnp.asarray(pts[layer]))
            ref = np.asarray(jax_loss._match_one_layer(jax.random.PRNGKey(0), jnp.asarray(logits[layer]),
                                                       jnp.asarray(masks[layer]), jax_targets(*targets), cfg_j))
        np.testing.assert_array_equal(got[layer][valid], ref[valid], err_msg=f"layer {layer}")


@pytest.mark.parametrize("case", ["deep", "last-only", "an-image-without-targets"])
def test_criterion_matches_jax(case):
    """maskformer_criterion on JAX's matcher points and loss points: every
    key (``loss_{ce,mask,dice}``, ``_<i>`` per earlier layer with deep
    supervision) within 1e-5 rel; the JAX-recorded assignment equals the port's."""
    cfg_j, cfg_p = tiny_configs("fai_mf", "fai-mf-s-coco-ins", **TINY_MF)
    for cfg in (cfg_j, cfg_p):
        cfg.criterion_deep_supervision = case != "last-only"
    logits, masks = _random_aux(7)
    targets = mask_targets(8, hm=12, wm=10)
    if case == "an-image-without-targets":
        targets[2][0] = False
        targets[1][0] = 0.0
    pts = np.random.default_rng(9).random((3, 2, 1, POINTS, 2)).astype(np.float32)
    with recorded_jax_draws(pts) as rec:
        ref = jax_loss.maskformer_criterion(jax.random.PRNGKey(1), JaxAux(jnp.asarray(logits), jnp.asarray(masks)),
                                            jax_targets(*targets), cfg_j)
        loss_coords = np.stack([np.asarray(c) for c in rec["loss_coords"]])
        jassign = np.stack([np.asarray(a) for a in rec["assign"]])
    rows = targets[2].reshape(-1)  # the port samples only the valid rows, JAX every padding row too
    got, used = maskformer_criterion(
        MaskFormerAuxOutputs(torch.from_numpy(logits), torch.from_numpy(masks)), port_targets(*targets), cfg_p,
        carried=CriterionDraws(match_coords=torch.from_numpy(pts), loss_coords=torch.from_numpy(loss_coords[:, rows])))
    assert sorted(got) == sorted(ref)
    assert (len(got) == 10) == (case != "last-only")
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=LOSS_RTOL, err_msg=k)
    valid = targets[2]
    np.testing.assert_array_equal(used.assign.numpy()[:, valid], jassign[:, valid])
    assert torch.equal(used.loss_coords, torch.from_numpy(loss_coords[:, rows]))


def test_criterion_draws_from_its_generator_and_takes_carried_draws():
    """One seed gives the same draws, assignment and losses; carrying the
    assignment and loss points skips every draw (no matcher points) and
    gives the same losses."""
    _, cfg = tiny_configs("fai_mf", "fai-mf-s-coco-ins", **TINY_MF)
    logits, masks = _random_aux(10)
    aux = MaskFormerAuxOutputs(torch.from_numpy(logits), torch.from_numpy(masks))
    targets = port_targets(*mask_targets(11, hm=12, wm=10))
    first, used = maskformer_criterion(aux, targets, cfg, torch.Generator().manual_seed(3))
    second, used2 = maskformer_criterion(aux, targets, cfg, torch.Generator().manual_seed(3))
    carried, used3 = maskformer_criterion(aux, targets, cfg, carried=CriterionDraws(
        assign=used.assign, loss_coords=used.loss_coords))
    m = int(targets.valid.sum())  # loss points for the valid rows only
    assert used.match_coords.shape == (3, 2, 1, POINTS, 2) and used.loss_coords.shape == (3, m, POINTS, 2)
    assert torch.equal(used2.match_coords, used.match_coords) and torch.equal(used2.loss_coords, used.loss_coords)
    assert used3.match_coords is None and torch.equal(used3.assign, used.assign)
    assert all(float(first[k]) == float(second[k]) == float(carried[k]) for k in first)


# --------------------------------------------------------------------------- targets
def _instance_entries(jax_package: bool, sizes, counts, seed: int):
    entry_cls, inst_cls, masks_cls = (JaxDatasetEntry, JaxInstances, JaxBitMasks) if jax_package else (
        DatasetEntry, Instances, BitMasks)
    rng = np.random.default_rng(seed)
    out = []
    for (h, w), k in zip(sizes, counts):
        masks = rng.random((k, h, w)) > 0.7
        inst = inst_cls((h, w), classes=rng.integers(0, NUM_CLASSES, k), masks=masks_cls(masks))
        out.append(entry_cls(image=rng.integers(0, 256, (h, w, 3), dtype=np.uint8), height=h, width=w, instances=inst))
    return out


@pytest.mark.parametrize("sizes,counts,stride", [
    (((97, 75), (90, 81)), (3, 5), 4),
    (((64, 64), (61, 66)), (103, 0), 4),
    (((99, 70), (99, 70)), (2, 7), 8),
], ids=["odd-sizes", "over-100-and-empty", "stride-8"])
def test_training_targets_match_jax(sizes, counts, stride):
    """preprocess_entries in training against the JAX processor's: the padded
    batch, labels and valid equal, masks (cv2's bilinear on fp32 at
    ceil(h/stride) x ceil(w/stride)) within 1e-6 abs; at most 100 instances;
    CPU tensors."""
    jcfg, pcfg = tiny_configs("fai_mf", "fai-mf-s-coco-ins", **TINY_MF)
    jp = JaxMFProcessor(jcfg).train(True)
    pp = (MaskFormerProcessor if stride == 4 else BisenetFormerProcessor)(pcfg).train(True)
    assert pp.mask_stride == stride
    jb, jt = jp.preprocess_entries(_instance_entries(True, sizes, counts, 12), mask_stride=stride)
    pb, pt = pp.preprocess_entries(_instance_entries(False, sizes, counts, 12))
    np.testing.assert_array_equal(pb, jb)
    h, w = pb.shape[1:3]
    assert pt.masks.shape == (2, 100, -(-h // stride), -(-w // stride)) and pt.labels.dtype == torch.int64
    np.testing.assert_array_equal(pt.labels.numpy(), np.asarray(jt.labels))
    np.testing.assert_array_equal(pt.valid.numpy(), np.asarray(jt.valid))
    np.testing.assert_allclose(pt.masks.numpy(), np.asarray(jt.masks), rtol=0, atol=1e-6)
    assert int(pt.valid.sum()) == sum(min(c, 100) for c in counts) and not pt.masks.is_cuda
    moved = pt.to("cpu", non_blocking=True)
    assert isinstance(moved, MaskFormerTargets) and torch.equal(moved.masks, pt.masks)


def test_semantic_records_give_targets_as_jax(tmp_path):
    """A seeded Roboflow semantic set through each package's semantic mapper
    (one mask a class present) and its processor in training."""
    from make_synthetic_dataset import make_semseg

    root = make_semseg(str(tmp_path / "sem"), n_train=2, n_val=1, size=90, seed=4)
    layout = "roboflow_seg"
    pds = AutoDataset(root, task="semseg", layout=DatasetLayout(layout)).get_split(
        get_default_by_task(Task.SEMSEG, 90)[1], split=DatasetSplitType.TRAIN)
    jds = JaxAutoDataset(root, task="semseg", layout=JaxDatasetLayout(layout)).get_split(
        jax_get_default_by_task(JaxTask.SEMSEG, 90)[1], split=JaxSplit.TRAIN)
    jcfg, pcfg = tiny_configs("fai_mf", "fai-mf-m-ade", num_classes=NUM_CLASSES)
    _, jt = JaxMFProcessor(jcfg).train(True).preprocess_entries([jds[0], jds[1]])
    _, pt = MaskFormerProcessor(pcfg).train(True).preprocess_entries([pds[0], pds[1]])
    assert pt.masks.shape[-2:] == (23, 23) and int(pt.valid.sum()) > 2
    np.testing.assert_array_equal(pt.labels.numpy(), np.asarray(jt.labels))
    np.testing.assert_array_equal(pt.valid.numpy(), np.asarray(jt.valid))
    np.testing.assert_allclose(pt.masks.numpy(), np.asarray(jt.masks), rtol=0, atol=1e-6)


# --------------------------------------------------------------------------- the model and one step
def test_train_mode_forward_skips_the_upsample(tiny):
    """Train mode: masks at the mask features' size, every layer's fp32
    outputs in aux; eval mode upsamples; pixel-decoder dropout is refused
    in training (the JAX package applies none)."""
    module = _port_module(tiny).train()
    x = torch.from_numpy(tiny["images"])
    out, aux = module(x)
    assert out.masks.shape == (2, 10, SIZE // 4, SIZE // 4) and aux.masks.shape == (3, 2, 10, SIZE // 4, SIZE // 4)
    assert aux.logits.dtype == aux.masks.dtype == torch.float32 and aux.masks.requires_grad
    assert len(aux.allowed) == 2 and not any(a.requires_grad for a in aux.allowed)
    with torch.inference_mode():
        assert module.eval()(x)[0].masks.shape == (2, 10, SIZE, SIZE)
    module.config.pixel_decoder_transformer_dropout = 0.1
    try:
        with pytest.raises(ValueError, match="dropout"):
            module.train()(x)
    finally:
        module.config.pixel_decoder_transformer_dropout = 0.0


@pytest.mark.usefixtures("few_threads")
def test_train_step_matches_jax(tiny):
    """One fp32 train step on JAX's attention masks and points: every loss
    key and the total within 1e-5 rel, the port's own assignment equal to
    JAX's, the BatchNorm statistics the forward moved within 1e-5."""
    got = port_train_step(_port_module(tiny), tiny["pcfg"], tiny["images"], tiny["targets"], tiny["ref32"],
                          tiny["match_pts"], "fai_mf")
    assert len(got["losses"]) == 10
    assert_step_matches(got, tiny["ref32"], tiny["targets"], "fp32")


@pytest.mark.usefixtures("few_threads")
def test_train_step_gradients_match_jax_in_fp64(tiny):
    """Every gradient of one step, both packages in fp64 (the criterion and
    the attention softmax in fp32, as both compute them), within 1e-4 x its
    max |ref| + 1e-7."""
    got = port_train_step(_port_module(tiny), tiny["pcfg"], tiny["images"], tiny["targets"], tiny["ref64"],
                          tiny["match_pts"], "fai_mf", dtype=torch.float64)
    assert_step_matches(got, tiny["ref64"], tiny["targets"], "fp64")
    assert_grads_match(got["grads"], tiny["ref64"]["grads"])


@pytest.mark.usefixtures("few_threads")
def test_make_loss_fn_seeds_its_generator():
    """Two fresh loss closures on the same weights and batch draw the same
    points (a generator seeded with 0 on the images' device, as the JAX
    trainer's stream starts from PRNGKey(0)), hence the same losses."""
    _, pcfg = tiny_configs("fai_mf", "fai-mf-s-coco-ins", **TINY_MF)
    module = FAIMaskFormer(pcfg, BackboneManager.from_config(pcfg.backbone_config))
    module.init_weights(torch.Generator().manual_seed(0))
    images = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
    targets = port_targets(*mask_targets(5, hm=16, wm=16))
    state = {k: v.clone() for k, v in module.state_dict().items()}
    runs = []
    for _ in range(2):
        module.load_state_dict(state)
        module.train()
        total, losses = make_loss_fn(module, pcfg)(images, targets)
        runs.append((float(total), {k: float(v) for k, v in losses.items()}))
    assert runs[0] == runs[1] and np.isfinite(runs[0][0]) and "total" not in runs[0][1]


# --------------------------------------------------------------------------- solver
@pytest.mark.parametrize("freeze", ["none", "freeze_bn", "freeze_at"])
def test_solver_groups_match_jax(tiny, freeze):
    """lr multiplier and weight decay of every fai_mf parameter (non-default
    multipliers) against leaf_hyperparams on the flax tree: the stacked
    backbone x decoder multipliers under ``pixel_decoder.*``, the head's
    under ``head.predictor.*`` outside the classifiers, norm and embedding
    decays; freeze_bn spares the FPN's BatchNorms (not under ``/bn/`` in
    JAX); freeze_at=1 freezes the stem and res2 in both."""
    module = _port_module(tiny)
    names = [n for n, _ in module.named_parameters()]
    ids = {n: np.full(tuple(p.shape), i, np.float32) for i, (n, p) in enumerate(module.named_parameters())}
    source = {k: names[int(v.flat[0])] for k, v in
              _flat({"params": convert_state_dict(ids, "fai_mf", verbose=False)[0]["params"]}).items()}
    kw = dict(base_wd=0.02, wd_norm=0.01, wd_embed=0.03, backbone_multiplier=0.1, decoder_multiplier=0.5,
              head_multiplier=2.0)

    freeze_prefixes, freeze_paths = _freeze_prefixes(SimpleNamespace(config=tiny["pcfg"])), ()
    assert freeze_prefixes == ()  # freeze_at -1 on the ResNet cards; STDC has no freeze_at
    assert _freeze_prefixes(SimpleNamespace(config=tiny_configs("fai_mf", "fai-mf-m-ade")[1])) == ()
    if freeze == "freeze_at":
        jcfg, pcfg = tiny_configs("fai_mf", "fai-mf-s-coco-ins", **dict(TINY_MF, backbone_config=dict(R18, freeze_at=1)))
        freeze_prefixes = _freeze_prefixes(SimpleNamespace(config=pcfg))
        freeze_paths = _freeze_paths_for(SimpleNamespace(config=jcfg))
        assert freeze_prefixes == ("pixel_decoder.backbone.conv1.", "pixel_decoder.backbone.res_layers.0.")
    lr_tree, wd_tree = leaf_hyperparams(unflatten_tree(tiny["flat"])["params"], freeze_paths=freeze_paths,
                                        freeze_bn=freeze == "freeze_bn", **kw)
    hp = param_hyperparams(module, freeze_prefixes=freeze_prefixes, freeze_bn=freeze == "freeze_bn", **kw)
    assert sorted(source) == sorted(_flat({"params": lr_tree}))
    for i, ref_tree in enumerate((lr_tree, wd_tree)):
        for k, ref in _flat({"params": ref_tree}).items():
            assert hp[source[k]][i] == pytest.approx(float(ref), rel=1e-6), (k, source[k], i)
    if freeze == "none":
        assert hp["pixel_decoder.backbone.conv1.conv1_1.conv.weight"] == pytest.approx((0.05, 0.02))
        assert hp["head.predictor.query_embed.weight"] == (2.0, 0.03)
        assert hp["head.predictor.forward_prediction_heads.classifier.weight"] == (1.0, 0.02)
    if freeze == "freeze_bn":
        assert hp["pixel_decoder.layer_4.norm.weight"][0] > 0 and hp["pixel_decoder.backbone.conv1.conv1_1.norm.weight"] == (0, 0)


# --------------------------------------------------------------------------- the trainer
def _train_entries(n: int, size: int, seed: int, semantic: bool = False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 4))
        masks = np.zeros((k, size, size), bool)
        for j in range(k):
            y, x = rng.integers(0, size // 2, 2)
            masks[j, y:y + rng.integers(8, size // 2), x:x + rng.integers(8, size // 2)] = True
        inst = Instances((size, size), boxes=BitMasks(masks).get_bounding_boxes(),
                         classes=rng.integers(0, 3, k), masks=BitMasks(masks))
        sem = np.where(masks.any(0), np.argmax(masks, 0), 255).astype(np.uint8) if semantic else None
        out.append(DatasetEntry(image=rng.integers(0, 256, (size, size, 3), dtype=np.uint8), height=size, width=size,
                                instances=inst, sem_seg=sem))
    return out


@pytest.mark.usefixtures("few_threads")
def test_focoos_model_trains_fai_mf_on_the_cpu(tmp_path):
    """ModelManager.get("fai-mf-l-coco-ins") at a tiny config trains through
    FocoosModel.train (2 loader workers, validation with segm/AP, EMA) and
    writes the JAX layout's weights; every logged loss is finite."""
    model = ModelManager.get("fai-mf-l-coco-ins", device="cpu", num_classes=3, **{
        k: v for k, v in TINY_MF.items() if k != "num_classes"})
    args = TrainerArgs(run_name="mf", output_dir=str(tmp_path), batch_size=2, max_iters=2, eval_period=2,
                       checkpointer_period=2, log_period=1, ema_enabled=True, workers=2, workers_timeout=120, samples=0)
    res = model.train(args, _train_entries(4, 64, 0), _train_entries(2, 64, 1))
    assert res["iterations"] == 2 and 0.0 <= res["metrics"]["segm"]["AP"] <= 100.0
    with open(os.path.join(res["run_dir"], "metrics.json")) as f:
        rows = [json.loads(line) for line in f]
    losses = [v for r in rows for k, v in r.items() if k.startswith("loss_")]
    assert len({k for r in rows for k in r if k.startswith("loss_")}) == 9 and all(np.isfinite(losses))
    with np.load(os.path.join(res["run_dir"], "model_final.npz")) as data:
        assert all(np.isfinite(data[k]).all() for k in data.files)
    assert not model.module.training


# --------------------------------------------------------------------------- ROADMAP Queue 3
def test_a_resized_record_pairs_masks_of_two_sizes(tmp_path):
    """The resized-record fault (ROADMAP Queue 3, fixed in the port):
    ``segmentation_val_augs`` at 64 maps a 96² record to 64² with its
    original height and width kept, and eval_postprocess resizes the
    predicted masks to 96². The JAX evaluator takes the ground truth at 64²:
    its numpy path raises on the shapes (its host library reads past the
    smaller masks). The port's takes the record's own masks at 96²
    (``DatasetEntry.original_instances``): a prediction equal to them scores
    segm/AP 100.0, and the random masks' output is scored without raising,
    with or without its library."""
    from make_synthetic_dataset import make

    from focoos_tpu_torch.structures import Boxes

    root = make(str(tmp_path / "ins"), n_train=1, n_val=1, size=96, seed=3)
    pentry = AutoDataset(root, task="instseg").get_split(
        get_default_by_task(Task.INSTANCE_SEGMENTATION, 64)[1], split=DatasetSplitType.VAL)[0]
    jentry = JaxAutoDataset(root, task="instseg").get_split(
        jax_get_default_by_task(JaxTask.INSTANCE_SEGMENTATION, 64)[1], split=JaxSplit.VAL)[0]
    assert pentry.image.shape[:2] == (64, 64) and (pentry.height, pentry.width) == (96, 96)
    assert pentry.instances.masks.tensor.shape[1:] == (64, 64)
    assert pentry.original_instances.masks.tensor.shape[1:] == (96, 96)
    rng = np.random.default_rng(0)
    logits = rng.dirichlet(np.ones(4), (1, 5))[..., :3].astype(np.float32)
    masks = rng.random((1, 5, 64, 64)).astype(np.float32)
    jcfg, pcfg = tiny_configs("fai_mf", "fai-mf-s-coco-ins", num_classes=3)
    pout = MaskFormerProcessor(pcfg).eval_postprocess(
        MaskFormerModelOutput(masks=torch.from_numpy(masks), logits=torch.from_numpy(logits)), [pentry])
    jout = JaxMFProcessor(jcfg).eval_postprocess(JaxMFOutput(masks=jnp.asarray(masks), logits=jnp.asarray(logits)),
                                                 [jentry])
    assert pout[0]["instances"].masks.tensor.shape[1:] == np.asarray(jout[0]["instances"].masks.tensor).shape[1:] == (96, 96)
    # the exact prediction: the record's instances at 96², as the JAX package maps the record unresized
    truth = JaxAutoDataset(root, task="instseg").get_split(
        jax_get_default_by_task(JaxTask.INSTANCE_SEGMENTATION, 96)[1], split=JaxSplit.VAL)[0].instances
    g = len(truth)
    exact = [{"instances": Instances((96, 96), boxes=Boxes(np.asarray(truth.boxes.tensor)),
                                     scores=np.linspace(0.9, 0.5, g).astype(np.float32),
                                     classes=np.asarray(truth.classes, np.int64),
                                     masks=BitMasks(np.asarray(truth.masks.tensor)))}]
    assert g > 0
    with pytest.MonkeyPatch.context() as mp:
        for library in (True, False):
            if not library:
                mp.setattr(native, "_load", lambda: None)
            ev = InstanceSegmentationEvaluator(num_classes=3)
            ev.process([pentry], exact)
            assert ev.evaluate()["segm"]["AP"] == pytest.approx(100.0), library
            ev = InstanceSegmentationEvaluator(num_classes=3)
            ev.process([pentry], pout)
            assert np.isfinite(ev.evaluate()["segm"]["AP"])
        mp.setattr(jax_native, "_load", lambda: None)
        with pytest.raises(ValueError, match="mismatch"):
            JaxSegmEvaluator(num_classes=3).process([jentry], jout)
