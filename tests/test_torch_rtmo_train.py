"""Port parity for rtmo training on the CPU: the OKS, SimOTA, the positive
gather, DCC's masked BatchNorm and target heatmaps, the criterion, one train
step, the training targets and the solver's groups, against the JAX package
on the same numpy weights and inputs; then FocoosModel.train.

The tiny model is ``rtmo-s-coco`` with one AIFI layer at 128²
(``tests/test_model_families.py``), its weights perturbed as
``tests/test_torch_rtmo.py`` does; SimOTA and the criterion run for
``widen_factor`` 0.5 (rtmo-s: the centre region around the visible
keypoints' mean) and 1.0 (the box centre).

Tolerances: OKS, heatmaps and matched OKS 1e-6 abs; the assignment (positive
set and gt index) and the positive gather equal; the masked BatchNorm's
output and statistics 1e-6 abs; the criterion's losses and ``num_pos`` 1e-5
rel on the same raw outputs, DCC's moved statistics 1e-6 abs; the train step
with both packages in fp64 (each packages' raw outputs, losses and DCC
heatmaps in fp32, as both cast them): losses 1e-5 rel, every gradient within
1e-4 x its max |ref| + 1e-7, every moved statistic 1e-6 abs. The floor
covers the AIFI layer's attention key bias, whose gradient is 0 in exact
arithmetic (the softmax is shift invariant; as in
``tests/test_torch_mf_train.py``). Three DCC biases have a gradient of 0 in exact arithmetic and only the noise of the
fp32 statistics and softmax both packages keep: ``pose_to_kpts``'s (a
train-mode BatchNorm follows it) and ``x_fc``'s and ``y_fc``'s (a shift of
every bin's logit, which the softmax cancels); each is held below 1e-6 abs
on both sides instead.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_checkpoint import few_threads  # noqa: F401 (a fixture)
from test_torch_rtmo import _flat, _perturb

import focoos_tpu.models.rtmo.loss as jax_loss
from focoos_tpu.model_manager import BackboneManager as JaxBackboneManager
from focoos_tpu.model_manager import ConfigManager as JaxConfigManager
from focoos_tpu.models.rtmo.modelling import DCC as JaxDCC
from focoos_tpu.models.rtmo.modelling import RTMO as JaxRTMO
from focoos_tpu.models.rtmo.modelling import _MaskedBatchNorm as JaxMaskedBatchNorm
from focoos_tpu.models.rtmo.ports import KeypointTargets as JaxTargets
from focoos_tpu.models.rtmo.processor import RTMOProcessor as JaxRTMOProcessor
from focoos_tpu.ports import DatasetEntry as JaxDatasetEntry
from focoos_tpu.structures import Boxes as JaxBoxes
from focoos_tpu.structures import Instances as JaxInstances
from focoos_tpu.structures import Keypoints as JaxKeypoints
from focoos_tpu.trainer.solver import leaf_hyperparams
from focoos_tpu.utils.checkpoint import flatten_tree, unflatten_tree
from focoos_tpu.utils.torch_convert import convert_state_dict
from focoos_tpu_torch import ModelManager
from focoos_tpu_torch.model_manager import BackboneManager, ConfigManager
from focoos_tpu_torch.models.rtmo.loss import (
    Assignment,
    _gather_positives,
    make_loss_fn,
    pairwise_oks,
    rtmo_criterion,
    simota_assign,
)
from focoos_tpu_torch.models.rtmo.modelling import RTMO
from focoos_tpu_torch.models.rtmo.ports import KeypointTargets, RTMOAuxOutputs
from focoos_tpu_torch.models.rtmo.processor import RTMOProcessor
from focoos_tpu_torch.nn.layers.common import BatchNorm, MaskedBatchNorm1d, set_compute_dtype
from focoos_tpu_torch.ports import DatasetEntry, TrainerArgs
from focoos_tpu_torch.structures import Boxes, Instances, Keypoints
from focoos_tpu_torch.trainer.solver import param_hyperparams
from focoos_tpu_torch.utils.weights import from_jax_variables

SIZE = 128
K = 17
N_GT = 5
TINY = dict(transformer_encoder_layers=1, nms_pre_topk=50, max_detections=10)
ABS_TOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-7
ZERO_GRADS = ("params/dcc/pose_to_kpts_fc/bias", "params/dcc/x_fc/bias", "params/dcc/y_fc/bias")
CARDS = os.path.join(os.path.dirname(__file__), "..", "focoos_tpu_torch", "model_registry")
LOSS_KEYS = ["loss_bbox", "loss_cls", "loss_mle", "loss_oks", "loss_vis", "num_pos"]


def tiny_configs(**over):
    with open(os.path.join(CARDS, "rtmo-s-coco.json")) as f:
        d = json.load(f)["config"]
    over = dict(TINY, **over)
    return JaxConfigManager.from_dict("rtmo", d, **over), ConfigManager.from_dict("rtmo", d, **over)


def build(widen: float = 0.5, dtype=None):
    """(JAX module, port module (eval) with the perturbed weights, the weights flat in JAX's layout)."""
    jcfg, pcfg = tiny_configs(widen_factor=widen)
    jmodel = JaxRTMO(config=jcfg, backbone=JaxBackboneManager.from_config(jcfg.backbone_config), dtype=dtype)
    port = RTMO(pcfg, BackboneManager.from_config(pcfg.backbone_config))
    port.init_weights(torch.Generator().manual_seed(0))
    tree, unmatched = convert_state_dict({k: v.numpy() for k, v in port.state_dict().items()}, "rtmo", verbose=False)
    assert unmatched == []
    flat = _perturb(_flat(tree), seed=1)
    port.load_state_dict(from_jax_variables(flat, "rtmo"), strict=True)
    return jmodel, port.eval(), flat


def person_targets(seed: int, counts=(2, 3), n: int = N_GT, size: int = SIZE):
    """Padded numpy targets of ``counts`` people an image: boxes 30-70 px,
    17 keypoints inside each, about a third invisible; the second image's
    last person has no visible keypoint."""
    rng = np.random.default_rng(seed)
    b = len(counts)
    labels = np.zeros((b, n), np.int64)
    boxes = np.zeros((b, n, 4), np.float32)
    kpts = np.zeros((b, n, K, 2), np.float32)
    vis = np.zeros((b, n, K), np.float32)
    valid = np.zeros((b, n), bool)
    for i, c in enumerate(counts):
        for j in range(c):
            w, h = rng.uniform(30, 70, 2)
            x0, y0 = rng.uniform(0, size - w), rng.uniform(0, size - h)
            boxes[i, j] = [x0, y0, x0 + w, y0 + h]
            kpts[i, j] = np.stack([rng.uniform(x0, x0 + w, K), rng.uniform(y0, y0 + h, K)], -1)
            vis[i, j] = rng.random(K) > 0.33
            valid[i, j] = True
    if b > 1 and counts[1] > 0:
        vis[1, counts[1] - 1] = 0.0
    areas = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    return labels, boxes, kpts, vis, areas, valid


def port_targets(t) -> KeypointTargets:
    return KeypointTargets(*(torch.from_numpy(a) for a in t))


def jax_targets(t) -> JaxTargets:
    labels, *rest = t
    return JaxTargets(jnp.asarray(labels, jnp.int32), *(jnp.asarray(a) for a in rest))


# --------------------------------------------------------------------------- OKS and SimOTA
def test_pairwise_oks_matches_jax():
    rng = np.random.default_rng(0)
    kpts = rng.uniform(0, 100, (30, K, 2)).astype(np.float32)
    gt = rng.uniform(0, 100, (4, K, 2)).astype(np.float32)
    kpts[:5] = gt[0] + rng.normal(0, 2, (5, K, 2))  # near one person: OKS well above 0
    vis = (rng.random((4, K)) > 0.3).astype(np.float32)
    vis[3] = 0.0
    areas = np.array([900.0, 2500.0, 0.0, 400.0], np.float32)
    ref = np.asarray(jax_loss.pairwise_oks(*(jnp.asarray(a) for a in (kpts, gt, vis, areas))))
    got = pairwise_oks(*(torch.from_numpy(a) for a in (kpts, gt, vis, areas))).numpy()
    assert ref[:5, 0].min() > 0.1
    np.testing.assert_allclose(got, ref, rtol=0, atol=ABS_TOL)


def grid_priors4(size: int = 64):
    """Priors at stride 8 (64 of them) and 16 (16) over a size² image: [A, 4] (cx, cy, s, s)."""
    out = []
    for s in (8, 16):
        c = (np.arange(size // s) + 0.5) * s
        gx, gy = np.meshgrid(c, c)
        out.append(np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, s), np.full(gx.size, s)], -1))
    return np.concatenate(out).astype(np.float32)


def simota_case(case: str, seed: int = 0):
    """One image's SimOTA inputs (priors, scores, boxes, keypoints, targets)
    on a 64² grid of 80 priors. "penalized": one 9x9 person whose keypoints
    every prior predicts well, so its dynamic k (10) exceeds its strict
    candidates; "two-gts": two overlapping people, priors inside both;
    "no-gt": every target row padding."""
    rng = np.random.default_rng(seed)
    priors = grid_priors4()
    a = priors.shape[0]
    n = 3
    boxes_gt = np.zeros((n, 4), np.float32)
    kp_gt = np.zeros((n, K, 2), np.float32)
    vis = np.zeros((n, K), np.float32)
    valid = np.zeros(n, bool)
    if case == "penalized":
        boxes_gt[0] = [27, 27, 36, 36]
        valid[0] = True
    elif case == "two-gts":
        boxes_gt[0], boxes_gt[1] = [10, 10, 50, 50], [20, 14, 60, 56]
        valid[:2] = True
    for j in np.nonzero(valid)[0]:
        x0, y0, x1, y1 = boxes_gt[j]
        kp_gt[j] = np.stack([rng.uniform(x0, x1, K), rng.uniform(y0, y1, K)], -1)
        vis[j] = rng.random(K) > 0.3
    areas = (boxes_gt[:, 2] - boxes_gt[:, 0]) * (boxes_gt[:, 3] - boxes_gt[:, 1])
    centre = priors[:, None, :2]
    pred_boxes = np.concatenate([centre[:, 0] - 12, centre[:, 0] + 12], -1) + rng.normal(0, 1, (a, 4))
    if case == "penalized":
        pred_kpts = kp_gt[0][None] + rng.normal(0, 0.05, (a, K, 2))
    else:
        ref = kp_gt[np.argmin(np.abs(priors[:, :1] - 30), 1) * 0]  # the first person's keypoints
        pred_kpts = ref + rng.normal(0, 3, (a, K, 2)) + (priors[:, None, :2] - 32) * 0.1
    scores = rng.uniform(0.05, 0.95, (a, 1))
    gt = (np.zeros(n, np.int64), boxes_gt, kp_gt, vis, areas.astype(np.float32), valid)
    return (priors, scores.astype(np.float32), pred_boxes.astype(np.float32), pred_kpts.astype(np.float32),
            rng.random((a, K)).astype(np.float32), gt)


def _strict(priors, gt, widen: float):
    """[A, N] the strict test (in the gt box and in its centre region), as JAX computes it, in numpy."""
    _, boxes, kp, vis, _, valid = gt
    px, py, sx = priors[:, 0:1], priors[:, 1:2], priors[:, 2:3]
    in_gt = (px > boxes[:, 0]) & (py > boxes[:, 1]) & (px < boxes[:, 2]) & (py < boxes[:, 3])
    cx, cy = (boxes[:, 0] + boxes[:, 2]) / 2, (boxes[:, 1] + boxes[:, 3]) / 2
    if widen == 0.5:
        has = vis.sum(-1) > 0
        vs = np.maximum(vis.sum(-1), 1e-7)
        cx = np.where(has, (kp[..., 0] * vis).sum(-1) / vs, cx)
        cy = np.where(has, (kp[..., 1] * vis).sum(-1) / vs, cy)
    in_ct = (np.abs(px - cx) < 2.5 * sx) & (np.abs(py - cy) < 2.5 * sx)
    return in_gt & in_ct & valid, in_gt & valid


@pytest.mark.parametrize("widen", [0.5, 1.0])
@pytest.mark.parametrize("case", ["penalized", "two-gts", "no-gt"])
def test_simota_assign_single_matches_jax(case, widen):
    """pos_mask, gt_idx equal and matched_oks within 1e-6 of JAX's
    ``simota_assign_single``; each case shows what it is for: positives that
    fail the strict test, a positive inside two people's boxes, none at all."""
    jcfg, pcfg = tiny_configs(widen_factor=widen)
    priors, scores, boxes, kpts, kvis, gt = simota_case(case)
    ref = jax.jit(lambda *a: jax_loss.simota_assign_single(*a, jcfg))(
        *(jnp.asarray(a) for a in (priors, scores, boxes, kpts, kvis)), jax_targets(gt))
    # the port batches SimOTA over images: this image as a batch of one
    one = port_targets(gt)
    out = simota_assign(torch.from_numpy(priors), *(torch.from_numpy(a)[None] for a in (scores, boxes, kpts)),
                        KeypointTargets(*(t[None] for t in one._fields())), pcfg)
    pos, gidx, moks = out.pos_mask[0], out.gt_idx[0], out.matched_oks[0]
    pos_r, gidx_r, moks_r = (np.asarray(r) for r in ref)
    np.testing.assert_array_equal(pos.numpy(), pos_r)
    np.testing.assert_array_equal(gidx.numpy()[pos_r], gidx_r[pos_r])
    np.testing.assert_allclose(moks.numpy(), moks_r, rtol=0, atol=ABS_TOL)
    strict, in_box = _strict(priors, gt, widen)
    if case == "penalized":
        assert pos_r.sum() > strict[:, 0].sum() and (pos_r & ~strict[:, 0]).any(), "no penalized prior became a positive"
    elif case == "two-gts":
        assert (pos_r & in_box[:, 0] & in_box[:, 1]).any(), "no positive lies inside both people"
    else:
        assert not pos_r.any()


def test_simota_batched_equals_per_image_jax():
    """The batched SimOTA over three images equals JAX's per-image function
    under ``vmap`` (the batch's images are independent)."""
    jcfg, pcfg = tiny_configs()
    cases = [simota_case(c, seed=i) for i, c in enumerate(("penalized", "two-gts", "no-gt"))]
    priors = cases[0][0]
    stack = [np.stack([c[i] for c in cases]) for i in range(1, 5)]
    gts = [np.stack([c[5][i] for c in cases]) for i in range(6)]
    ref = jax.jit(jax.vmap(lambda s, bx, kp, kv, g: jax_loss.simota_assign_single(jnp.asarray(priors), s, bx, kp, kv, g,
                                                                                    jcfg)))(
        *(jnp.asarray(a) for a in stack), jax_targets(gts))
    got = simota_assign(torch.from_numpy(priors), *(torch.from_numpy(a) for a in stack[:3]), port_targets(gts), pcfg)
    np.testing.assert_array_equal(got.pos_mask.numpy(), np.asarray(ref[0]))
    pos = np.asarray(ref[0])
    np.testing.assert_array_equal(got.gt_idx.numpy()[pos], np.asarray(ref[1])[pos])
    np.testing.assert_allclose(got.matched_oks.numpy(), np.asarray(ref[2]), rtol=0, atol=ABS_TOL)


@pytest.mark.parametrize("p_max", [7, 96])
def test_gather_positives_ties_match_jax(p_max):
    """More positives than p_max, many of one matched OKS: the same slots in
    ``jax.lax.top_k``'s order (equal values, lower prior first)."""
    rng = np.random.default_rng(3)
    a = 300
    pos = rng.random((2, a)) > 0.4
    moks = np.where(rng.random((2, a)) > 0.5, 0.5, rng.random((2, a))).astype(np.float32) * pos
    gidx = rng.integers(0, 4, (2, a))
    refs = [jax_loss._gather_positives(jnp.asarray(pos[i]), jnp.asarray(gidx[i]), jnp.asarray(moks[i]), p_max)
            for i in range(2)]
    sel, valid = _gather_positives(Assignment(torch.from_numpy(pos), torch.from_numpy(gidx), torch.from_numpy(moks)), p_max)
    assert pos.sum(1).min() > p_max
    for i, (s_r, v_r) in enumerate(refs):
        np.testing.assert_array_equal(sel[i].numpy(), np.asarray(s_r))
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(v_r))


# --------------------------------------------------------------------------- DCC's train parts
@pytest.mark.parametrize("masked", [True, False])
def test_masked_batchnorm_matches_flax(masked):
    """Train-mode output and running update against JAX's _MaskedBatchNorm:
    the mean and the biased variance over the valid rows, momentum 0.9;
    padding rows (here huge) move nothing; eval takes the running statistics."""
    rng = np.random.default_rng(4)
    f = 24
    x = rng.standard_normal((2, 6, f)).astype(np.float32) * 3 + 1
    mask = rng.random((2, 6)) > 0.3
    if masked:
        x[~mask] = 1e4
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, f).astype(np.float32),
                            "bias": rng.normal(0, 0.1, f).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(0, 0.1, f).astype(np.float32),
                                 "var": rng.uniform(0.5, 1.5, f).astype(np.float32)}}
    jbn = JaxMaskedBatchNorm(momentum=0.9, epsilon=1e-5)
    ref, state = jbn.apply(variables, jnp.asarray(x), train=True, mask=jnp.asarray(mask) if masked else None,
                           mutable=["batch_stats"])
    bn = MaskedBatchNorm1d(f)
    bn.load_state_dict({"weight": torch.from_numpy(variables["params"]["scale"]),
                        "bias": torch.from_numpy(variables["params"]["bias"]),
                        "running_mean": torch.from_numpy(variables["batch_stats"]["mean"]),
                        "running_var": torch.from_numpy(variables["batch_stats"]["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    got = bn.train()(torch.from_numpy(x), mask=torch.from_numpy(mask) if masked else None)
    keep = mask if masked else np.ones_like(mask)
    np.testing.assert_allclose(got.detach().numpy()[keep], np.asarray(ref)[keep], rtol=0, atol=ABS_TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(state["batch_stats"]["mean"]), rtol=0, atol=ABS_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(state["batch_stats"]["var"]), rtol=0, atol=ABS_TOL)
    ev = jbn.apply({"params": variables["params"], "batch_stats": state["batch_stats"]}, jnp.asarray(x), train=False)
    with torch.no_grad():
        np.testing.assert_allclose(bn.eval()(torch.from_numpy(x)).numpy(), np.asarray(ev), rtol=1e-6, atol=ABS_TOL)
        frozen = bn.train()
        frozen.frozen = True
        before = bn.running_mean.clone()
        np.testing.assert_allclose(frozen(torch.from_numpy(x)).numpy(), np.asarray(ev), rtol=1e-6, atol=ABS_TOL)
        assert torch.equal(bn.running_mean, before)


def test_target_heatmaps_match_jax():
    jcfg, pcfg = tiny_configs()
    _, port, _ = build()
    rng = np.random.default_rng(5)
    t = rng.uniform(0, SIZE, (2, 4, K, 2)).astype(np.float32)
    cs = np.concatenate([rng.uniform(20, 100, (2, 4, 2)), rng.uniform(10, 80, (2, 4, 2))], -1).astype(np.float32)
    sig = rng.uniform(0, 0.1, (2, 4, K)).astype(np.float32)
    sig[0, 0, :3] = 0.0  # clipped at 1e-3
    areas = np.array([[0.0, 0.5, 900.0, 2500.0]] * 2, np.float32)  # a clipped at 1
    rx, ry = JaxDCC(jcfg).target_heatmaps(*(jnp.asarray(v) for v in (t, cs, sig, areas)))
    gx, gy = port.head["dcc"].target_heatmaps(*(torch.from_numpy(v) for v in (t, cs, sig, areas)))
    assert gx.shape == (2, 4, K, jcfg.num_bins[0]) and gy.shape == (2, 4, K, jcfg.num_bins[1])
    for g, r in ((gx, rx), (gy, ry)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=ABS_TOL)


# --------------------------------------------------------------------------- the criterion and one step
@pytest.fixture(scope="module", params=[0.5, 1.0], ids=["widen-0.5", "widen-1.0"])
def criterion_case(request):
    """JAX's train-mode raw outputs of the tiny model on two images, the
    targets, JAX's criterion on them and its assignment."""
    widen = request.param
    jmodel, port, flat = build(widen)
    x = np.random.default_rng(6).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    (_, jaux), _ = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=True, mutable=["batch_stats"]))(
        unflatten_tree(flat), jnp.asarray(x))
    targets = person_targets(7)
    v = unflatten_tree(flat)
    losses, dcc_state = jax.jit(lambda vv, a, t: jax_loss.rtmo_criterion(vv, a, t, jmodel.config))(
        v, jaux, jax_targets(targets))
    # JAX's assignment, from the same decode its criterion makes
    b, a, _ = jaux.cls_scores.shape
    xys = jaux.bbox_preds[..., :2] * jaux.strides[None, :, None] + jaux.priors[None]
    whs = jnp.exp(jnp.clip(jaux.bbox_preds[..., 2:], max=20.0)) * jaux.strides[None, :, None]
    boxes = jnp.concatenate([xys - whs / 2, xys + whs / 2], -1)
    kd = jaux.kpt_offsets.reshape(b, a, K, 2) * jaux.strides[None, :, None, None] + jaux.priors[None, :, None, :]
    pri4 = jnp.concatenate([jaux.priors, jaux.strides[:, None], jaux.strides[:, None]], -1)
    sc = jnp.sqrt(jax.nn.sigmoid(jnp.clip(jaux.cls_scores, -1e4, 1e4)))
    kv = jax.nn.sigmoid(jaux.kpt_vis)
    assign = jax.vmap(lambda s_, b_, k_, v_, g_: jax_loss.simota_assign_single(pri4, s_, b_, k_, v_, g_, jmodel.config))(
        sc, boxes, kd, kv, jax_targets(targets))
    aux = RTMOAuxOutputs(*(torch.from_numpy(np.array(getattr(jaux, f))) for f in (
        "cls_scores", "bbox_preds", "kpt_offsets", "kpt_vis", "pose_feats", "priors", "strides")))
    return dict(widen=widen, port=port, aux=aux, targets=targets, losses={k: float(v) for k, v in losses.items()},
                dcc_stats={k: np.asarray(v) for k, v in dcc_state["batch_stats"]["pose_to_kpts_bn"].items()},
                assign=[np.asarray(r) for r in assign])


def test_criterion_matches_jax(criterion_case):
    """The five losses and num_pos within 1e-5 rel on JAX's raw outputs, the
    port's assignment equal to JAX's, DCC's statistics moved as JAX's."""
    c = criterion_case
    dcc = c["port"].head["dcc"].train()
    losses, used = rtmo_criterion(dcc, c["aux"], port_targets(c["targets"]), c["port"].config)
    pos = c["assign"][0]
    assert pos.sum() > 0
    np.testing.assert_array_equal(used.pos_mask.numpy(), pos)
    np.testing.assert_array_equal(used.gt_idx.numpy()[pos], c["assign"][1][pos])
    np.testing.assert_allclose(used.matched_oks.numpy(), c["assign"][2], rtol=0, atol=ABS_TOL)
    assert sorted(losses) == LOSS_KEYS + ["total"]
    for k, v in c["losses"].items():
        np.testing.assert_allclose(float(losses[k].detach()), v, rtol=LOSS_RTOL, err_msg=k)
    bn = dcc.pose_to_kpts[1]
    np.testing.assert_allclose(bn.running_mean.numpy(), c["dcc_stats"]["mean"], rtol=0, atol=ABS_TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), c["dcc_stats"]["var"], rtol=0, atol=ABS_TOL)
    # a carried assignment gives the same losses and is returned as it is
    again, used2 = rtmo_criterion(dcc, c["aux"], port_targets(c["targets"]), c["port"].config, carried=used)
    assert used2 is used and all(float(again[k].detach()) == float(losses[k].detach()) for k in losses)


def test_mle_reaches_the_box_branch_and_the_sigma_head():
    """loss_mle alone: non-zero gradients at ``head.dcc.sigma_fc`` (the targets'
    normalization) and at the box outputs (the bins' placement)."""
    _, port, _ = build()
    x = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8))
    port.train()
    _, aux = port(x)
    losses, _ = rtmo_criterion(port.head["dcc"], aux, port_targets(person_targets(9)), port.config)
    losses["loss_mle"].backward()
    sigma = port.head["dcc"].sigma_fc[0].weight.grad
    boxes = [c.weight.grad for c in port.head["head_module"].out_bbox]
    assert sigma is not None and float(sigma.abs().max()) > 0
    assert all(g is not None for g in boxes) and max(float(g.abs().max()) for g in boxes) > 0


@pytest.mark.usefixtures("few_threads")
def test_train_step_matches_jax_in_fp64():
    """One step of the tiny rtmo-s (widen 0.5), both packages in fp64: every
    loss key, every gradient and every moved statistic (the backbone's,
    neck's and head's BatchNorms and DCC's masked one, which moves once)."""
    x = np.random.default_rng(10).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    targets = person_targets(11)
    with jax.enable_x64(True):
        jmodel, port, flat = build(dtype=jnp.float64)
        loss_fn = jax_loss.make_loss_fn(jmodel, jmodel.config)
        jv = unflatten_tree({k: v.astype(np.float64) for k, v in flat.items()})

        def total_fn(params):
            total, (losses, state) = loss_fn({"params": params, "batch_stats": jv["batch_stats"]},
                                             (jnp.asarray(x), jax_targets(targets)), jax.random.PRNGKey(0))
            return total, (losses, state)

        (total, (jlosses, state)), grads = jax.jit(jax.value_and_grad(total_fn, has_aux=True))(jv["params"])
        ref_grads = {k: np.asarray(v) for k, v in flatten_tree(grads, prefix="params/").items()}
        ref_stats = {k: np.asarray(v) for k, v in flatten_tree(state["batch_stats"], prefix="batch_stats/").items()}
        jlosses = {k: float(v) for k, v in jlosses.items()}
    port.double()
    set_compute_dtype(port, torch.float64)
    port.train()
    ptotal, plosses = make_loss_fn(port, port.config)(torch.from_numpy(x), port_targets(targets))
    ptotal.backward()
    assert sorted(plosses) == sorted(jlosses) == LOSS_KEYS
    for k, v in dict(jlosses, total=float(total)).items():
        got = float(ptotal.detach()) if k == "total" else float(plosses[k].detach())
        np.testing.assert_allclose(got, v, rtol=LOSS_RTOL, err_msg=k)
    from focoos_tpu_torch.utils.weights import to_jax_variables

    grads = to_jax_variables({n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
                              for n, p in port.named_parameters()}, "rtmo")
    assert sorted(grads) == sorted(ref_grads)
    for k, r in ref_grads.items():
        if k in ZERO_GRADS:
            assert np.abs(r).max() < 1e-6 and np.abs(grads[k]).max() < 1e-6, k
        else:
            np.testing.assert_allclose(grads[k], r, rtol=0, atol=GRAD_TOL * np.abs(r).max() + GRAD_FLOOR, err_msg=k)
    stats = {k: v for k, v in to_jax_variables({k: v.numpy() for k, v in port.state_dict().items()}, "rtmo").items()
             if k.startswith("batch_stats/")}
    assert sorted(stats) == sorted(ref_stats)
    for k, r in ref_stats.items():
        np.testing.assert_allclose(stats[k], r, rtol=0, atol=ABS_TOL, err_msg=k)


# --------------------------------------------------------------------------- weights, targets, solver, trainer
def test_weights_round_trip():
    """The trainer saves model_final.npz through ``to_jax_variables``: rtmo's
    tree equals ``torch_convert``'s, key for key and bit for bit, and
    ``from_jax_variables`` maps it back to the same state_dict."""
    from focoos_tpu_torch.utils.weights import to_jax_variables

    _, port, flat = build()
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = to_jax_variables(sd, "rtmo")
    assert sorted(back) == sorted(flat) and all(np.array_equal(back[k], flat[k]) for k in flat)
    again = from_jax_variables(back, "rtmo")
    assert sorted(again) == sorted(sd) and all(np.array_equal(again[k].numpy(), sd[k]) for k in sd)



def _entries(jax_package: bool, sizes, counts, seed: int):
    entry_cls, inst_cls, boxes_cls, kp_cls = (JaxDatasetEntry, JaxInstances, JaxBoxes, JaxKeypoints) if jax_package \
        else (DatasetEntry, Instances, Boxes, Keypoints)
    rng = np.random.default_rng(seed)
    out = []
    for (h, w), c in zip(sizes, counts):
        xy = rng.uniform(0, min(h, w) / 2, (c, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, min(h, w) / 2, (c, 2))], 1).astype(np.float32)
        kp = np.concatenate([rng.uniform(0, min(h, w), (c, K, 2)), rng.integers(0, 3, (c, K, 1))], -1).astype(np.float32)
        inst = inst_cls((h, w), boxes=boxes_cls(boxes), classes=np.zeros(c, np.int64), keypoints=kp_cls(kp))
        out.append(entry_cls(image=rng.integers(0, 256, (h, w, 3), dtype=np.uint8), height=h, width=w, instances=inst))
    return out


@pytest.mark.parametrize("sizes,counts,max_instances", [
    (((97, 75), (90, 81)), (3, 5), 100),
    (((64, 64), (61, 66)), (60, 0), 50),
], ids=["odd-sizes", "over-max-and-empty"])
def test_training_preprocess_matches_jax(sizes, counts, max_instances):
    """The padded batch (a multiple of 32) and every target field equal the
    JAX processor's; visible where the annotation's visibility > 0."""
    jcfg, pcfg = tiny_configs()
    jb, jt = JaxRTMOProcessor(jcfg).train(True).preprocess_entries(_entries(True, sizes, counts, 12), max_instances)
    pb, pt = RTMOProcessor(pcfg).train(True).preprocess_entries(_entries(False, sizes, counts, 12), max_instances)
    np.testing.assert_array_equal(pb, jb)
    assert pb.shape[1] % 32 == 0 and pb.shape[2] % 32 == 0
    for f in ("labels", "boxes", "keypoints", "keypoints_visible", "areas", "valid"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(jt, f)), err_msg=f)
    assert int(pt.valid.sum()) == sum(min(c, max_instances) for c in counts) and pt.labels.dtype == torch.int64
    assert isinstance(pt.to("cpu"), KeypointTargets)
    assert RTMOProcessor(pcfg).preprocess_entries(_entries(False, sizes, counts, 12))[1] is None


@pytest.mark.parametrize("freeze_bn", [False, True])
def test_solver_groups_match_jax(freeze_bn):
    """lr multiplier and weight decay of every rtmo parameter against JAX's
    leaf_hyperparams: ``head.dcc.*`` and ``head.head_module.*`` take the head
    multiplier; freeze_bn freezes the BatchNorms under JAX's ``/bn/`` only."""
    _, port, flat = build()
    names = [n for n, _ in port.named_parameters()]
    ids = {n: np.full(tuple(p.shape), i, np.float32) for i, (n, p) in enumerate(port.named_parameters())}
    source = {k: names[int(v.flat[0])] for k, v in
              _flat({"params": convert_state_dict(ids, "rtmo", verbose=False)[0]["params"]}).items()}
    kw = dict(base_wd=0.02, wd_norm=0.01, wd_embed=0.03, backbone_multiplier=0.1, decoder_multiplier=0.5,
              head_multiplier=2.0)
    lr_tree, wd_tree = leaf_hyperparams(unflatten_tree(flat)["params"], freeze_bn=freeze_bn, **kw)
    hp = param_hyperparams(port, freeze_bn=freeze_bn, **kw)
    assert sorted(source) == sorted(_flat({"params": lr_tree}))
    for i, ref_tree in enumerate((lr_tree, wd_tree)):
        for k, ref in _flat({"params": ref_tree}).items():
            assert hp[source[k]][i] == pytest.approx(float(ref), rel=1e-6), (k, source[k], i)
    assert hp["head.dcc.x_fc.weight"][0] == hp["head.head_module.out_cls.0.weight"][0] == 2.0


def _train_entries(n: int, seed: int):
    return _entries(False, [(SIZE, SIZE)] * n, [2, 1, 3, 2][:n] * (n // 4 + 1), seed)[:n]


@pytest.mark.usefixtures("few_threads")
def test_freeze_bn_keeps_every_statistic(tmp_path):
    """FocoosModel.train with freeze_bn: every BatchNorm, DCC's masked one
    included, normalizes with its running statistics in training, so none
    moves; the flags are cleared after training."""
    model = ModelManager.get("rtmo-s-coco", device="cpu", image_size=SIZE, **TINY)
    before = {k: v.clone() for k, v in model.module.state_dict().items() if "running" in k}
    model.train(TrainerArgs(run_name="f", output_dir=str(tmp_path), batch_size=2, max_iters=1, workers=0,
                            freeze_bn=True, checkpointer_period=1), _train_entries(4, 13))
    after = model.module.state_dict()
    assert "head.dcc.pose_to_kpts.1.running_mean" in before
    assert all(torch.equal(v, after[k]) for k, v in before.items())
    assert not any(m.frozen for m in model.module.modules() if isinstance(m, (BatchNorm, MaskedBatchNorm1d)))


@pytest.mark.usefixtures("few_threads")
def test_model_manager_train_two_steps(tmp_path):
    """ModelManager.get(..., device="cpu") → FocoosModel.train 2 steps with a
    validation (keypoints AP) → DCC's statistics moved, weights saved, the
    model serves with 17 keypoints a detection."""
    model = ModelManager.get("rtmo-s-coco", device="cpu", image_size=SIZE, **TINY)
    dcc_mean = model.module.head["dcc"].pose_to_kpts[1].running_mean.clone()
    res = model.train(TrainerArgs(run_name="r", output_dir=str(tmp_path), batch_size=2, max_iters=2, workers=0,
                                  eval_period=2, checkpointer_period=2, samples=0), _train_entries(4, 14),
                      _train_entries(2, 15))
    assert res["iterations"] == 2 and 0.0 <= res["metrics"]["keypoints"]["AP"] <= 100.0
    with open(os.path.join(res["run_dir"], "metrics.json")) as f:
        rows = [json.loads(line) for line in f]
    assert all(k in rows[-1] for k in ("loss_mle", "loss_oks", "num_pos", "total_loss"))
    assert not torch.equal(model.module.head["dcc"].pose_to_kpts[1].running_mean, dcc_mean)
    assert os.path.isfile(os.path.join(res["run_dir"], "model_final.npz"))
    det = model.infer(np.random.default_rng(16).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8), threshold=0.0)
    assert all(len(d.keypoints) == K for d in det.detections)
