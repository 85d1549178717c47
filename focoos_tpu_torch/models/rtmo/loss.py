"""rtmo training criterion: SimOTA assignment and the IoU, visibility, OKS,
MLE and varifocal losses.

Port of ``focoos_tpu/models/rtmo/loss.py`` (itself a re-derivation of the
reference, focoos/models/rtmo/loss.py and RTMOHead.loss/_get_targets,
modelling.py:942-1355) with its static shapes and exact semantics:

- SimOTA runs on the dense [B, A, N] prior x gt grid of every image at once
  (JAX ``vmap``s its per-image function): a pair outside the strict in-box
  AND in-centre test costs +1e5 but stays assignable; only pairs whose prior
  lies in no gt box and no centre region are excluded (cost 1e8). Each gt's
  dynamic k is the truncated sum of its top-10 OKS over every such valid
  prior, clipped to [1, 10]; its k cheapest priors are marked (ties in
  ``jax.lax.top_k``'s order); a prior marked by several gts keeps the one of
  least cost (the first on ties). With ``widen_factor == 0.5`` (rtmo-s) the
  centre region is around the visible keypoints' mean.
- Up to ``p_max`` positives per image are gathered into fixed slots (by
  matched OKS, ``jax.lax.top_k``'s tie order); DCC runs once a step on them,
  its BatchNorm statistics taken over the valid slots only.
- Only the assignment is detached: the MLE loss reaches the box branch
  through the bins' placement and the sigma head through the targets'
  normalization, as the reference's does. DCC computes here in its
  parameters' dtype (fp32 in a bf16 model too), as the JAX criterion builds
  it without a dtype and flax promotes to the parameters'; every loss is fp32.

``Assignment`` carries another run's SimOTA result in, so that two devices
can be compared on one assignment. The SimOTA and the losses are plain
PyTorch, as they are plain XLA in the JAX package: no TPU kernel backs them.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from focoos_tpu_torch.models.rtmo.config import RTMOConfig
from focoos_tpu_torch.models.rtmo.ports import KeypointTargets, RTMOAuxOutputs
from focoos_tpu_torch.nn.layers.common import ComputeDtype
from focoos_tpu_torch.ops.boxes import box_iou, elementwise_box_iou
from focoos_tpu_torch.ops.topk import topk_lowest_index_first
from focoos_tpu_torch.parallel import mesh

INF = 1e8
EPS = 1e-7
SOFT_PENALTY = 1e5  # the reference's INF (loss.py:15): penalizes a pair, does not exclude it
CANDIDATE_TOPK = 10

COCO_SIGMAS = (0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072, 0.062,
               0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089)


def kpt_sigmas(k: int, device=None) -> torch.Tensor:
    return torch.tensor(COCO_SIGMAS if k == 17 else (0.05,) * k, dtype=torch.float32, device=device)


@dataclass
class Assignment:
    """SimOTA's result for a batch: ``pos_mask`` [B, A] bool, ``gt_idx``
    [B, A] int64 (the matched gt where positive), ``matched_oks`` [B, A]
    fp32 (0 at negatives)."""

    pos_mask: torch.Tensor
    gt_idx: torch.Tensor
    matched_oks: torch.Tensor

    def to(self, device) -> "Assignment":
        return Assignment(*(t.to(device) for t in (self.pos_mask, self.gt_idx, self.matched_oks)))


def pairwise_oks(kpts: torch.Tensor, gt_kpts: torch.Tensor, gt_vis: torch.Tensor,
                 gt_areas: torch.Tensor) -> torch.Tensor:
    """[..., A, K, 2] x [..., N, K, 2] → [..., A, N] OKS (reference PoseOKS :312-358)."""
    k = kpts.shape[-2]
    d = torch.sqrt((kpts[..., :, None, :, :] - gt_kpts[..., None, :, :, :]).square().sum(-1) + 1e-12)  # [.., A, N, K]
    a = torch.sqrt(gt_areas.clamp(min=EPS))[..., None, :, None]
    d = d / a / (kpt_sigmas(k, kpts.device) * 2)
    w = gt_vis / gt_vis.sum(-1, keepdim=True).clamp(min=EPS)  # [..., N, K]
    return (torch.exp(-d.clamp(max=50.0).square() / 2) * w[..., None, :, :]).sum(-1)


@torch.no_grad()
def simota_assign(
    priors: torch.Tensor,  # [A, 4] (cx, cy, sx, sy)
    scores: torch.Tensor,  # [B, A, C] sqrt(sigmoid(cls) * objectness)
    boxes: torch.Tensor,  # [B, A, 4] decoded xyxy
    kpts: torch.Tensor,  # [B, A, K, 2] decoded
    gt: KeypointTargets,  # [B, N, ...] padded
    cfg: RTMOConfig,
    candidate_topk: int = CANDIDATE_TOPK,
) -> Assignment:
    """SimOTA for every image at once (JAX ``simota_assign_single`` under ``vmap``)."""
    b, a = scores.shape[:2]
    n = gt.labels.shape[1]
    gvalid = gt.valid[:, None, :]  # [B, 1, N]
    px, py = priors[None, :, 0:1], priors[None, :, 1:2]  # [1, A, 1]
    sx, sy = priors[None, :, 2:3], priors[None, :, 3:4]
    gb = gt.boxes[:, None]  # [B, 1, N, 4]

    # in-gt-box test (reference get_in_gt_and_in_center_info :545)
    in_gt = (px - gb[..., 0] > 0) & (py - gb[..., 1] > 0) & (gb[..., 2] - px > 0) & (gb[..., 3] - py > 0)
    # the centre: the visible keypoints' mean for rtmo-s, else the box's
    cx = (gt.boxes[..., 0] + gt.boxes[..., 2]) / 2
    cy = (gt.boxes[..., 1] + gt.boxes[..., 3]) / 2
    if cfg.widen_factor == 0.5:  # use_keypoints_for_center
        vis = gt.keypoints_visible
        vs = vis.sum(-1).clamp(min=EPS)
        has = vis.sum(-1) > 0
        cx = torch.where(has, (gt.keypoints[..., 0] * vis).sum(-1) / vs, cx)
        cy = torch.where(has, (gt.keypoints[..., 1] * vis).sum(-1) / vs, cy)
    cx, cy = cx[:, None], cy[:, None]  # [B, 1, N]
    r = 2.5
    in_ct = (px - (cx - r * sx) > 0) & (py - (cy - r * sy) > 0) & ((cx + r * sx) - px > 0) & ((cy + r * sy) - py > 0)
    in_gt = in_gt & gvalid
    in_ct = in_ct & gvalid
    # a prior is valid if it lies in ANY gt box or ANY centre region (reference loss.py:463-478); a pair failing
    # the strict in-box-and-in-centre test is penalized, not excluded
    valid_prior = (in_gt | in_ct).any(2)  # [B, A]
    both = in_gt & in_ct
    pair_valid = valid_prior[..., None] & gvalid  # [B, A, N]

    iou, _ = box_iou(boxes, gt.boxes)  # [B, A, N]
    oks = pairwise_oks(kpts, gt.keypoints, gt.keypoints_visible, gt.areas)

    # classification BCE cost over the classes (reference :503-517)
    onehot = F.one_hot(gt.labels, scores.shape[-1]).float()[:, None]  # [B, 1, N, C]
    s = scores.float().clamp(EPS, 1 - EPS)[:, :, None]  # [B, A, 1, C]
    cls_cost = (-(onehot * torch.log(s) + (1 - onehot) * torch.log1p(-s))).sum(-1)  # [B, A, N]

    cost = 3.0 * (-torch.log(iou + EPS)) + 3.0 * (-torch.log(oks + EPS)) + 1.0 * cls_cost + torch.where(
        both, 0.0, SOFT_PENALTY)
    cost = torch.where(pair_valid, cost, INF)

    # dynamic k: the truncated sum of each gt's top-10 OKS over every valid prior (indicator 'oks', :606-614)
    metric = torch.where(pair_valid, oks, 0.0).transpose(1, 2)  # [B, N, A]
    top_metric = torch.topk(metric, min(candidate_topk, a), dim=-1).values
    dynamic_k = top_metric.sum(-1).to(torch.int64).clamp(1, candidate_topk)  # [B, N]

    # each gt marks its dynamic_k cheapest priors (penalized pairs selectable, excluded ones never)
    neg_cost, idx = topk_lowest_index_first(-cost.transpose(1, 2), candidate_topk, dim=-1)  # [B, N, topk]
    rank_ok = torch.arange(candidate_topk, device=cost.device) < dynamic_k[..., None]
    picked = rank_ok & (-neg_cost < INF / 2) & gt.valid[..., None]
    matching = torch.zeros((b, n, a), dtype=torch.bool, device=cost.device).scatter_(2, idx, picked)
    matching = matching.transpose(1, 2)  # [B, A, N]

    # a prior matched to several gts keeps the cheapest (:636-640), the first on ties
    multi = matching.sum(2) > 1
    only_best = F.one_hot(cost.argmin(2), n).bool()
    matching = torch.where(multi[..., None], matching & only_best, matching)

    pos_mask = matching.any(2)
    gt_idx = matching.to(torch.uint8).argmax(2)
    matched_oks = torch.gather(oks, 2, gt_idx[..., None])[..., 0]
    return Assignment(pos_mask, gt_idx, torch.where(pos_mask, matched_oks, 0.0))


def _gather_positives(assign: Assignment, p_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``p_max`` positives per image, the best matched OKS first (ties
    lower prior first, as ``jax.lax.top_k``) → (prior index [B, P], valid [B, P])."""
    score = torch.where(assign.pos_mask, assign.matched_oks + 1.0, 0.0)
    vals, sel = topk_lowest_index_first(score, p_max, dim=-1)
    return sel, vals > 0


@contextlib.contextmanager
def _computing_in_param_dtype(module: torch.nn.Module):
    """``module``'s ComputeDtype layers in its parameters' dtype within the
    block (the JAX criterion builds DCC without a dtype: flax promotes a bf16
    input to the fp32 parameters)."""
    dtype = next(module.parameters()).dtype
    layers = [m for m in module.modules() if isinstance(m, ComputeDtype)]
    saved = [m.compute_dtype for m in layers]
    for m in layers:
        m.compute_dtype = dtype
    try:
        yield
    finally:
        for m, dt in zip(layers, saved):
            m.compute_dtype = dt


def decode(aux: RTMOAuxOutputs, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(boxes [B, A, 4] xyxy, keypoints [B, A, K, 2]) in absolute pixels
    (reference decode_bbox / decode_kpt_reg), box sizes clipped at exp(20)."""
    b, a = aux.bbox_preds.shape[:2]
    st = aux.strides[None, :, None]
    xys = aux.bbox_preds[..., :2] * st + aux.priors[None]
    whs = torch.exp(aux.bbox_preds[..., 2:].clamp(max=20.0)) * st
    boxes = torch.cat([xys - whs / 2, xys + whs / 2], dim=-1)
    kpts = aux.kpt_offsets.reshape(b, a, k, 2) * aux.strides[None, :, None, None] + aux.priors[None, :, None, :]
    return boxes, kpts


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, A, ...] at idx [B, P] → [B, P, ...]."""
    return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(-1, -1, *x.shape[2:]))


def rtmo_criterion(
    dcc: torch.nn.Module,
    aux: RTMOAuxOutputs,
    targets: KeypointTargets,
    cfg: RTMOConfig,
    p_max: int = 96,
    carried: Optional[Assignment] = None,
) -> Tuple[Dict[str, torch.Tensor], Assignment]:
    """→ (``loss_bbox``, ``loss_vis``, ``loss_oks``, ``loss_mle``,
    ``loss_cls``, ``num_pos`` and their ``total``; the assignment used: its
    own SimOTA's, or ``carried``). ``dcc`` (the model's ``head["dcc"]``, in
    train mode) moves its running statistics once here."""
    b, a, c = aux.cls_scores.shape
    k = cfg.num_keypoints
    p_max = min(p_max, a)
    boxes, kpt_dec = decode(aux, k)

    if carried is None:
        priors4 = torch.cat([aux.priors, aux.strides[:, None], aux.strides[:, None]], dim=-1)
        assign_scores = torch.sqrt(torch.sigmoid(aux.cls_scores.clamp(-1e4, 1e4)))  # objectness ≡ 1 (reference :1076)
        carried = simota_assign(priors4, assign_scores.detach(), boxes.detach(), kpt_dec.detach(), targets, cfg)
    assign = carried
    with torch.no_grad():
        sel, sel_valid = _gather_positives(assign, p_max)
        sel_gt = torch.gather(assign.gt_idx, 1, sel)  # [B, P] the gt of each slot
    # the normalizers are the global batch's, divided among the ranks; num_pos, logged, the global count
    num_pos = mesh.global_sum(assign.pos_mask.float().sum())
    num_total = mesh.global_count(assign.pos_mask.float().sum(), 1.0)
    vf = sel_valid.float()
    n_slots = mesh.global_count(vf.sum(), 1.0)

    p_boxes = _take(boxes, sel)  # [B, P, 4]
    p_kpts = _take(kpt_dec, sel)  # [B, P, K, 2]
    p_kvis_logits = _take(aux.kpt_vis, sel)
    p_pose = _take(aux.pose_feats, sel)
    p_prior = aux.priors[sel]
    t_boxes = _take(targets.boxes, sel_gt)
    t_kpts = _take(targets.keypoints, sel_gt)
    t_vis = _take(targets.keypoints_visible, sel_gt)
    t_areas = torch.gather(targets.areas, 1, sel_gt)

    losses: Dict[str, torch.Tensor] = {}
    # box IoU loss (square mode, weight 5, over num_total; reference :666-729)
    iou = elementwise_box_iou(p_boxes.float(), t_boxes).clamp(min=1e-16)
    losses["loss_bbox"] = 5.0 * ((1.0 - iou.square()) * vf).sum() / num_total

    # keypoint visibility BCE (weight 1, the mean)
    bce = (F.softplus(-p_kvis_logits) * t_vis + F.softplus(p_kvis_logits) * (1 - t_vis)).clamp(0, 50)
    losses["loss_vis"] = (bce * vf[..., None]).sum() / mesh.global_count(vf.sum() * k, 1.0)

    # OKS loss (linear, normalized weights, weight 30, the mean over positives)
    d = torch.sqrt((p_kpts.float() - t_kpts).square().sum(-1) + 1e-12)  # [B, P, K]
    d = d / torch.sqrt(t_areas.clamp(min=1e-8))[..., None] / (kpt_sigmas(k, d.device) * 2)
    per_kpt_oks = torch.exp(-d.clamp(max=50.0).square() / 2)
    oks_val = (per_kpt_oks * (t_vis / t_vis.sum(-1, keepdim=True).clamp(min=1e-8))).sum(-1)
    losses["loss_oks"] = 30.0 * ((1.0 - oks_val) * vf).sum() / n_slots

    # MLE coordinate-classification loss through DCC (weight 1): the gradient reaches the box branch
    # (bbox_cs) and the sigma head (the targets' normalization), as the reference's (modelling.py:1002-1008)
    bbox_cs = torch.cat([(p_boxes[..., 2:] + p_boxes[..., :2]) * 0.5, (p_boxes[..., 2:] - p_boxes[..., :2]) * 1.25],
                        dim=-1).float()
    with _computing_in_param_dtype(dcc):
        _, (px_prob, py_prob), sigmas = dcc(p_pose, bbox_cs, p_prior.float(), mask=sel_valid)
    hm_x, hm_y = dcc.target_heatmaps(t_kpts, bbox_cs, sigmas, t_areas)
    prob = (px_prob * hm_x).sum(-1) * (py_prob * hm_y).sum(-1)  # [B, P, K]
    mle = torch.nan_to_num(-torch.log(prob + 1e-4)) * t_vis
    losses["loss_mle"] = (mle.mean(-1) * vf).sum() / n_slots

    # varifocal classification loss over every prior (weight 1, over num_total)
    with torch.no_grad():
        onehot_t = F.one_hot(torch.gather(targets.labels, 1, assign.gt_idx), c).float()
        # matched_oks is exactly 0 at negatives: clip before the power, whose derivative is infinite at 0
        oks_pow = torch.pow(assign.matched_oks.clamp(1e-12, 1.0), cfg.overlaps_power)
        cls_t = torch.where(assign.pos_mask[..., None], onehot_t * oks_pow[..., None], 0.0)
        label = (cls_t > 1e-4).float()
    logits = aux.cls_scores.clamp(-10.0, 10.0)
    weight = 0.75 * torch.sigmoid(logits).square() * (1 - label) + cls_t
    vfl = (F.softplus(-logits) * cls_t + F.softplus(logits) * (1 - cls_t)) * weight
    losses["loss_cls"] = torch.nan_to_num(vfl).sum() / num_total

    losses["num_pos"] = num_pos
    losses["total"] = sum(v for name, v in losses.items() if name.startswith("loss_"))
    return losses, assign


def make_loss_fn(module, cfg: RTMOConfig):
    """The per-step loss closure ``build_train_step`` takes: a train-mode
    forward to the raw outputs (BatchNorms move their statistics in place),
    then the criterion, whose DCC call moves DCC's statistics → (total,
    losses without "total")."""
    dcc = module.head["dcc"]

    def loss_fn(images: torch.Tensor, targets: KeypointTargets):
        _, aux = module(images)
        losses, _ = rtmo_criterion(dcc, aux, targets, cfg)
        total = losses.pop("total")
        return total, losses

    return loss_fn
