"""fai_detr training criterion: varifocal + box losses with on-device matching.

Port of ``focoos_tpu/models/fai_detr/loss.py`` (itself a re-derivation of the
reference SetCriterion/BoxHungarianMatcher, focoos/models/fai_detr/modelling.py:
409-769). Targets are padded to [B, N] with a validity mask; the assignment is
the auction (``ops/matching.py``) on the model's device. Deep supervision
stacks the decoder layers and the encoder top-k into one [L+1, B, ...] set
whose L+1 assignment problems per image are solved in one batched auction.
The matching cost and the varifocal IoU target carry no gradient (JAX's
``stop_gradient`` at :76, :95, :105); all loss arithmetic is fp32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from focoos_tpu_torch.models.fai_detr.config import DETRConfig
from focoos_tpu_torch.models.fai_detr.ports import DETRAuxOutputs, DETRTargets
from focoos_tpu_torch.ops.boxes import (
    box_cxcywh_to_xyxy,
    elementwise_box_iou,
    elementwise_generalized_box_iou,
    generalized_box_iou,
)
from focoos_tpu_torch.ops.matching import batched_auction_assign
from focoos_tpu_torch.parallel import mesh


def _focal_class_cost(p: torch.Tensor, alpha: float, gamma: float) -> torch.Tensor:
    """Focal matching cost (reference: fai_detr/modelling.py:730-734)."""
    neg = (1 - alpha) * torch.pow(p, gamma) * (-torch.log1p(-p + 1e-8))
    pos = alpha * torch.pow(1 - p, gamma) * (-torch.log(p + 1e-8))
    return pos - neg


@torch.no_grad()
def compute_cost_matrix(
    logits: torch.Tensor,  # [..., B, Q, C] raw
    boxes: torch.Tensor,  # [..., B, Q, 4] cxcywh
    targets: DETRTargets,
    cfg: DETRConfig,
) -> torch.Tensor:
    """→ [..., B, N, Q] matching cost (targets-major for the auction)."""
    probs = torch.sigmoid(logits.float())
    labels = targets.labels.expand(*probs.shape[:-2], -1)  # [..., B, N]
    p_t = torch.gather(probs, -1, labels[..., None, :].expand(*probs.shape[:-1], -1))  # [..., B, Q, N]
    cost_class = _focal_class_cost(p_t, cfg.matcher_alpha, cfg.matcher_gamma)
    boxes = boxes.float()
    cost_bbox = (boxes[..., :, None, :] - targets.boxes[..., None, :, :]).abs().sum(-1)  # [..., B, Q, N]
    cost_giou = -generalized_box_iou(box_cxcywh_to_xyxy(boxes), box_cxcywh_to_xyxy(targets.boxes))
    c = cfg.matcher_cost_bbox * cost_bbox + cfg.matcher_cost_class * cost_class + cfg.matcher_cost_giou * cost_giou
    return c.transpose(-1, -2)


def optax_sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically-stable BCE-with-logits, no reduction (optax's formula)."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def _layer_losses(
    logits: torch.Tensor,  # [S, B, Q, C], S prediction sets
    boxes: torch.Tensor,  # [S, B, Q, 4] cxcywh
    assign: torch.Tensor,  # [S, B, N] query index per target
    targets: DETRTargets,
    num_boxes: torch.Tensor,  # scalar, valid-target count (>= 1)
    cfg: DETRConfig,
) -> Dict[str, torch.Tensor]:
    """vfl/bbox/giou losses of each of the S matched prediction sets → {key: [S]}."""
    s, b, q, c = logits.shape
    logits, boxes = logits.float(), boxes.float()
    valid = targets.valid.expand(s, -1, -1)
    assign = torch.where(valid, assign, q)  # invalid → dummy column q
    valid_f = valid.float()

    # matched predictions per target
    padded = torch.cat([boxes, boxes.new_zeros((s, b, 1, 4))], 2)
    src_boxes = torch.gather(padded, 2, assign[..., None].expand(-1, -1, -1, 4))  # [S, B, N, 4]
    tgt_boxes = targets.boxes.expand(s, -1, -1, -1)

    # box losses (reference :513-530)
    loss_bbox = ((src_boxes - tgt_boxes).abs().sum(-1) * valid_f).sum((1, 2)) / num_boxes
    src_xyxy, tgt_xyxy = box_cxcywh_to_xyxy(src_boxes), box_cxcywh_to_xyxy(tgt_boxes)
    giou = elementwise_generalized_box_iou(src_xyxy, tgt_xyxy)
    loss_giou = ((1.0 - giou) * valid_f).sum((1, 2)) / num_boxes

    # varifocal loss (reference :464-497)
    ious = elementwise_box_iou(src_xyxy, tgt_xyxy).detach() * valid_f  # [S, B, N]
    onehot_n = F.one_hot(targets.labels, c).float() * targets.valid.float()[..., None]  # [B, N, C]
    onehot_n = onehot_n.expand(s, -1, -1, -1)
    idx = assign[..., None].expand(-1, -1, -1, c)
    t_onehot = logits.new_zeros((s, b, q + 1, c)).scatter_add_(2, idx, onehot_n)[:, :, :q]
    t_score = logits.new_zeros((s, b, q + 1, c)).scatter_add_(2, idx, onehot_n * ious[..., None])[:, :, :q]
    pred_score = torch.sigmoid(logits).detach()
    weight = cfg.criterion_focal_alpha * torch.pow(pred_score, cfg.criterion_focal_gamma) * (1 - t_onehot) + t_score
    loss_vfl = (optax_sigmoid_bce(logits, t_score) * weight).sum((1, 2, 3)) / num_boxes
    return {"loss_vfl": loss_vfl, "loss_bbox": loss_bbox, "loss_giou": loss_giou}


def _prediction_sets(aux: DETRAuxOutputs):
    """The decoder layers and the encoder top-k stacked: [L+1, B, Q, C], [L+1, B, Q, 4]."""
    return torch.cat([aux.dec_logits, aux.enc_logits[None]], 0), torch.cat([aux.dec_boxes, aux.enc_boxes[None]], 0)


@torch.no_grad()
def match(aux: DETRAuxOutputs, targets: DETRTargets, cfg: DETRConfig) -> torch.Tensor:
    """The query assigned to each target in each prediction set → [L+1, B, N]:
    all (L+1)·B problems in one batched auction."""
    all_logits, all_boxes = _prediction_sets(aux)
    cost = compute_cost_matrix(all_logits, all_boxes, targets, cfg)  # [L+1, B, N, Q]
    s, b, n, q = cost.shape
    valid = targets.valid.expand(s, -1, -1)
    return batched_auction_assign(cost.reshape(s * b, n, q), valid.reshape(s * b, n)).reshape(s, b, n)


def detr_criterion(
    aux: DETRAuxOutputs, targets: DETRTargets, cfg: DETRConfig, assign: Optional[torch.Tensor] = None
) -> Dict[str, torch.Tensor]:
    """Deep-supervision criterion (reference SetCriterion.forward :553-612):
    weighted losses, the last decoder layer unsuffixed, the other decoder
    layers suffixed ``_i``, the encoder selection ``_enc``, plus ``total``.
    ``assign`` ([L+1, B, N], from ``match``) skips the matching, so that two
    runs can be compared on one assignment."""
    num_boxes = mesh.global_count(targets.valid.float().sum(), 1.0)  # the global batch's, divided among the ranks
    if assign is None:
        assign = match(aux, targets, cfg)
    all_logits, all_boxes = _prediction_sets(aux)
    per_layer = _layer_losses(all_logits, all_boxes, assign, targets, num_boxes, cfg)

    weights = {
        "loss_vfl": cfg.weight_dict_loss_vfl,
        "loss_bbox": cfg.weight_dict_loss_bbox,
        "loss_giou": cfg.weight_dict_loss_giou,
    }
    num_dec = aux.dec_logits.shape[0]
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    for k, w in weights.items():
        vals = per_layer[k] * w  # [L+1]
        losses[k] = vals[num_dec - 1]
        if cfg.criterion_deep_supervision:
            for i in range(num_dec - 1):
                losses[f"{k}_{i}"] = vals[i]
            losses[f"{k}_enc"] = vals[num_dec]
            total = total + vals.sum()
        else:
            total = total + vals[num_dec - 1]
    losses["total"] = total
    return losses


def make_loss_fn(module, cfg: DETRConfig):
    """The per-step loss closure ``build_train_step`` takes: a train-mode
    forward (BatchNorms update their running statistics in place) and the
    criterion → (total, losses without "total")."""

    def loss_fn(images: torch.Tensor, targets: DETRTargets):
        _, aux = module(images)
        losses = detr_criterion(aux, targets, cfg)
        total = losses.pop("total")
        return total, losses

    return loss_fn
