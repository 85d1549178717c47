"""Mask-classification criterion shared by fai_mf and bisenetformer.

Port of ``focoos_tpu/models/fai_mf/loss.py`` (itself a re-derivation of the
reference SetCriterion / MaskHungarianMatcher, focoos/models/fai_mf/loss.py:
345-756): the matching cost samples one uniform point set per image and
layer; the mask losses are PointRend-sampled (the most uncertain of 3x
oversampled uniform points, topped up with fresh ones); deep supervision
weighs every decoder layer. The targets arrive padded to [B, N] with a
validity mask and pre-resized to the mask features' grid, so sampling in
normalized coordinates keeps the loss's meaning.

The L+1 layers x B images of assignment problems are solved in one batched
auction (``ops/matching.py``), where JAX loops over the layers: the auction
asks the host every ``CHECK_EVERY`` rounds whether a problem still runs, so
ten calls would cost ten times the syncs. The draws come from an explicit
``torch.Generator`` on the model's device. ``CriterionDraws`` carries the
points and the assignment of another run in, so that two devices or two
packages can be compared on the same draws. Matching costs and point
selection carry no gradient (JAX's ``stop_gradient``); every loss is fp32.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from focoos_tpu_torch.models.fai_mf.config import MaskFormerConfig
from focoos_tpu_torch.models.fai_mf.ports import MaskFormerAuxOutputs, MaskFormerTargets
from focoos_tpu_torch.ops.matching import batched_auction_assign
from focoos_tpu_torch.ops.point_sample import point_sample, uncertainty_sampled_coords
from focoos_tpu_torch.parallel import mesh


@dataclass
class CriterionDraws:
    """What the criterion draws or solves, one entry per prediction layer:
    ``match_coords`` [L+1, B, 1, P, 2] (each image's matcher points),
    ``loss_coords`` [L+1, M, P, 2] (each matched pair's loss points, for the
    M valid (image, target) rows of the flattened [B·N] in ascending order:
    the criterion samples no padding row), ``assign`` [L+1, B, N] (the
    query of each target). A field that is set
    is taken as it is; with ``assign`` set, no matching runs."""

    match_coords: Optional[torch.Tensor] = None
    loss_coords: Optional[torch.Tensor] = None
    assign: Optional[torch.Tensor] = None

    def to(self, device) -> "CriterionDraws":
        return CriterionDraws(*(None if t is None else t.to(device)
                                for t in (self.match_coords, self.loss_coords, self.assign)))


def _pair_bce(out_pts: torch.Tensor, tgt_pts: torch.Tensor) -> torch.Tensor:
    """Pairwise mean BCE-with-logits cost [..., Q, P] x [..., N, P] → [..., Q, N]
    (reference batch_sigmoid_ce_loss :282)."""
    p = out_pts.shape[-1]
    pos = F.softplus(-out_pts)  # -log sigmoid(x)
    neg = F.softplus(out_pts)  # -log(1 - sigmoid(x))
    return (pos @ tgt_pts.transpose(-1, -2) + neg @ (1.0 - tgt_pts).transpose(-1, -2)) / p


def _pair_dice(out_pts: torch.Tensor, tgt_pts: torch.Tensor) -> torch.Tensor:
    """Pairwise dice cost [..., Q, P] x [..., N, P] → [..., Q, N] (reference batch_dice_loss :261)."""
    o = torch.sigmoid(out_pts)
    num = 2.0 * (o @ tgt_pts.transpose(-1, -2))
    den = o.sum(-1)[..., :, None] + tgt_pts.sum(-1)[..., None, :]
    return 1.0 - (num + 1.0) / (den + 1.0)


@torch.no_grad()
def match(aux: MaskFormerAuxOutputs, targets: MaskFormerTargets, cfg: MaskFormerConfig,
          coords: torch.Tensor) -> torch.Tensor:
    """The query assigned to each target in each layer → [L+1, B, N] (JAX
    ``_match_one_layer``), on the matcher points ``coords`` [L+1, B, 1, P, 2];
    all (L+1)·B problems in one batched auction. Undefined where not valid."""
    logits = aux.logits.float()  # [S, B, Q, C+1]
    s, b, q = logits.shape[:3]
    n = targets.labels.shape[1]
    probs = torch.sigmoid(logits) if cfg.cls_sigmoid else torch.softmax(logits, -1)
    cost_class = -torch.gather(probs, 3, targets.labels[None, :, None, :].expand(s, b, q, n))
    out_pts = point_sample(aux.masks.float(), coords)  # [S, B, Q, P]
    tgt_pts = point_sample(targets.masks.float().expand(s, -1, -1, -1, -1), coords)  # [S, B, N, P]
    c = (cfg.matcher_cost_mask * _pair_bce(out_pts, tgt_pts) + cfg.matcher_cost_class * cost_class
         + cfg.matcher_cost_dice * _pair_dice(out_pts, tgt_pts))
    valid = targets.valid.expand(s, -1, -1)
    return batched_auction_assign(c.transpose(-1, -2).reshape(s * b, n, q), valid.reshape(s * b, n)).reshape(s, b, n)


def _layer_losses(
    logits: torch.Tensor,  # [B, Q, C+1]
    masks: torch.Tensor,  # [B, Q, Hm, Wm]
    assign: torch.Tensor,  # [B, N]
    targets: MaskFormerTargets,
    rows: torch.Tensor,  # [M] the valid (image, target) rows of the flattened [B·N]
    num_masks: torch.Tensor,
    cfg: MaskFormerConfig,
    coords: Optional[torch.Tensor],  # [M, P, 2], or None to draw them
    generator: Optional[torch.Generator],
    span: Optional[Tuple[int, int]] = None,  # this rank's M rows among every rank's (mesh.row_span)
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One layer's unweighted losses (JAX ``_layer_losses``) → (losses, the
    valid rows' loss points)."""
    b, q, c1 = logits.shape
    n = targets.labels.shape[1]
    logits = logits.float()
    valid = targets.valid
    assign = torch.where(valid, assign, q)  # the dummy column for padding

    # classification (reference loss_labels :414-432)
    num_classes = c1 - 1
    tgt_cls = logits.new_full((b, q + 1), num_classes, dtype=torch.long)
    tgt_cls.scatter_(1, assign, torch.where(valid, targets.labels, num_classes))
    tgt_cls = tgt_cls[:, :q]
    empty_weight = logits.new_ones(c1)
    empty_weight[-1] = cfg.criterion_eos_coef
    w = empty_weight[tgt_cls]
    nll = -torch.gather(F.log_softmax(logits, -1), 2, tgt_cls[..., None])[..., 0]
    loss_ce = (w * nll).sum() / mesh.global_count(w.sum(), 1e-6)

    # mask losses on the matched pairs (reference loss_masks :465-527), on the valid rows only: JAX
    # samples every padding row too (static shapes) and weighs its terms by 0
    bi, ti = rows // n, rows % n
    src = masks[bi, assign[bi, ti]].float()  # [M, Hm, Wm]
    tgt = targets.masks[bi, ti].float()
    if coords is None:
        with torch.no_grad():
            coords = uncertainty_sampled_coords(generator, src.detach(), cfg.criterion_num_points, 3.0, 0.75, span)
    src_pts = point_sample(src, coords)  # [M, P]
    with torch.no_grad():
        tgt_pts = point_sample(tgt, coords)

    bce = F.softplus(-src_pts) * tgt_pts + F.softplus(src_pts) * (1.0 - tgt_pts)
    loss_mask = bce.mean(-1).sum() / num_masks
    o = torch.sigmoid(src_pts)
    num = 2.0 * (o * tgt_pts).sum(-1)
    den = o.sum(-1) + tgt_pts.sum(-1)
    loss_dice = (1.0 - (num + 1.0) / (den + 1.0)).sum() / num_masks
    return {"loss_ce": loss_ce, "loss_mask": loss_mask, "loss_dice": loss_dice}, coords


def maskformer_criterion(
    aux: MaskFormerAuxOutputs,
    targets: MaskFormerTargets,
    cfg: MaskFormerConfig,
    generator: Optional[torch.Generator] = None,
    carried: Optional[CriterionDraws] = None,
) -> Tuple[Dict[str, torch.Tensor], CriterionDraws]:
    """Deep-supervision criterion (reference SetCriterion.forward :552-608)
    → (weighted losses: the last layer's keys unsuffixed, layer i's
    ``<key>_i`` with ``criterion_deep_supervision``, and ``total``; the draws
    and assignment it used). Draws come from ``generator`` on the outputs'
    device (None: torch's default generator there), except what ``carried`` sets."""
    carried = carried or CriterionDraws()
    num_masks = mesh.global_count(targets.valid.float().sum(), 1.0)  # the global batch's, divided among the ranks
    s, b = aux.logits.shape[:2]
    used = replace(carried)
    if used.assign is None:
        if used.match_coords is None:
            # the global batch's draw, of which this rank keeps its images (rank r holds images r·b onward)
            used.match_coords = mesh.global_rand((s, b, 1, max(cfg.criterion_num_points, 1), 2), generator,
                                                 aux.logits.device, dim=1,
                                                 span=(mesh.get_rank() * b, mesh.get_world_size() * b))
        used.assign = match(aux, targets, cfg, used.match_coords)
    weights = {"loss_ce": cfg.weight_dict_loss_ce, "loss_mask": cfg.weight_dict_loss_mask,
               "loss_dice": cfg.weight_dict_loss_dice}
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    rows = targets.valid.reshape(-1).nonzero()[:, 0]  # one host sync a step, for every layer
    span = mesh.row_span(rows.shape[0], rows.device) if carried.loss_coords is None else None
    loss_coords = []
    for li in range(s):
        layer, coords = _layer_losses(
            aux.logits[li], aux.masks[li], used.assign[li], targets, rows, num_masks, cfg,
            None if carried.loss_coords is None else carried.loss_coords[li], generator, span)
        loss_coords.append(coords)
        is_last = li == s - 1
        for k, v in layer.items():
            v = v * weights[k]
            if is_last:
                losses[k] = v
            elif cfg.criterion_deep_supervision:
                losses[f"{k}_{li}"] = v
            if is_last or cfg.criterion_deep_supervision:
                total = total + v
    losses["total"] = total
    used.loss_coords = torch.stack(loss_coords)
    return losses, used


def make_loss_fn(module, cfg: MaskFormerConfig):
    """The per-step loss closure ``build_train_step`` takes: a train-mode
    forward (BatchNorms update their running statistics in place) and the
    criterion → (total, losses without "total"). The draws come from a
    generator seeded with 0 on the images' device at the first call, as the
    JAX trainer's stream starts from ``PRNGKey(0)`` and is not checkpointed."""
    generator = None

    def loss_fn(images: torch.Tensor, targets: MaskFormerTargets):
        nonlocal generator
        if generator is None:
            generator = torch.Generator(device=images.device).manual_seed(0)
        _, aux = module(images)
        losses, _ = maskformer_criterion(aux, targets, cfg, generator)
        total = losses.pop("total")
        return total, losses

    return loss_fn
