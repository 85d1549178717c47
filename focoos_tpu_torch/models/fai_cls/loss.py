"""fai_cls loss (port of focoos_tpu/models/fai_cls/loss.py; reference:
focoos/models/fai_cls/modelling.py:80-150 ClassificationLoss), in fp32.

The default is BCE-with-logits with ``pos_weight`` on the positive terms,
the mean over every element; ``use_focal_loss`` takes the focal loss with
label smoothing, ``p`` clipped at 1e-6, summed over the classes and averaged
over the batch.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from focoos_tpu_torch.models.fai_cls.config import ClassificationConfig
from focoos_tpu_torch.models.fai_cls.ports import ClassificationTargets


def classification_loss(logits: torch.Tensor, targets: ClassificationTargets,
                        cfg: ClassificationConfig) -> Dict[str, torch.Tensor]:
    logits = logits.float()
    t = targets.labels.float()
    if cfg.use_focal_loss:
        if cfg.label_smoothing > 0:
            t = t * (1 - cfg.label_smoothing) + cfg.label_smoothing / cfg.num_classes
        p = torch.sigmoid(logits).clamp(1e-6, 1.0)
        loss = -cfg.focal_alpha * torch.pow(1 - p, cfg.focal_gamma) * (t * torch.log(p) + (1 - t) * torch.log1p(-p))
        loss = loss.sum(1).mean()
    else:
        loss = -(cfg.pos_weight * t * F.logsigmoid(logits) + (1 - t) * F.logsigmoid(-logits)).mean()
    return {"loss_cls": loss}


def make_loss_fn(module, cfg: ClassificationConfig):
    """The per-step loss closure ``build_train_step`` takes: a train-mode
    forward (BatchNorms move their running statistics in place, dropout
    draws from a generator seeded with 0 on the images' device at the first
    call, as the JAX trainer's stream starts from ``PRNGKey(0)``) and the
    loss → (total, losses)."""
    generator = None

    def loss_fn(images: torch.Tensor, targets: ClassificationTargets):
        nonlocal generator
        if generator is None:
            generator = torch.Generator(device=images.device).manual_seed(0)
        out, _ = module(images, generator=generator)
        losses = classification_loss(out.logits, targets, cfg)
        return losses["loss_cls"], losses

    return loss_fn
