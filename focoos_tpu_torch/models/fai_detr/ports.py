"""fai_detr output containers (port of focoos_tpu/models/fai_detr/ports.py;
reference: focoos/models/fai_detr/ports.py). Plain dataclasses of torch tensors."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from focoos_tpu.ports import ModelOutput


@dataclass
class DETRModelOutput(ModelOutput):
    """Inference output: boxes [B, Q, 4] xyxy normalized to [0, 1];
    logits [B, Q, C] sigmoided scores."""

    boxes: torch.Tensor
    logits: torch.Tensor
    loss: Optional[dict] = None


@dataclass
class DETRAuxOutputs:
    """Raw decoder outputs: ``dec_logits``/``dec_boxes`` stacked over decoder
    layers [L, B, Q, ...] (boxes cxcywh, logits pre-sigmoid); ``enc_logits``/
    ``enc_boxes`` are the encoder top-k selection head outputs."""

    dec_logits: torch.Tensor  # [L, B, Q, C]
    dec_boxes: torch.Tensor  # [L, B, Q, 4] cxcywh
    enc_logits: torch.Tensor  # [B, Q, C]
    enc_boxes: torch.Tensor  # [B, Q, 4] cxcywh (sigmoided)
