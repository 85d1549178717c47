"""fai_mf output containers (port of focoos_tpu/models/fai_mf/ports.py;
reference: focoos/models/fai_mf/ports.py). Plain dataclasses of torch
tensors; bisenetformer shares them."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from focoos_tpu_torch.ports import ModelOutput


@dataclass
class MaskFormerModelOutput(ModelOutput):
    """masks [B, Q, H, W] sigmoided (at the input's size in eval; in the
    compute dtype, as the JAX package's); logits [B, Q, C] fp32 class
    probabilities without the no-object column."""

    masks: torch.Tensor
    logits: torch.Tensor
    loss: Optional[dict] = None


@dataclass
class MaskFormerAuxOutputs:
    """Per-layer raw outputs, fp32: logits [L+1, B, Q, C+1], masks
    [L+1, B, Q, Hm, Wm] (before the sigmoid, at the mask features' size);
    ``allowed``: each decoder layer's boolean cross-attention mask
    [B, 1, Q, h·w], True where a key was allowed."""

    logits: torch.Tensor
    masks: torch.Tensor
    allowed: Optional[List[torch.Tensor]] = None


@dataclass
class MaskFormerTargets:
    """Padded, batched training targets: ``labels`` [B, N] int64, ``masks``
    [B, N, Hm, Wm] fp32 at the mask features' grid, ``valid`` [B, N] bool
    (padding rows False)."""

    labels: torch.Tensor
    masks: torch.Tensor
    valid: torch.Tensor

    def to(self, device, non_blocking: bool = False) -> "MaskFormerTargets":
        return MaskFormerTargets(*(t.to(device, non_blocking=non_blocking) for t in (self.labels, self.masks, self.valid)))

    def pin_memory(self) -> "MaskFormerTargets":
        """Page-locked copies, which the DataLoader's pin thread asks for: the
        masks (~26 MB an image at 1024²) then copy to the card asynchronously."""
        return MaskFormerTargets(*(t.pin_memory() for t in (self.labels, self.masks, self.valid)))
