"""fai_cls output and target containers (port of focoos_tpu/models/fai_cls/ports.py;
reference: focoos/models/fai_cls/ports.py). Plain dataclasses of torch tensors."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from focoos_tpu_torch.ports import ModelOutput


@dataclass
class ClassificationModelOutput(ModelOutput):
    """logits [B, num_classes] fp32, raw (before the sigmoid)."""

    logits: torch.Tensor
    loss: Optional[dict] = None


@dataclass
class ClassificationTargets:
    """One-hot (multi-)labels [B, num_classes] fp32."""

    labels: torch.Tensor

    def to(self, device, non_blocking: bool = False) -> "ClassificationTargets":
        return ClassificationTargets(self.labels.to(device, non_blocking=non_blocking))

    def pin_memory(self) -> "ClassificationTargets":
        """A page-locked copy, which the DataLoader's pin thread asks for (it
        pins only the types it knows), so the copy to the card is asynchronous."""
        return ClassificationTargets(self.labels.pin_memory())


@dataclass
class ClassificationDecode:
    """The device half of the evaluation decode: sigmoid probabilities [B, num_classes] fp32."""

    probs: torch.Tensor
