"""rtmo output containers (port of focoos_tpu/models/rtmo/ports.py;
reference: focoos/models/rtmo/ports.py). Plain dataclasses of torch tensors.

Every array is static [B, D, ...]: suppressed or empty slots carry score 0
(``valid = scores > 0``), in place of the reference's ragged post-NMS lists.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from focoos_tpu_torch.ports import ModelOutput


@dataclass
class RTMOModelOutput(ModelOutput):
    scores: torch.Tensor  # [B, D]
    labels: torch.Tensor  # [B, D]
    boxes: torch.Tensor  # [B, D, 4] xyxy abs (input-resolution pixels)
    boxes_scores: torch.Tensor  # [B, D]
    keypoints: torch.Tensor  # [B, D, K, 2] abs pixels
    keypoints_scores: torch.Tensor  # [B, D, K]
    keypoints_visible: torch.Tensor  # [B, D, K]
    loss: Optional[dict] = None


@dataclass
class RTMOAuxOutputs:
    """Raw flattened per-anchor predictions (levels P16 then P32, row-major)."""

    cls_scores: torch.Tensor  # [B, A, C] raw
    bbox_preds: torch.Tensor  # [B, A, 4] raw (dx, dy, logw, logh)
    kpt_offsets: torch.Tensor  # [B, A, K*2] raw
    kpt_vis: torch.Tensor  # [B, A, K] raw
    pose_feats: torch.Tensor  # [B, A, C_pose]
    priors: torch.Tensor  # [A, 2]
    strides: torch.Tensor  # [A]


@dataclass
class KeypointTargets:
    """Padded, batched training targets: ``labels`` [B, N] int64, ``boxes``
    [B, N, 4] xyxy abs, ``keypoints`` [B, N, K, 2] abs, ``keypoints_visible``
    [B, N, K] fp32 (1 where the annotation's visibility > 0), ``areas`` [B, N]
    (the boxes' w·h), ``valid`` [B, N] bool (padding rows False)."""

    labels: torch.Tensor
    boxes: torch.Tensor
    keypoints: torch.Tensor
    keypoints_visible: torch.Tensor
    areas: torch.Tensor
    valid: torch.Tensor

    def _fields(self):
        return (self.labels, self.boxes, self.keypoints, self.keypoints_visible, self.areas, self.valid)

    def to(self, device, non_blocking: bool = False) -> "KeypointTargets":
        return KeypointTargets(*(t.to(device, non_blocking=non_blocking) for t in self._fields()))

    def pin_memory(self) -> "KeypointTargets":
        """Page-locked copies, which the DataLoader's pin thread asks for (it
        pins only the types it knows), so the copy to the card is asynchronous."""
        return KeypointTargets(*(t.pin_memory() for t in self._fields()))
