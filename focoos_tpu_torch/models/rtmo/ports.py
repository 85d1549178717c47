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
