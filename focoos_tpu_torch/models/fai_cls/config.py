"""fai_cls typed config (port of focoos_tpu/models/fai_cls/config.py;
reference: focoos/models/fai_cls/config.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from focoos_tpu_torch.nn.backbone.base import BackboneConfig
from focoos_tpu_torch.ports import ModelConfig


@dataclass
class ClassificationConfig(ModelConfig):
    backbone_config: BackboneConfig = None  # type: ignore[assignment]

    resolution: int = 224
    pixel_mean: List[float] = field(default_factory=lambda: [123.675, 116.28, 103.53])
    pixel_std: List[float] = field(default_factory=lambda: [58.395, 57.12, 57.375])

    hidden_dim: int = 512
    dropout_rate: float = 0.2
    features: str = "res5"
    num_layers: int = 1
    dense_prediction: bool = False

    use_focal_loss: bool = False
    focal_alpha: float = 0.75
    focal_gamma: float = 2.0
    label_smoothing: float = 0.0
    pos_weight: float = 10.0

    threshold: float = 0.5
