"""fai_detr (RT-DETR) typed config (port of focoos_tpu/models/fai_detr/config.py;
reference: focoos/models/fai_detr/config.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from focoos_tpu_torch.ports import ModelConfig
from focoos_tpu_torch.nn.backbone.base import BackboneConfig


@dataclass
class DETRConfig(ModelConfig):
    backbone_config: BackboneConfig = None  # type: ignore[assignment]

    num_queries: int = 300
    resolution: Optional[int] = None

    pixel_mean: List[float] = field(default_factory=lambda: [123.675, 116.28, 103.53])
    pixel_std: List[float] = field(default_factory=lambda: [58.395, 57.12, 57.375])
    size_divisibility: int = 0

    pixel_decoder_out_dim: int = 256
    pixel_decoder_feat_dim: int = 256
    pixel_decoder_num_encoder_layers: int = 1
    pixel_decoder_expansion: float = 1.0
    pixel_decoder_dim_feedforward: int = 1024
    transformer_predictor_out_dim: int = 256
    transformer_predictor_hidden_dim: int = 256
    transformer_predictor_dec_layers: int = 6
    transformer_predictor_dim_feedforward: int = 1024
    head_out_dim: int = 256

    pixel_decoder_dropout: float = 0.0
    pixel_decoder_nhead: int = 8
    transformer_predictor_nhead: int = 8

    threshold: float = 0.5
    top_k: int = 300

    criterion_deep_supervision: bool = True
    criterion_eos_coef: float = 0.1
    criterion_losses: List[str] = field(default_factory=lambda: ["vfl", "boxes"])
    criterion_num_points: int = 0
    criterion_focal_alpha: float = 0.75
    criterion_focal_gamma: float = 2.0

    weight_dict_loss_vfl: float = 1
    weight_dict_loss_bbox: float = 5
    weight_dict_loss_giou: float = 2

    matcher_cost_class: float = 2
    matcher_cost_bbox: float = 5
    matcher_cost_giou: float = 2
    matcher_use_focal_loss: bool = True
    matcher_alpha: float = 0.25
    matcher_gamma: float = 2.0
