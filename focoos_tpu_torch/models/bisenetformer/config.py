"""bisenetformer typed config (port of focoos_tpu/models/bisenetformer/config.py;
reference: focoos/models/bisenetformer/config.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from focoos_tpu_torch.nn.backbone.base import BackboneConfig
from focoos_tpu_torch.ports import ModelConfig


@dataclass
class BisenetFormerConfig(ModelConfig):
    backbone_config: BackboneConfig = None  # type: ignore[assignment]

    num_queries: int = 100
    resolution: int = 640

    pixel_mean: List[float] = field(default_factory=lambda: [123.675, 116.28, 103.53])
    pixel_std: List[float] = field(default_factory=lambda: [58.395, 57.12, 57.375])
    size_divisibility: int = 0

    pixel_decoder_out_dim: int = 256
    pixel_decoder_feat_dim: int = 256

    transformer_predictor_out_dim: int = 256
    transformer_predictor_hidden_dim: int = 256
    transformer_predictor_dec_layers: int = 6
    transformer_predictor_dim_feedforward: int = 1024
    head_out_dim: int = 256
    cls_sigmoid: bool = False

    postprocessing_type: str = "semantic"
    mask_threshold: float = 0.5
    predict_all_pixels: bool = False
    use_mask_score: bool = False
    threshold: float = 0.5
    top_k: int = 100

    criterion_deep_supervision: bool = True
    criterion_eos_coef: float = 0.1
    criterion_num_points: int = 12544

    weight_dict_loss_dice: float = 5
    weight_dict_loss_mask: float = 5
    weight_dict_loss_ce: float = 2

    matcher_cost_class: float = 2
    matcher_cost_mask: float = 5
    matcher_cost_dice: float = 5
