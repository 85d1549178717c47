"""rtmo typed config (port of focoos_tpu/models/rtmo/config.py; reference:
focoos/models/rtmo/config.py).

The static decode sizes ``nms_pre_topk`` and ``max_detections`` are the JAX
package's: the reference's ragged post-NMS lists become fixed [B, D] slots
with suppressed slots at score 0, and these two sizes define what it computes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from focoos_tpu_torch.ports import ModelConfig
from focoos_tpu_torch.nn.backbone.base import BackboneConfig


@dataclass
class RTMOConfig(ModelConfig):
    backbone_config: BackboneConfig = None  # type: ignore[assignment]

    # neck (HybridEncoder)
    transformer_embed_dims: int = 256
    transformer_num_heads: int = 8
    transformer_feedforward_channels: int = 1024
    transformer_dropout: float = 0.0
    transformer_encoder_layers: int = 1
    csp_layers: int = 1
    hidden_dim: int = 256
    output_dim: int = 256
    pe_temperature: int = 10000
    widen_factor: float = 0.5
    spe_learnable: bool = False
    output_indices: List[int] = field(default_factory=lambda: [1, 2])

    num_keypoints: int = 17
    in_channels: int = 256
    pose_vec_channels: int = 256
    cls_feat_channels: int = 256
    stacked_convs: int = 2
    featmap_strides: List[int] = field(default_factory=lambda: [16, 8])
    featmap_strides_pointgenerator: List[int] = field(default_factory=lambda: [16, 8])
    centralize_points_pointgenerator: bool = False

    overlaps_power: float = 0.5
    pixel_mean: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    pixel_std: List[float] = field(default_factory=lambda: [1.0, 1.0, 1.0])

    # DCC
    feat_channels_dcc: int = 128
    num_bins: Tuple[int, int] = (192, 256)
    spe_channels: int = 128
    gau_s: int = 128
    gau_expansion_factor: int = 2
    gau_dropout_rate: float = 0.0

    # processing
    nms_topk: int = 1000
    nms_thr: float = 0.65
    score_thr: float = 0.1
    skeleton: List[Tuple[int, int]] = field(default_factory=list)
    keypoints: List[str] = field(default_factory=list)

    # static decode sizes (pre-NMS candidates / max detections), as the JAX package's
    nms_pre_topk: int = 300
    max_detections: int = 100
