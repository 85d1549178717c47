"""fai_cls — backbone + pooled classifier head in PyTorch.

Port of ``focoos_tpu/models/fai_cls/modelling.py`` (reference:
focoos/models/fai_cls/modelling.py): the image is normalized on the device
in fp32 and cast to the compute dtype; the backbone's ``features`` map goes
through a global average pool, dropout and a 1x1 conv (``num_layers=1``), or
a 1x1 conv, ReLU, dropout and a second 1x1 conv (``num_layers=2``); with
``dense_prediction`` the classifier runs on every position and a global max
pool follows it. The logits are fp32.

The head keeps the reference's ``nn.Sequential`` indices, which
``focoos_tpu/utils/torch_convert.py::fai_cls_rules`` maps: index 0 is the
pool, the convs sit at ``classifier.2`` (one layer) or ``classifier.1`` and
``classifier.4`` (two). Dropout, the step's only random draw, takes an
explicit ``torch.Generator`` (or a given keep mask) instead of torch's
global generator.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from focoos_tpu_torch.models.fai_cls.config import ClassificationConfig
from focoos_tpu_torch.models.fai_cls.ports import ClassificationModelOutput
from focoos_tpu_torch.nn.backbone.base import BaseBackbone
from focoos_tpu_torch.nn.layers.common import ComputeDtype, Conv2d, init_like_flax_
from focoos_tpu_torch.parallel import mesh


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training, each value is kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)``; the keep mask is drawn
    from ``generator`` on the input's device (the global batch's draw, of
    which this rank keeps its rows), or given as ``keep``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        if keep is None:
            # the global batch's draw, of which this rank keeps its rows
            keep = mesh.global_rand(x.shape, generator, x.device) < keep_prob
        return torch.where(keep.to(x.device), x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class _MeanPool(nn.Module):
    """AdaptiveAvgPool2d(1) over NCHW (the identity with ``dense_prediction``)."""

    def __init__(self, dense: bool):
        super().__init__()
        self.dense = dense

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.dense else x.mean((2, 3), keepdim=True)


class ClassificationHead(nn.Module):
    """Pool → (1x1 conv stack) head (reference: fai_cls/modelling.py:16-79;
    JAX ``ClassificationHead``)."""

    def __init__(self, in_channels: int, hidden_dim: int, num_classes: int, num_layers: int = 1,
                 dropout_rate: float = 0.0, dense_prediction: bool = False):
        super().__init__()
        self.dense_prediction = dense_prediction
        pool = _MeanPool(dense_prediction)
        if num_layers == 2:
            self.classifier = nn.Sequential(pool, Conv2d(in_channels, hidden_dim, 1), nn.ReLU(),
                                            Dropout(dropout_rate), Conv2d(hidden_dim, num_classes, 1))
        elif num_layers == 1:
            self.classifier = nn.Sequential(pool, Dropout(dropout_rate), Conv2d(in_channels, num_classes, 1))
        else:
            raise ValueError(f"Invalid number of layers: {num_layers}")

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.classifier:
            x = layer(x, generator, keep) if isinstance(layer, Dropout) else layer(x)
        if self.dense_prediction:
            x = x.amax((2, 3), keepdim=True)  # AdaptiveMaxPool2d(1)
        return x.flatten(1)


class FAIClassification(ComputeDtype, nn.Module):
    """fai_cls top-level module (JAX ``FAIClassification``).

    ``forward(images NHWC uint8 or float, generator=None, keep=None) ->
    (ClassificationModelOutput, None)``; ``generator`` (or the keep mask
    ``keep``, shaped as the dropout's input) feeds the dropout in training."""

    def __init__(self, config: ClassificationConfig, backbone: BaseBackbone):
        super().__init__()
        cfg = self.config = config
        self.register_buffer("pixel_mean", torch.tensor(cfg.pixel_mean, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.pixel_std, dtype=torch.float32), persistent=False)
        self.backbone = backbone
        self.cls_head = ClassificationHead(
            backbone.output_shape()[cfg.features].channels, cfg.hidden_dim, cfg.num_classes, cfg.num_layers,
            cfg.dropout_rate, cfg.dense_prediction)

    def forward(self, images: torch.Tensor, generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None):
        x = ((images.float() - self.pixel_mean) / self.pixel_std).to(self.compute_dtype).permute(0, 3, 1, 2)
        fmap = self.backbone(x)[self.config.features]
        logits = self.cls_head(fmap, generator, keep)
        return ClassificationModelOutput(logits=logits.float(), loss=None), None

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers (lecun-normal
        kernels, zero biases, unit norms), drawn on the CPU."""
        init_like_flax_(self, generator)
