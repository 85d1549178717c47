"""Backbone protocol (reference: focoos/nn/backbone/base.py:16-36).

Backbones are ``nn.Module``s mapping an NCHW image batch to a dict of NCHW
feature maps ``{"res2": [B,C2,H/4,W/4], ..., "res5": [B,C5,H/32,W/32]}``,
plus a static ``output_shape()`` descriptor used by heads at construction.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, Optional

from torch import nn


@dataclass
class ShapeSpec:
    channels: int
    stride: int
    height: Optional[int] = None
    width: Optional[int] = None


@dataclass
class BackboneConfig:
    model_type: str = "base"
    use_pretrained: bool = True
    backbone_url: Optional[str] = None

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @classmethod
    def from_dict(cls, d: dict) -> "BackboneConfig":
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class BaseBackbone(nn.Module):
    """All backbones subclass this, take their config, and define ``forward``."""

    def __init__(self, config: Any):
        super().__init__()
        self.config = config

    def output_shape(self) -> Dict[str, ShapeSpec]:
        raise NotImplementedError

    @property
    def size_divisibility(self) -> int:
        return 0

    @property
    def padding_constraints(self) -> Dict[str, int]:
        return {}
