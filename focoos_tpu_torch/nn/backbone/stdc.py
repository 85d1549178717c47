"""STDC backbone (nano/small/large) in PyTorch, NCHW.

Port of ``focoos_tpu/nn/backbone/stdc.py``, itself a re-derivation of the
reference STDC (focoos/nn/backbone/stdc.py): two stride-2 ConvX stems, then
Cat/Add bottlenecks with halving channel splits and a depthwise-conv "avd"
downsample. Parameter names are the reference's (``features.{i}`` holding
``conv``/``bn``, ``conv_list.{j}``, ``avd_layer.{0,1}``, ``skip.{0..3}``),
which ``torch_convert.stdc_rules`` maps. The JAX package's banded stem conv
exists only for the TPU and is not ported: ``features.0`` is a plain conv.
Convolutions and BatchNorms are ``ComputeDtype`` layers, so a bf16 model
computes the backbone in bf16 as the JAX package does (it builds every layer
in the input's dtype); BatchNorms take flax's statistics (momentum 0.9, eps
1e-5, biased running variance).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from focoos_tpu_torch.nn.backbone.base import BackboneConfig, BaseBackbone, ShapeSpec
from focoos_tpu_torch.nn.layers.common import BatchNorm, Conv2d

SIZE_PRESETS = {
    "small": dict(layers=[2, 2, 2], base=64, block_num=4, block_type="cat"),
    "large": dict(layers=[4, 5, 3], base=64, block_num=4, block_type="cat"),
    "nano": dict(layers=[2, 2, 2], base=32, block_num=4, block_type="cat"),
}


@dataclass
class STDCConfig(BackboneConfig):
    model_type: str = "stdc"
    in_chans: int = 3
    base: int = 64
    layers: List[int] = field(default_factory=lambda: [4, 5, 3])
    out_features: List[str] = field(default_factory=lambda: ["res2", "res3", "res4", "res5"])
    block_num: int = 4
    block_type: str = "cat"
    size: Optional[str] = None
    use_conv_last: bool = False

    def resolved(self) -> dict:
        if self.size is not None:
            return SIZE_PRESETS[self.size]
        return dict(layers=self.layers, base=self.base, block_num=self.block_num, block_type=self.block_type)


class ConvX(nn.Module):
    """Conv (no bias) + BatchNorm + ReLU."""

    def __init__(self, in_planes: int, out_planes: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = Conv2d(in_planes, out_planes, kernel, stride, kernel // 2, bias=False)
        self.bn = BatchNorm(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _block_channels(out_planes: int, block_num: int) -> List[int]:
    """Per-sub-conv output channels of a Cat/Add bottleneck."""
    chans = []
    for idx in range(block_num):
        if idx == 0:
            chans.append(out_planes // 2)
        elif idx == 1 and block_num == 2:
            chans.append(out_planes // 2)
        elif idx == 1 and block_num > 2:
            chans.append(out_planes // 4)
        elif idx < block_num - 1:
            chans.append(out_planes // (2 ** (idx + 1)))
        else:
            chans.append(out_planes // (2**idx))
    return chans


def _depthwise_bn(channels: int) -> nn.Sequential:
    """Depthwise 3x3 stride-2 conv + BatchNorm (the "avd" downsample)."""
    return nn.Sequential(Conv2d(channels, channels, 3, 2, 1, groups=channels, bias=False), BatchNorm(channels))


def _avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, 2, 1) with count_include_pad=True, as flax's avg_pool.
    Pooled from an NCHW-contiguous copy: on the card, the channels-last
    kernel's backward returns wrong input gradients (torch 2.11 + CUDA 12.8
    on an H100; its forward is right), the NCHW kernel's do not (the card
    test ``test_stdc_stride2_block_gradients_match_the_cpu`` holds a
    channels-last block's gradients to the CPU's); the result goes back to
    the input's channels-last layout."""
    cl = x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)
    y = F.avg_pool2d(x.contiguous(), 3, 2, 1, count_include_pad=True)
    return y.contiguous(memory_format=torch.channels_last) if cl else y


class CatBottleneck(nn.Module):
    """STDC cat bottleneck (reference: stdc.py:109-172)."""

    def __init__(self, in_planes: int, out_planes: int, block_num: int = 3, stride: int = 1):
        super().__init__()
        chans = _block_channels(out_planes, block_num)
        self.stride = stride
        self.avd_layer = _depthwise_bn(out_planes // 2) if stride == 2 else None
        ins = [in_planes] + chans[:-1]
        self.conv_list = nn.ModuleList(
            ConvX(cin, cout, kernel=1 if idx == 0 else 3) for idx, (cin, cout) in enumerate(zip(ins, chans))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.conv_list[0](x)
        outs, out = [], out1
        for idx, conv in enumerate(self.conv_list[1:], start=1):
            out = conv(self.avd_layer(out) if idx == 1 and self.avd_layer is not None else out)
            outs.append(out)
        if self.stride == 2:
            out1 = _avg_pool_3x3_s2(out1)
        return torch.cat([out1] + outs, dim=1)


class AddBottleneck(nn.Module):
    """STDC add bottleneck (reference: stdc.py:34-106)."""

    def __init__(self, in_planes: int, out_planes: int, block_num: int = 3, stride: int = 1):
        super().__init__()
        chans = _block_channels(out_planes, block_num)
        self.avd_layer = _depthwise_bn(out_planes // 2) if stride == 2 else None
        ins = [in_planes] + chans[:-1]
        self.conv_list = nn.ModuleList(
            ConvX(cin, cout, kernel=1 if idx == 0 else 3) for idx, (cin, cout) in enumerate(zip(ins, chans))
        )
        self.skip = nn.Sequential(
            Conv2d(in_planes, in_planes, 3, 2, 1, groups=in_planes, bias=False), BatchNorm(in_planes),
            Conv2d(in_planes, out_planes, 1, bias=False), BatchNorm(out_planes),
        ) if stride == 2 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs, out = [], x
        for idx, conv in enumerate(self.conv_list):
            out = conv(out)
            if idx == 0 and self.avd_layer is not None:
                out = self.avd_layer(out)
            outs.append(out)
        return torch.cat(outs, dim=1) + (x if self.skip is None else self.skip(x))


class STDC(BaseBackbone):
    def __init__(self, config: STDCConfig):
        super().__init__(config)
        r = config.resolved()
        base, layers, block_num = r["base"], r["layers"], r["block_num"]
        block_cls = CatBottleneck if r["block_type"] == "cat" else AddBottleneck
        self.out_ids = (1, 3, 5, 7) if list(layers) == [2, 2, 2] else (1, 5, 10, 13)
        features: List[nn.Module] = [ConvX(config.in_chans, base // 2, 3, 2), ConvX(base // 2, base, 3, 2)]
        cin = base
        for i, layer in enumerate(layers):
            out_planes = base * (2 ** (i + 2))
            for j in range(layer):
                features.append(block_cls(cin, out_planes, block_num, stride=2 if j == 0 else 1))
                cin = out_planes
        self.features = nn.ModuleList(features)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = []
        for f in self.features:
            x = f(x)
            feats.append(x)
        return {f"res{i + 2}": feats[idx] for i, idx in enumerate(self.out_ids)}

    def output_shape(self) -> Dict[str, ShapeSpec]:
        base = self.config.resolved()["base"]
        channels = {"res2": base, "res3": base * 4, "res4": base * 8, "res5": base * 16}
        strides = {"res2": 4, "res3": 8, "res4": 16, "res5": 32}
        return {k: ShapeSpec(channels=channels[k], stride=strides[k]) for k in self.config.out_features}


def _register_backbone():
    from focoos_tpu_torch.model_manager import BackboneManager

    BackboneManager.register("stdc", STDCConfig, STDC)


_register_backbone()
