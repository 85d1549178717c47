"""ResNet-{18,34,50,101} (variants a/b/c/d) in PyTorch, NCHW.

Port of ``focoos_tpu/nn/backbone/resnet.py``, itself a re-derivation of the
reference backbone (focoos/nn/backbone/resnet.py). Parameter names are the
reference's (``conv1.conv1_1.conv.weight``, ``res_layers.{i}.blocks.{j}.
branch2a…``, ``short.conv…``), which ``torch_convert.resnet_rules`` maps.
In eval, the ResNet-D deep stem runs as one fused kernel
(``ops/stem.py::fused_resnet_stem``) with its BatchNorms folded. The stages
compute in the dtype of their ConvNorms (``nn/layers/common.py``): as in the
JAX package, which builds them in the input's dtype, a bf16 model takes its
image in bf16, and the stem kernel takes it in bf16 NHWC too.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from focoos_tpu_torch.nn.backbone.base import BackboneConfig, BaseBackbone, ShapeSpec
from focoos_tpu_torch.nn.layers.common import ConvNorm, get_activation
from focoos_tpu_torch.ops.stem import fused_resnet_stem

RESNET_DEPTH_BLOCKS = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3], 101: [3, 4, 23, 3]}


@dataclass
class ResnetConfig(BackboneConfig):
    model_type: str = "resnet"
    in_chans: int = 3
    depth: int = 50
    variant: str = "d"
    freeze_at: int = -1
    num_stages: int = 4
    freeze_norm: bool = True
    act: str = "relu"
    pretrained: bool = False


def _avg_pool_2x2_ceil(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(2, 2, ceil_mode=True) over NCHW; windows cut by an odd edge
    divide by their number of valid elements, as the JAX version does."""
    return F.avg_pool2d(x, 2, 2, ceil_mode=True, count_include_pad=False)


class _AvgPool2x2Ceil(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _avg_pool_2x2_ceil(x)


def _shortcut(ch_in: int, ch_out: int, stride: int, variant: str, norm: str) -> nn.Module:
    if variant == "d" and stride == 2:
        # reference: Sequential(pool, conv=ConvNormLayer) → keys short.conv.*
        return nn.Sequential(OrderedDict(pool=_AvgPool2x2Ceil(), conv=ConvNorm(ch_in, ch_out, 1, 1, norm=norm)))
    return ConvNorm(ch_in, ch_out, 1, stride, norm=norm)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, ch_in: int, ch_out: int, stride: int, shortcut: bool, act: str = "relu",
                 variant: str = "b", norm: str = "BN"):
        super().__init__()
        self.branch2a = ConvNorm(ch_in, ch_out, 3, stride, act=act, norm=norm)
        self.branch2b = ConvNorm(ch_out, ch_out, 3, 1, norm=norm)
        self.short = None if shortcut else _shortcut(ch_in, ch_out, stride, variant, norm)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.branch2b(self.branch2a(x))
        return self.act(out + (x if self.short is None else self.short(x)))


class BottleNeck(nn.Module):
    expansion = 4

    def __init__(self, ch_in: int, ch_out: int, stride: int, shortcut: bool, act: str = "relu",
                 variant: str = "b", norm: str = "BN"):
        super().__init__()
        stride1, stride2 = (stride, 1) if variant == "a" else (1, stride)
        width = ch_out
        self.branch2a = ConvNorm(ch_in, width, 1, stride1, act=act, norm=norm)
        self.branch2b = ConvNorm(width, width, 3, stride2, act=act, norm=norm)
        self.branch2c = ConvNorm(width, width * self.expansion, 1, 1, norm=norm)
        self.short = None if shortcut else _shortcut(ch_in, width * self.expansion, stride, variant, norm)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.branch2c(self.branch2b(self.branch2a(x)))
        return self.act(out + (x if self.short is None else self.short(x)))


class _Stage(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x


class ResNet(BaseBackbone):
    def __init__(self, config: ResnetConfig):
        super().__init__(config)
        cfg = config
        norm = "FrozenBN" if cfg.freeze_norm else "BN"
        if cfg.variant in ("c", "d"):
            self.conv1 = nn.Sequential(OrderedDict(
                conv1_1=ConvNorm(cfg.in_chans, 32, 3, 2, act=cfg.act, norm=norm),
                conv1_2=ConvNorm(32, 32, 3, 1, act=cfg.act, norm=norm),
                conv1_3=ConvNorm(32, 64, 3, 1, act=cfg.act, norm=norm),
            ))
        else:
            self.conv1 = nn.Sequential(OrderedDict(conv1_1=ConvNorm(cfg.in_chans, 64, 7, 2, act=cfg.act, norm=norm)))

        block_cls = BottleNeck if cfg.depth >= 50 else BasicBlock
        ch_in = 64
        stages = []
        for stage_idx in range(cfg.num_stages):
            ch_out = [64, 128, 256, 512][stage_idx]
            blocks = []
            for blk_idx in range(RESNET_DEPTH_BLOCKS[cfg.depth][stage_idx]):
                blocks.append(block_cls(
                    ch_in, ch_out,
                    stride=2 if blk_idx == 0 and stage_idx > 0 else 1,
                    shortcut=blk_idx != 0,
                    act=cfg.act, variant=cfg.variant, norm=norm,
                ))
                ch_in = ch_out * block_cls.expansion
            stages.append(_Stage(blocks))
        self.res_layers = nn.ModuleList(stages)

    def _fused_stem(self, x: torch.Tensor) -> torch.Tensor:
        """Eval deep stem as one kernel: BN folded as scale = γ·rsqrt(var+eps),
        bias = β − mean·scale; NCHW in (a channels-last view of NHWC is free)."""
        params = []
        for cn in self.conv1:
            bn = cn.norm
            scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            params += [
                cn.conv.weight.permute(2, 3, 1, 0).float().contiguous(),  # OIHW → HWIO
                scale.float().contiguous(),
                (bn.bias - bn.running_mean * scale).float().contiguous(),
            ]
        y = fused_resnet_stem(x.permute(0, 2, 3, 1).contiguous(), *params)
        return y.permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg = self.config
        # the int8 path runs the three convs as int8 ConvNorms, as the JAX
        # package's int8 forward does off a TPU (its stem_banded_auto is false there)
        if not self.training and cfg.variant in ("c", "d") and cfg.act == "relu" and not self.conv1[0].int8:
            x = self._fused_stem(x)
        else:
            x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        outs = {}
        for stage_idx, stage in enumerate(self.res_layers):
            x = stage(x)
            outs[f"res{stage_idx + 2}"] = x
        return outs

    def output_shape(self) -> Dict[str, ShapeSpec]:
        expansion = 4 if self.config.depth >= 50 else 1
        channels = [expansion * c for c in [64, 128, 256, 512]]
        strides = [4, 8, 16, 32]
        return {
            f"res{i + 2}": ShapeSpec(channels=channels[i], stride=strides[i])
            for i in range(self.config.num_stages)
        }


def _register_backbone():
    from focoos_tpu_torch.model_manager import BackboneManager

    BackboneManager.register("resnet", ResnetConfig, ResNet)


_register_backbone()
