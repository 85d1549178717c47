"""CSP-Darknet (YOLOX-style) backbone in PyTorch, NCHW — RTMO's feature extractor.

Port of ``focoos_tpu/nn/backbone/csp_darknet.py`` (reference:
focoos/nn/backbone/csp_darknet.py, from MMPose): Focus stem (space-to-depth,
then a 3x3 conv), four stages of stride-2 conv + (SPP on the last) + CSP
layers of Darknet bottlenecks. BatchNorm uses the YOLO convention, eps 1e-3
and momentum 0.03 (flax's 0.97), with flax's train-mode statistics
(``nn/layers/common.py::BatchNorm``).
Parameter names are the reference's (``stem.conv.conv``, ``stage{i}.{j}``,
``blocks.{k}.conv1``), which ``torch_convert.csp_darknet_rules`` maps.

The JAX package runs the Focus conv as one 6x6 stride-2 conv on the raw
image (``_S2DFoldedConv``, a TPU formulation); the port computes the
reference's form, the space-to-depth concat followed by the 3x3 conv, with
the same [out, 4c, 3, 3] weight.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from focoos_tpu_torch.nn.backbone.base import BackboneConfig, BaseBackbone, ShapeSpec
from focoos_tpu_torch.nn.layers.common import BatchNorm, Conv2d

# per stage: in, out, bottlenecks, add_identity, use_spp
ARCH_SETTINGS = {
    "small": [[32, 64, 1, True, False], [64, 128, 3, True, False], [128, 256, 3, True, False], [256, 512, 1, False, True]],
    "medium": [[48, 96, 2, True, False], [96, 192, 6, True, False], [192, 384, 6, True, False], [384, 768, 2, False, True]],
    "large": [[64, 128, 3, True, False], [128, 256, 9, True, False], [256, 512, 9, True, False], [512, 1024, 3, False, True]],
}


@dataclass
class CSPConfig(BackboneConfig):
    model_type: str = "csp_darknet"
    size: str = "small"


class ConvModule(nn.Module):
    """conv (no bias) + BN(eps 1e-3, momentum 0.03) + SiLU (reference: csp_darknet.py:17-58)."""

    def __init__(self, ch_in: int, ch_out: int, kernel_size: int = 1, stride: int = 1, padding: int = 0,
                 groups: int = 1):
        super().__init__()
        self.conv = Conv2d(ch_in, ch_out, kernel_size, stride, padding, groups=groups, bias=False)
        self.bn = BatchNorm(ch_out, eps=1e-3, momentum=0.03)  # flax momentum 0.97

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))


class DarknetBottleneck(nn.Module):
    """1x1 → 3x3 residual bottleneck (reference :86-124)."""

    def __init__(self, ch_in: int, ch_out: int, expansion: float = 0.5, add_identity: bool = True):
        super().__init__()
        hidden = int(ch_out * expansion)
        self.conv1 = ConvModule(ch_in, hidden, 1)
        self.conv2 = ConvModule(hidden, ch_out, 3, padding=1)
        self.add_identity = add_identity and ch_in == ch_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        return out + x if self.add_identity else out


class ChannelAttention(nn.Module):
    """GAP → 1x1 conv → hard-sigmoid gate (reference :61-83)."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = Conv2d(channels, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        return x * F.hardsigmoid(self.fc(g))


class CSPLayer(nn.Module):
    """Cross-stage-partial layer (reference :127-185)."""

    def __init__(self, ch_in: int, ch_out: int, expand_ratio: float = 0.5, num_blocks: int = 1,
                 add_identity: bool = True, channel_attention: bool = False):
        super().__init__()
        mid = int(ch_out * expand_ratio)
        self.main_conv = ConvModule(ch_in, mid, 1)
        self.short_conv = ConvModule(ch_in, mid, 1)
        self.final_conv = ConvModule(2 * mid, ch_out, 1)
        self.blocks = nn.Sequential(*(DarknetBottleneck(mid, mid, 1.0, add_identity) for _ in range(num_blocks)))
        self.attention = ChannelAttention(2 * mid) if channel_attention else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([self.blocks(self.main_conv(x)), self.short_conv(x)], dim=1)
        if self.attention is not None:
            y = self.attention(y)
        return self.final_conv(y)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] → [B, 4C, H/2, W/2], channel blocks top-left,
    bottom-left, top-right, bottom-right (block ``dx*2+dy``, reference :188-236)."""
    return torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2], x[..., 1::2, 1::2]], dim=1)


class Focus(nn.Module):
    """Space-to-depth stem, then a 3x3 ConvModule (reference :188-236)."""

    def __init__(self, ch_in: int, ch_out: int, kernel_size: int = 3):
        super().__init__()
        self.conv = ConvModule(4 * ch_in, ch_out, kernel_size, padding=(kernel_size - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(space_to_depth(x))


class SPPBottleneck(nn.Module):
    """Parallel max-pool pyramid; the pools pad with -inf (reference :239-276)."""

    def __init__(self, ch_in: int, ch_out: int, kernel_sizes: Sequence[int] = (5, 9, 13)):
        super().__init__()
        mid = ch_in // 2
        self.conv1 = ConvModule(ch_in, mid, 1)
        self.conv2 = ConvModule(mid * (len(kernel_sizes) + 1), ch_out, 1)
        self.kernel_sizes = tuple(kernel_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        pools = [x] + [F.max_pool2d(x, ks, 1, ks // 2) for ks in self.kernel_sizes]
        return self.conv2(torch.cat(pools, dim=1))


class CSPDarknet(BaseBackbone):
    """NCHW image → {"res2", …, "res5"} at strides 4, 8, 16, 32."""

    def __init__(self, config: CSPConfig):
        super().__init__(config)
        arch = ARCH_SETTINGS[config.size]
        self.stem = Focus(3, arch[0][0], kernel_size=3)
        for i, (cin, cout, nblocks, add_id, use_spp) in enumerate(arch):
            layers = [ConvModule(cin, cout, 3, stride=2, padding=1)]
            if use_spp:
                layers.append(SPPBottleneck(cout, cout))
            layers.append(CSPLayer(cout, cout, num_blocks=nblocks, add_identity=add_id))
            self.add_module(f"stage{i + 1}", nn.Sequential(*layers))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        outs = {}
        for i in range(4):
            x = getattr(self, f"stage{i + 1}")(x)
            outs[f"res{i + 2}"] = x
        return outs

    def output_shape(self) -> Dict[str, ShapeSpec]:
        arch = ARCH_SETTINGS[self.config.size]
        strides = [4, 8, 16, 32]
        return {f"res{i + 2}": ShapeSpec(channels=arch[i][1], stride=strides[i]) for i in range(4)}


def _register_backbone():
    from focoos_tpu_torch.model_manager import BackboneManager

    BackboneManager.register("csp_darknet", CSPConfig, CSPDarknet)


_register_backbone()
