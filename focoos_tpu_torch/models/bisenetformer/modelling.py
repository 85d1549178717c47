"""bisenetformer — BiSeNet context path + masked query decoder in PyTorch
(port of focoos_tpu/models/bisenetformer/modelling.py; reference:
focoos/models/bisenetformer/modelling.py).

backbone (STDC) → context path: attention-refinement modules (ARM) on res5
and res4 plus the res5 global average, each sum upsampled bilinearly and
refined by a 3x3 ConvBNReLU → feature fusion (FFM) with res3 → ``conv_out``,
the mask features at stride 8 → fai_mf's masked-attention decoder over the
two ARM sums (``[f32_sum, f16_sum]``, not the refined heads; reference :378
``x[:-1]``). Parameter names are the reference's torch names
(``pixel_decoder.cp.arm32.*``, ``pixel_decoder.ffm.*``, ``head.predictor.*``),
which ``focoos_tpu.utils.torch_convert.bisenetformer_rules`` maps onto the
JAX variables. Images enter NHWC; conv activations are NCHW. BatchNorms take
eps 1e-5 and flax's momentum 0.9. Compute dtype, train mode and the eval
upsample are fai_mf's (``models/fai_mf/modelling.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from focoos_tpu_torch.models.bisenetformer.config import BisenetFormerConfig
from focoos_tpu_torch.models.fai_mf.modelling import MultiScaleMaskedTransformerDecoder, mask_classification_output
from focoos_tpu_torch.nn.backbone.base import BaseBackbone
from focoos_tpu_torch.nn.layers.common import BatchNorm, ComputeDtype, Conv2d, bilinear_resize, init_like_flax_


class ConvBNReLU(nn.Module):
    """Bias-free conv, BatchNorm and ReLU (reference :128-146)."""

    def __init__(self, in_chan: int, out_chan: int, ks: int = 3, stride: int = 1, padding: int = 1):
        super().__init__()
        self.conv = Conv2d(in_chan, out_chan, ks, stride, padding, bias=False)
        self.bn = BatchNorm(out_chan)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _global_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W, kept as a 1x1 map (flax's ``jnp.mean(axis=(1, 2))`` in the compute dtype)."""
    return x.mean((2, 3), keepdim=True)


class AttentionRefinementModule(nn.Module):
    """ARM (reference :149-167): a 1x1 projection, a 3x3 ConvBNReLU, and a
    channel attention from the global mean (1x1 conv, BatchNorm, sigmoid)."""

    def __init__(self, in_chan: int, out_chan: int):
        super().__init__()
        self.proj = Conv2d(in_chan, out_chan, 1, bias=False)
        self.conv = ConvBNReLU(out_chan, out_chan)
        self.conv_atten = Conv2d(out_chan, out_chan, 1, bias=False)
        self.bn_atten = BatchNorm(out_chan)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv(self.proj(x))
        atten = self.bn_atten(self.conv_atten(_global_mean(feat)))
        return feat * torch.sigmoid(atten)


class FeatureFusionModule(nn.Module):
    """FFM (reference :213-235): two 1x1 projections summed, a 1x1
    ConvBNReLU, and a squeeze-excite attention added back: ``f·a + f``."""

    def __init__(self, sp_chan: int, cp_chan: int, out_chan: int):
        super().__init__()
        self.proj1 = Conv2d(sp_chan, out_chan, 1)
        self.proj2 = Conv2d(cp_chan, out_chan, 1)
        self.convblk = ConvBNReLU(out_chan, out_chan, ks=1, padding=0)
        self.conv1 = Conv2d(out_chan, out_chan // 4, 1, bias=False)
        self.conv2 = Conv2d(out_chan // 4, out_chan, 1, bias=False)

    def forward(self, fsp: torch.Tensor, fcp: torch.Tensor) -> torch.Tensor:
        feat = self.convblk(self.proj1(fsp) + self.proj2(fcp))
        atten = torch.sigmoid(self.conv2(F.relu(self.conv1(_global_mean(feat)))))
        return feat * atten + feat


class BiseNet(nn.Module):
    """Context path + FFM pixel decoder (reference :238-282; JAX :90).

    ``forward(images NCHW) -> (mask_features [B, out_dim, H/8, W/8],
    [f32_sum, f16_sum, f8_sum])``."""

    def __init__(self, backbone: BaseBackbone, feat_dim: int = 128, out_dim: int = 256):
        super().__init__()
        self.backbone = backbone
        shapes = backbone.output_shape()
        self.cp = nn.Module()
        self.cp.conv_avg = ConvBNReLU(shapes["res5"].channels, feat_dim, ks=1, padding=0)
        self.cp.arm32 = AttentionRefinementModule(shapes["res5"].channels, feat_dim)
        self.cp.conv_head32 = ConvBNReLU(feat_dim, feat_dim)
        self.cp.arm16 = AttentionRefinementModule(shapes["res4"].channels, feat_dim)
        self.cp.conv_head16 = ConvBNReLU(feat_dim, feat_dim)
        self.ffm = FeatureFusionModule(shapes["res3"].channels, feat_dim, feat_dim)
        self.conv_out = ConvBNReLU(feat_dim, out_dim)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        feats = self.backbone(images)
        res3, res4, res5 = feats["res3"], feats["res4"], feats["res5"]
        cp = self.cp
        avg = cp.conv_avg(_global_mean(res5))
        f32_sum = cp.arm32(res5) + avg
        f32_up = cp.conv_head32(bilinear_resize(f32_sum, res4.shape[-2:]))
        f16_sum = cp.arm16(res4) + f32_up
        f8_sum = cp.conv_head16(bilinear_resize(f16_sum, res3.shape[-2:]))
        mask_features = self.conv_out(self.ffm(res3, f8_sum))
        return mask_features, [f32_sum, f16_sum, f8_sum]


class BisenetFormer(ComputeDtype, nn.Module):
    """BisenetFormer top-level module (reference :534-622; JAX :134).

    ``forward(images NHWC uint8 or float, allowed=None) -> (MaskFormerModelOutput,
    MaskFormerAuxOutputs)``, as ``FAIMaskFormer``'s."""

    def __init__(self, config: BisenetFormerConfig, backbone: BaseBackbone):
        super().__init__()
        cfg = self.config = config
        self.register_buffer("pixel_mean", torch.tensor(cfg.pixel_mean, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.pixel_std, dtype=torch.float32), persistent=False)
        self.pixel_decoder = BiseNet(backbone, feat_dim=cfg.pixel_decoder_feat_dim, out_dim=cfg.pixel_decoder_out_dim)
        self.head = nn.ModuleDict({"predictor": MultiScaleMaskedTransformerDecoder(
            in_channels=cfg.pixel_decoder_feat_dim,
            num_classes=cfg.num_classes,
            hidden_dim=cfg.transformer_predictor_hidden_dim,
            mask_dim=cfg.transformer_predictor_out_dim,
            num_queries=cfg.num_queries,
            nheads=8,
            dec_layers=cfg.transformer_predictor_dec_layers,
            dim_feedforward=cfg.transformer_predictor_dim_feedforward,
            num_scales=2,
        )})

    @property
    def predictor(self) -> MultiScaleMaskedTransformerDecoder:
        return self.head["predictor"]

    def forward(self, images: torch.Tensor, allowed=None):
        x = ((images.float() - self.pixel_mean) / self.pixel_std).to(self.compute_dtype)
        mask_features, ms = self.pixel_decoder(x.permute(0, 3, 1, 2))
        aux = self.predictor(ms[:2], mask_features, allowed=allowed)
        return mask_classification_output(aux, images, self.config.cls_sigmoid, self.compute_dtype, self.training), aux

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers (lecun-normal
        kernels, zero biases, unit norms, unit-normal query embeddings),
        drawn on the CPU."""
        init_like_flax_(self, generator)
        for emb in (self.predictor.query_feat, self.predictor.query_embed):
            emb.weight.copy_(torch.randn(emb.weight.shape, generator=generator))
