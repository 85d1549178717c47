"""fai_mf — MaskFormer in PyTorch (port of focoos_tpu/models/fai_mf/modelling.py).

backbone → ``TransformerFPN`` pixel decoder (an optional pre-norm encoder on
res5, then an FPN with nearest upsampling) → masked-attention query decoder
over three scales with learned queries → per-layer class and mask-embedding
heads (mask = einsum(query embedding, mask features)). Parameter names are
the reference's torch names (``pixel_decoder.*``, ``head.predictor.*``),
which ``focoos_tpu.utils.torch_convert.fai_mf_rules`` maps onto the JAX
variables. Images enter NHWC; conv activations are NCHW.

Masked cross-attention takes a boolean mask, True where a key is allowed:
a query's predicted mask, resized bilinearly to the attended level, blocks
the pixels where it is negative, and a query that would block everything
attends everywhere (reference :96-106, :510-513). Under bf16 that resize
runs in bf16, as the JAX package's (a sign test, equal away from zero).

In a bf16 model the dtypes are flax's: convolutions, dense layers,
attention and BatchNorm outputs are bf16, LayerNorms fp32; the class
probabilities are fp32 and the eval masks are cast to bf16 before their
bilinear upsample to the input size (JAX :272-276).

In train mode (JAX ``train=True``) the BatchNorms take batch statistics
(flax's biased variance, ``BatchNorm``), the cross-attention masks come from
detached masks (JAX :194, ``stop_gradient``) and the forward skips the
upsample: the criterion (``loss.py``) reads every layer's fp32 outputs in
``aux``. The JAX package applies no dropout anywhere; a config that asks
for pixel-decoder dropout is refused in training.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from focoos_tpu_torch.models.fai_mf.config import MaskFormerConfig
from focoos_tpu_torch.models.fai_mf.ports import MaskFormerAuxOutputs, MaskFormerModelOutput
from focoos_tpu_torch.nn.backbone.base import BaseBackbone
from focoos_tpu_torch.nn.layers.common import (
    MLP,
    BatchNorm,
    ComputeDtype,
    Conv2d,
    CrossAttentionBlock,
    FFNBlock,
    LayerNorm,
    Linear,
    SelfAttentionBlock,
    TransformerEncoderLayer,
    bilinear_resize,
    init_like_flax_,
    nearest_resize_torch,
    sine_position_embedding_2d_normalized,
)


class ConvNormReLU(Conv2d):
    """The reference's detectron2-style ``Conv2d(norm=..., activation=...)``:
    a bias-free conv whose BatchNorm is its ``norm`` child (state_dict keys
    ``<name>.weight``, ``<name>.norm.*``)."""

    def __init__(self, ch_in: int, ch_out: int, kernel_size: int, relu: bool):
        super().__init__(ch_in, ch_out, kernel_size, padding=kernel_size // 2, bias=False)
        self.norm = BatchNorm(ch_out)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(super().forward(x))
        return F.relu(y) if self.relu else y


class TransformerFPN(nn.Module):
    """FPN pixel decoder with an optional pre-norm transformer on res5
    (reference: fai_mf/modelling.py:201-369; JAX :45).

    ``forward(images NCHW) -> (mask_features [B, out_dim, H/4, W/4], [p5, p4, p3])``."""

    def __init__(
        self,
        backbone: BaseBackbone,
        feat_dim: int = 256,
        out_dim: int = 256,
        transformer_layers: int = 0,
        transformer_nheads: int = 8,
        transformer_dim_feedforward: int = 1024,
    ):
        super().__init__()
        self.backbone = backbone
        self.feat_dim = feat_dim
        shapes = backbone.output_shape()
        self.names = [n for n in ("res2", "res3", "res4", "res5") if n in shapes]
        top_ch = shapes[self.names[-1]].channels
        if transformer_layers > 0:
            self.input_proj = Conv2d(top_ch, feat_dim, 1)
            self.transformer = nn.Module()
            self.transformer.encoder = nn.Module()
            self.transformer.encoder.layers = nn.ModuleList(
                TransformerEncoderLayer(feat_dim, transformer_nheads, transformer_dim_feedforward, normalize_before=True)
                for _ in range(transformer_layers)
            )
            self.transformer.encoder.norm = LayerNorm(feat_dim, eps=1e-5)
            top_ch = feat_dim
        self.transformer_layers = transformer_layers
        # torch indices count res2=1 … res5=4
        n = len(self.names)
        for idx, name in zip(range(1, n + 1), self.names):
            if idx == n:
                setattr(self, f"layer_{idx}", ConvNormReLU(top_ch, feat_dim, 3, relu=True))
            else:
                setattr(self, f"adapter_{idx}", ConvNormReLU(shapes[name].channels, feat_dim, 1, relu=False))
                setattr(self, f"layer_{idx}", ConvNormReLU(feat_dim, feat_dim, 3, relu=True))
        self.mask_features = Conv2d(feat_dim, out_dim, 3, padding=1)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        feats = self.backbone(images)
        n = len(self.names)
        multi_scale: List[torch.Tensor] = []
        y = None
        for rev_i, name in enumerate(reversed(self.names)):
            idx = n - rev_i
            x = feats[name]
            if rev_i == 0:
                if self.transformer_layers > 0:
                    x = self.input_proj(x)
                    b, c, h, w = x.shape
                    pos = sine_position_embedding_2d_normalized(
                        h, w, self.feat_dim // 2, device=x.device, dtype=x.dtype)[None]
                    tokens = x.flatten(2).transpose(1, 2)
                    for layer in self.transformer.encoder.layers:
                        tokens = layer(tokens, pos_embed=pos)
                    tokens = self.transformer.encoder.norm(tokens)
                    x = tokens.transpose(1, 2).reshape(b, c, h, w)
                y = getattr(self, f"layer_{idx}")(x)
            else:
                lat = getattr(self, f"adapter_{idx}")(x)
                # torch's floor-mapping nearest: at odd sizes (res5 w=4 → res4 w=7) it
                # differs from a half-pixel nearest
                y = getattr(self, f"layer_{idx}")(lat + nearest_resize_torch(y, lat.shape[-2:]))
            if len(multi_scale) < 3:
                multi_scale.append(y)
        return self.mask_features(y), multi_scale


class PredictionHeads(nn.Module):
    """Class and mask-embedding heads (reference: fai_mf/modelling.py:28-127; JAX :116)."""

    def __init__(self, hidden_dim: int, num_classes: int, mask_dim: int):
        super().__init__()
        self.decoder_norm = LayerNorm(hidden_dim, eps=1e-5)
        self.classifier = Linear(hidden_dim, num_classes + 1)
        self.mask_classifier = MLP(hidden_dim, hidden_dim, mask_dim, 3)

    def forward(self, queries: torch.Tensor, mask_features: torch.Tensor):
        """queries [B, Q, C]; mask_features [B, Cm, H, W] →
        (class logits [B, Q, num_classes+1], masks [B, Q, H, W])."""
        x = self.decoder_norm(queries)
        logits = self.classifier(x)
        embed = self.mask_classifier(x)
        return logits, torch.einsum("bqc,bchw->bqhw", embed, mask_features)


def _attn_allowed_from_masks(masks: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Predicted masks [B, Q, H, W] → allowed [B, 1, Q, h·w] (JAX :135-144):
    a bilinear resize to ``hw`` in the masks' dtype, blocked where < 0, and a
    query that blocks everything allows everything."""
    b, q = masks.shape[:2]
    blocked = (bilinear_resize(masks, hw) < 0).reshape(b, q, hw[0] * hw[1])
    return (~blocked | blocked.all(-1, keepdim=True))[:, None]


class MultiScaleMaskedTransformerDecoder(nn.Module):
    """Masked-attention query decoder (reference: fai_mf/modelling.py:372-557; JAX :147).

    ``forward(xs [p5, p4, p3] NCHW, mask_features NCHW, allowed=None)``:
    ``allowed`` (a list of one boolean mask per layer, as
    ``_attn_allowed_from_masks`` returns) replaces the masks computed from
    this forward's predictions, which carries another run's masks in (the
    masks' sign test flips between devices where a prediction is near 0).
    The masks the forward used come back in ``aux.allowed``."""

    def __init__(
        self,
        in_channels: int,
        num_classes: int,
        hidden_dim: int = 256,
        mask_dim: int = 256,
        num_queries: int = 100,
        nheads: int = 8,
        dec_layers: int = 6,
        dim_feedforward: int = 1024,
        num_scales: int = 3,
        pre_norm: bool = True,
    ):
        super().__init__()
        self.num_scales, self.dec_layers, self.num_queries, self.hidden_dim = num_scales, dec_layers, num_queries, hidden_dim
        nlv = min(num_scales, dec_layers)
        self.input_proj = nn.ModuleList(Conv2d(in_channels, hidden_dim, 1) for _ in range(nlv))
        self.query_feat = nn.Embedding(num_queries, hidden_dim)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionBlock(hidden_dim, nheads, normalize_before=pre_norm) for _ in range(dec_layers))
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionBlock(hidden_dim, nheads, normalize_before=pre_norm) for _ in range(dec_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNBlock(hidden_dim, dim_feedforward, normalize_before=pre_norm) for _ in range(dec_layers))
        self.forward_prediction_heads = PredictionHeads(hidden_dim, num_classes, mask_dim)

    def forward(self, xs: List[torch.Tensor], mask_features: torch.Tensor, allowed=None) -> MaskFormerAuxOutputs:
        nlv = len(self.input_proj)
        srcs, poss, sizes = [], [], []
        for i in range(nlv):
            src = self.input_proj[i](xs[i])
            b, c, h, w = src.shape
            srcs.append(src.flatten(2).transpose(1, 2))
            poss.append(sine_position_embedding_2d_normalized(
                h, w, self.hidden_dim // 2, device=src.device, dtype=src.dtype)[None])
            sizes.append((h, w))
        bsz, dt = srcs[0].shape[0], srcs[0].dtype
        qe = self.query_embed.weight[None].expand(bsz, -1, -1).to(dt)
        output = self.query_feat.weight[None].expand(bsz, -1, -1).to(dt)
        heads = self.forward_prediction_heads

        logits, masks = heads(output, mask_features)
        all_logits, all_masks, used = [logits.float()], [masks.float()], []
        for i in range(self.dec_layers):
            lvl = i % nlv
            attn = allowed[i] if allowed is not None else _attn_allowed_from_masks(masks.detach(), sizes[lvl])
            used.append(attn)
            output = self.transformer_cross_attention_layers[i](
                output, srcs[lvl], pos=poss[lvl], query_pos=qe, attn_mask=attn)
            output = self.transformer_self_attention_layers[i](output, query_pos=qe)
            output = self.transformer_ffn_layers[i](output)
            logits, masks = heads(output, mask_features)
            all_logits.append(logits.float())
            all_masks.append(masks.float())
        return MaskFormerAuxOutputs(logits=torch.stack(all_logits), masks=torch.stack(all_masks), allowed=used)


def mask_classification_output(aux: MaskFormerAuxOutputs, images: torch.Tensor, cls_sigmoid: bool,
                               compute_dtype: torch.dtype, training: bool) -> MaskFormerModelOutput:
    """The last layer's class probabilities (fp32, without the no-object
    column) and sigmoid masks, upsampled to the input outside training (JAX
    :262-276; bisenetformer's too)."""
    logits_raw = aux.logits[-1]
    if cls_sigmoid:
        cls_probs = torch.sigmoid(logits_raw)[..., :-1]
    else:
        cls_probs = torch.softmax(logits_raw, dim=-1)[..., :-1]
    masks = torch.sigmoid(aux.masks[-1])
    if not training:
        # the [B, Q, H, W] upsample dominates the eval graph's bytes: it runs in the compute dtype
        masks = bilinear_resize(masks.to(compute_dtype), images.shape[1:3])
    return MaskFormerModelOutput(masks=masks, logits=cls_probs, loss=None)


class FAIMaskFormer(ComputeDtype, nn.Module):
    """MaskFormer top-level module (reference: fai_mf/modelling.py:633-725; JAX :222).

    ``forward(images NHWC uint8 or float, allowed=None) -> (MaskFormerModelOutput,
    MaskFormerAuxOutputs)``; in train mode the output's masks stay at the
    mask features' size. Normalization happens on the device in fp32,
    before the cast to the compute dtype."""

    def __init__(self, config: MaskFormerConfig, backbone: BaseBackbone):
        super().__init__()
        cfg = self.config = config
        self.register_buffer("pixel_mean", torch.tensor(cfg.pixel_mean, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.pixel_std, dtype=torch.float32), persistent=False)
        # x · (1/std), as the JAX package's compiled graph divides by the constant std
        # (an ulp apart from x / std; the int8 path's rounding edges see it)
        self.register_buffer("pixel_inv_std", 1.0 / self.pixel_std, persistent=False)
        self.pixel_decoder = TransformerFPN(
            backbone=backbone,
            feat_dim=cfg.pixel_decoder_feat_dim,
            out_dim=cfg.pixel_decoder_out_dim,
            transformer_layers=cfg.pixel_decoder_transformer_layers,
            transformer_nheads=cfg.pixel_decoder_transformer_nheads,
            transformer_dim_feedforward=cfg.pixel_decoder_transformer_dim_feedforward,
        )
        self.head = nn.ModuleDict({"predictor": MultiScaleMaskedTransformerDecoder(
            in_channels=cfg.pixel_decoder_feat_dim,
            num_classes=cfg.num_classes,
            hidden_dim=cfg.transformer_predictor_hidden_dim,
            mask_dim=cfg.transformer_predictor_out_dim,
            num_queries=cfg.num_queries,
            nheads=8,
            dec_layers=cfg.transformer_predictor_dec_layers,
            dim_feedforward=cfg.transformer_predictor_dim_feedforward,
        )})

    @property
    def predictor(self) -> MultiScaleMaskedTransformerDecoder:
        return self.head["predictor"]

    def forward(self, images: torch.Tensor, allowed=None):
        if self.training and self.config.pixel_decoder_transformer_dropout != 0.0:
            raise ValueError("pixel_decoder_transformer_dropout must be 0.0: the JAX reference applies no dropout")
        x = ((images.float() - self.pixel_mean) * self.pixel_inv_std).to(self.compute_dtype)
        mask_features, ms = self.pixel_decoder(x.permute(0, 3, 1, 2))
        aux = self.predictor(ms, mask_features, allowed=allowed)
        return mask_classification_output(aux, images, self.config.cls_sigmoid, self.compute_dtype, self.training), aux

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers: lecun-normal
        kernels, zero biases, unit norms, unit-normal query embeddings.
        Draws on the CPU, so a seed gives the same weights on every device."""
        init_like_flax_(self, generator)
        for emb in (self.predictor.query_feat, self.predictor.query_embed):
            emb.weight.copy_(torch.randn(emb.weight.shape, generator=generator))
