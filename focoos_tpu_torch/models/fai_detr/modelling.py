"""fai_detr — RT-DETR in PyTorch (port of focoos_tpu/models/fai_detr/modelling.py).

backbone → hybrid encoder (AIFI transformer on res5 + CSPRep FPN/PAN) →
NMS-free decoder with encoder top-k query selection and multi-scale
deformable attention (MSDA) layers with iterative box refinement. Parameter
names are the reference's torch names (``pixel_decoder.*``,
``head.predictor.*``), which ``focoos_tpu.utils.torch_convert.fai_detr_rules``
maps onto the JAX variables. Images enter NHWC; conv activations are NCHW
(channels-last views of the NHWC input, so no relayout copy is made).

The slice serves: this module computes the eval forward. The decoder's
training-time detach of the refined boxes comes with the training step.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from focoos_tpu_torch.models.fai_detr.config import DETRConfig
from focoos_tpu_torch.models.fai_detr.ports import DETRAuxOutputs, DETRModelOutput
from focoos_tpu_torch.nn.backbone.base import BaseBackbone
from focoos_tpu_torch.nn.layers.common import (
    MLP,
    BatchNorm,
    ConvNorm,
    MultiHeadAttention,
    TransformerEncoderLayer,
    bilinear_resize,
    get_activation,
    sine_position_embedding_2d,
)
from focoos_tpu_torch.ops.boxes import box_cxcywh_to_xyxy, inverse_sigmoid
from focoos_tpu_torch.ops.msda import msda_forward


class RepVggBlock(nn.Module):
    """3x3+1x1 re-parameterizable block (reference: fai_detr/modelling.py:30)."""

    def __init__(self, ch_in: int, ch_out: int, act: str = "silu"):
        super().__init__()
        self.conv1 = ConvNorm(ch_in, ch_out, 3, 1, padding=1)
        self.conv2 = ConvNorm(ch_in, ch_out, 1, 1, padding=0)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.conv1(x) + self.conv2(x))


class CSPRepLayer(nn.Module):
    """Cross-stage-partial block of RepVgg units (reference: fai_detr/modelling.py:84)."""

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int = 3, expansion: float = 1.0):
        super().__init__()
        hidden = int(out_channels * expansion)
        self.conv1 = ConvNorm(in_channels, hidden, 1, 1, act="silu")
        self.conv2 = ConvNorm(in_channels, hidden, 1, 1, act="silu")
        self.bottlenecks = nn.ModuleList(RepVggBlock(hidden, hidden) for _ in range(num_blocks))
        self.conv3 = ConvNorm(hidden, out_channels, 1, 1, act="silu") if hidden != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv1(x)
        for blk in self.bottlenecks:
            x1 = blk(x1)
        y = x1 + self.conv2(x)
        return y if self.conv3 is None else self.conv3(y)


class HybridEncoder(nn.Module):
    """Backbone + AIFI transformer on res5 + CSPRep FPN/PAN
    (reference 'Encoder': fai_detr/modelling.py:195-347).

    ``forward(images NCHW) -> [p5, p4, p3]``, multi-scale NCHW maps ordered
    stride 32 → 8.
    """

    def __init__(
        self,
        backbone: BaseBackbone,
        feat_dim: int = 256,
        out_dim: int = 256,
        nhead: int = 8,
        dim_feedforward: int = 1024,
        num_encoder_layers: int = 1,
        expansion: float = 1.0,
    ):
        super().__init__()
        self.backbone = backbone
        self.feat_dim = feat_dim
        shapes = backbone.output_shape()
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(shapes[k].channels, feat_dim, 1, bias=False), BatchNorm(feat_dim))
            for k in ("res3", "res4", "res5")
        )
        layers = [TransformerEncoderLayer(feat_dim, nhead, dim_feedforward, activation="gelu")
                  for _ in range(num_encoder_layers)]
        self.encoder = nn.ModuleList([nn.ModuleDict({"layers": nn.ModuleList(layers)})] if layers else [])
        nb = 3  # RepVgg blocks per CSPRep layer (depth multiplier 1.0)
        self.lateral_convs = nn.ModuleList(ConvNorm(feat_dim, feat_dim, 1, 1, act="silu") for _ in range(2))
        self.fpn_blocks = nn.ModuleList(CSPRepLayer(2 * feat_dim, feat_dim, nb, expansion) for _ in range(2))
        self.downsample_convs = nn.ModuleList(ConvNorm(feat_dim, feat_dim, 3, 1, act="silu") for _ in range(2))
        self.pan_blocks = nn.ModuleList(CSPRepLayer(2 * feat_dim, feat_dim, nb, expansion) for _ in range(2))
        # fai_detr never reads the mask features (XLA drops them from the JAX
        # graph too); the conv is kept so checkpoints load strictly
        self.mask_features = nn.Conv2d(feat_dim, out_dim, 3, padding=1)

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        feats = self.backbone(images)
        proj = [p(feats[k]) for p, k in zip(self.input_proj, ("res3", "res4", "res5"))]

        # AIFI: single-scale transformer encoder on res5 tokens
        if len(self.encoder):
            b, c, h, w = proj[2].shape
            tokens = proj[2].flatten(2).transpose(1, 2)
            pos = sine_position_embedding_2d(h, w, self.feat_dim // 2, device=tokens.device, dtype=tokens.dtype)[None]
            for layer in self.encoder[0]["layers"]:
                tokens = layer(tokens, pos_embed=pos)
            proj[2] = tokens.transpose(1, 2).reshape(b, c, h, w)

        # top-down FPN: res5 → res3
        inner = [proj[2]]
        for idx, low_i in enumerate((1, 0)):
            lat = self.lateral_convs[idx](inner[0])
            inner[0] = lat
            low = proj[low_i]
            up = bilinear_resize(lat, low.shape[-2:])
            inner.insert(0, self.fpn_blocks[idx](torch.cat([up, low], dim=1)))

        # bottom-up PAN: a bilinear resize, then a stride-1 3x3 ConvNorm
        outs = [inner[0]]
        for idx in range(2):
            high = inner[idx + 1]
            down = self.downsample_convs[idx](bilinear_resize(outs[-1], high.shape[-2:]))
            outs.append(self.pan_blocks[idx](torch.cat([down, high], dim=1)))
        return outs[::-1]  # [p5, p4, p3]


def _msda_offset_bias_init(num_heads: int, num_levels: int, num_points: int) -> np.ndarray:
    """Radial grid bias init for sampling offsets (reference: fai_detr/modelling.py:810-819)."""
    thetas = np.arange(num_heads, dtype=np.float32) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(num_heads, 1, 1, 2), (1, num_levels, num_points, 1))
    scaling = np.arange(1, num_points + 1, dtype=np.float32).reshape(1, 1, -1, 1)
    return (grid * scaling).reshape(-1)


class MSDeformableAttention(nn.Module):
    """Multi-scale deformable attention (reference: fai_detr/modelling.py:777-884).
    The sampling runs in ``ops/msda.py::msda_forward`` (the CUDA kernel on the card)."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8, num_levels: int = 3, num_points: int = 4):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        total = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(embed_dim, total * 2)
        self.attention_weights = nn.Linear(embed_dim, total)
        self.value_proj = nn.Linear(embed_dim, embed_dim)
        self.output_proj = nn.Linear(embed_dim, embed_dim)
        self.reset_sampling_parameters()

    @torch.no_grad()
    def reset_sampling_parameters(self) -> None:
        """Zero kernels, radial-grid offset bias, zero attention bias (as the JAX initializers)."""
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(
            torch.from_numpy(_msda_offset_bias_init(self.num_heads, self.num_levels, self.num_points))
        )
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(
        self,
        query: torch.Tensor,  # [B, Lq, C]
        reference_points: torch.Tensor,  # [B, Lq, 1 or L, 4] cxcywh in [0, 1]
        value: torch.Tensor,  # [B, S, C] flat memory, levels concatenated
        spatial_shapes: Sequence[Tuple[int, int]],
    ) -> torch.Tensor:
        b, lq = query.shape[:2]
        hh, lv, p = self.num_heads, self.num_levels, self.num_points
        v = self.value_proj(value).reshape(b, value.shape[1], hh, self.embed_dim // hh)
        offsets = self.sampling_offsets(query).reshape(b, lq, hh, lv, p, 2)
        attn = self.attention_weights(query).reshape(b, lq, hh, lv * p)
        attn = torch.softmax(attn.float(), dim=-1).to(query.dtype).reshape(b, lq, hh, lv, p)
        # box-conditioned sampling locations (reference_points last dim == 4)
        ref = reference_points[:, :, None, :, None, :]
        loc = ref[..., :2] + offsets / p * ref[..., 2:] * 0.5
        out = msda_forward(v, spatial_shapes, loc.contiguous(), attn)
        return self.output_proj(out)


class DecoderLayer(nn.Module):
    """Self-attn + deformable cross-attn + FFN (reference: fai_detr/modelling.py:887-958)."""

    def __init__(self, d_model: int = 256, n_head: int = 8, dim_feedforward: int = 1024, n_levels: int = 3,
                 n_points: int = 4):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_head)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformableAttention(d_model, n_head, n_levels, n_points)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, reference_points, memory, spatial_shapes, query_pos=None):
        q = tgt if query_pos is None else tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        ca = self.cross_attn(tgt if query_pos is None else tgt + query_pos, reference_points, memory, spatial_shapes)
        tgt = self.norm2(tgt + ca)
        ffn = self.linear2(F.relu(self.linear1(tgt)))
        return self.norm3(tgt + ffn)


def generate_anchors(
    spatial_shapes: Sequence[Tuple[int, int]], grid_size: float = 0.05, eps: float = 1e-2
) -> Tuple[np.ndarray, np.ndarray]:
    """Anchor logits + validity mask (reference: fai_detr/modelling.py:1169-1189)."""
    anchors = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
        gxy = (np.stack([gx, gy], -1) + 0.5) / np.array([w, h], np.float32)
        wh = np.ones_like(gxy) * grid_size * (2.0 ** (2 - lvl))
        anchors.append(np.concatenate([gxy, wh], -1).reshape(h * w, 4))
    a = np.concatenate(anchors, 0)  # [S, 4]
    valid = ((a > eps) & (a < 1 - eps)).all(-1, keepdims=True)  # [S, 1]
    a = np.log(a / (1 - a))
    a = np.where(valid, a, 0.0)
    return a.astype(np.float32), valid


@functools.lru_cache(maxsize=16)
def _anchor_tensors(spatial_shapes: Tuple[Tuple[int, int], ...], device: torch.device):
    """Per (shapes, device): anchors [1, S, 4] fp32 and validity [1, S, 1]
    bool, made once instead of copied to the device on every forward (as
    ordinary tensors even when first asked for under inference mode)."""
    a, valid = generate_anchors(spatial_shapes)
    with torch.inference_mode(False):
        return torch.from_numpy(a).to(device)[None], torch.from_numpy(valid).to(device)[None]


def _bias_init_with_prob(prior_prob: float) -> float:
    return float(-math.log((1 - prior_prob) / prior_prob))


class TransformerPredictor(nn.Module):
    """Query selection + iterative-refinement decoder
    (reference: fai_detr/modelling.py:1023-1263)."""

    def __init__(
        self,
        num_classes: int,
        in_channels: Sequence[int],
        hidden_dim: int = 256,
        num_queries: int = 300,
        nhead: int = 8,
        dec_layers: int = 6,
        dim_feedforward: int = 1024,
        num_levels: int = 3,
        num_decoder_points: int = 4,
    ):
        super().__init__()
        self.num_classes, self.num_queries = num_classes, num_queries
        self.input_proj = nn.ModuleList(ConvNorm(c, hidden_dim, 1, 1) for c in in_channels)
        self.decoder = nn.ModuleDict({"layers": nn.ModuleList(
            DecoderLayer(hidden_dim, nhead, dim_feedforward, num_levels, num_decoder_points)
            for _ in range(dec_layers)
        )})
        self.query_pos_head = MLP(4, 2 * hidden_dim, hidden_dim, 2)
        self.enc_output = nn.Sequential(nn.Linear(hidden_dim, hidden_dim), nn.LayerNorm(hidden_dim, eps=1e-5))
        self.enc_score_classifier = nn.Linear(hidden_dim, num_classes)
        self.enc_bbox_classifier = MLP(hidden_dim, hidden_dim, 4, 3)
        self.dec_score_classifier = nn.ModuleList(nn.Linear(hidden_dim, num_classes) for _ in range(dec_layers))
        self.dec_bbox_classifier = nn.ModuleList(MLP(hidden_dim, hidden_dim, 4, 3) for _ in range(dec_layers))

    def flatten_levels(self, feats: Sequence[torch.Tensor]):
        """[p5, p4, p3] NCHW → (memory [B, S, C], [(H_l, W_l), ...])."""
        tokens, spatial_shapes = [], []
        for proj, f in zip(self.input_proj, feats):
            x = proj(f)
            tokens.append(x.flatten(2).transpose(1, 2))
            spatial_shapes.append((int(x.shape[2]), int(x.shape[3])))
        return torch.cat(tokens, dim=1), spatial_shapes

    def select_queries(self, memory: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]]):
        """Encoder top-k query selection (reference :1191-1232) →
        (topk_idx [B, Q], target [B, Q, C], ref_unact [B, Q, 4] fp32,
        enc_topk_logits [B, Q, ncls], enc_topk_boxes [B, Q, 4])."""
        anchors, valid = _anchor_tensors(tuple(spatial_shapes), memory.device)
        out_mem = self.enc_output(memory * valid.to(memory.dtype))
        enc_logits = self.enc_score_classifier(out_mem)  # [B, S, ncls]
        enc_coord_unact = self.enc_bbox_classifier(out_mem).float() + anchors  # [B, S, 4]

        scores = enc_logits.max(dim=-1).values  # [B, S]
        # small inputs can have fewer anchor positions than queries: select
        # what exists and tile the rest (duplicates are harmless)
        k = min(self.num_queries, scores.shape[1])
        topk_idx = torch.topk(scores, k, dim=1).indices  # [B, k]
        if k < self.num_queries:
            topk_idx = topk_idx.repeat(1, -(-self.num_queries // k))[:, : self.num_queries]

        def gather_q(x):
            return torch.gather(x, 1, topk_idx[..., None].expand(-1, -1, x.shape[-1]))

        ref_unact = gather_q(enc_coord_unact)
        return topk_idx, gather_q(out_mem), ref_unact, gather_q(enc_logits), torch.sigmoid(ref_unact)

    def forward(self, feats: Sequence[torch.Tensor]) -> DETRAuxOutputs:
        memory, spatial_shapes = self.flatten_levels(feats)
        _, target, ref_unact, enc_topk_logits, enc_topk_boxes = self.select_queries(memory, spatial_shapes)

        # decoder with iterative refinement (reference :961-1020); one
        # query_pos_head shared by every layer
        dec_boxes, dec_logits = [], []
        ref_points = torch.sigmoid(ref_unact)
        output = target
        for i, layer in enumerate(self.decoder["layers"]):
            query_pos = self.query_pos_head(ref_points.to(output.dtype))
            output = layer(output, ref_points[:, :, None, :], memory, spatial_shapes, query_pos)
            delta = self.dec_bbox_classifier[i](output).float()
            ref_points = torch.sigmoid(delta + inverse_sigmoid(ref_points))
            dec_logits.append(self.dec_score_classifier[i](output).float())
            dec_boxes.append(ref_points)

        return DETRAuxOutputs(
            dec_logits=torch.stack(dec_logits),
            dec_boxes=torch.stack(dec_boxes),
            enc_logits=enc_topk_logits.float(),
            enc_boxes=enc_topk_boxes.float(),
        )


class FAIDetr(nn.Module):
    """RT-DETR top-level module (reference: fai_detr/modelling.py:1273-1358).

    ``forward(images NHWC uint8 or float) -> (DETRModelOutput, DETRAuxOutputs)``;
    normalization happens on the device.
    """

    def __init__(self, config: DETRConfig, backbone: BaseBackbone):
        super().__init__()
        cfg = self.config = config
        self.register_buffer("pixel_mean", torch.tensor(cfg.pixel_mean, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.pixel_std, dtype=torch.float32), persistent=False)
        self.pixel_decoder = HybridEncoder(
            backbone=backbone,
            feat_dim=cfg.pixel_decoder_feat_dim,
            out_dim=cfg.pixel_decoder_out_dim,
            nhead=cfg.pixel_decoder_nhead,
            dim_feedforward=cfg.pixel_decoder_dim_feedforward,
            num_encoder_layers=cfg.pixel_decoder_num_encoder_layers,
            expansion=cfg.pixel_decoder_expansion,
        )
        self.head = nn.ModuleDict({"predictor": TransformerPredictor(
            num_classes=cfg.num_classes,
            in_channels=[cfg.pixel_decoder_feat_dim] * 3,
            hidden_dim=cfg.transformer_predictor_hidden_dim,
            num_queries=cfg.num_queries,
            nhead=cfg.transformer_predictor_nhead,
            dec_layers=cfg.transformer_predictor_dec_layers,
            dim_feedforward=cfg.transformer_predictor_dim_feedforward,
        )})

    @property
    def predictor(self) -> TransformerPredictor:
        return self.head["predictor"]

    def encode(self, images: torch.Tensor) -> List[torch.Tensor]:
        """Normalize NHWC images and run backbone + hybrid encoder → [p5, p4, p3]."""
        x = (images.float() - self.pixel_mean) / self.pixel_std
        return self.pixel_decoder(x.permute(0, 3, 1, 2))

    def forward(self, images: torch.Tensor):
        aux = self.predictor(self.encode(images))
        boxes = box_cxcywh_to_xyxy(aux.dec_boxes[-1])
        logits = torch.sigmoid(aux.dec_logits[-1])
        return DETRModelOutput(boxes=boxes, logits=logits, loss=None), aux

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers: lecun-normal
        kernels, zero biases, unit norms, the MSDA grid init and the
        classifier prior bias. Draws on the CPU, so a seed gives the same
        weights on every device."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                _lecun_normal_(m.weight, m.weight[0].numel(), generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, MultiHeadAttention):
                for w in m.in_proj_weight.chunk(3):
                    _lecun_normal_(w, m.embed_dim, generator)
                m.in_proj_bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                m.reset_parameters()
        for m in self.modules():
            if isinstance(m, MSDeformableAttention):
                m.reset_sampling_parameters()
        cls_bias = _bias_init_with_prob(1.0 / (self.config.num_classes + 1))
        for lin in [self.predictor.enc_score_classifier, *self.predictor.dec_score_classifier]:
            lin.bias.fill_(cls_bias)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal in [-2, 2] std, variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    t = torch.empty(w.shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    w.copy_(t)
