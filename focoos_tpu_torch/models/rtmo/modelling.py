"""rtmo — one-stage multi-person pose estimation (RTMO) in PyTorch.

Port of ``focoos_tpu/models/rtmo/modelling.py`` (reference:
focoos/models/rtmo/{modelling,decoder,transformer,utils}.py): CSPDarknet →
hybrid encoder (AIFI transformer on res5 + RepVGG-CSP FPN/PAN, strided-conv
downsampling, nearest upsampling) → RTMO head (split cls/pose branches) →
grid decode + greedy NMS → DCC dynamic coordinate classifier (per-detection
1-D bin heatmaps refined by a gated attention unit).

The decode keeps the JAX package's static shapes: top-``nms_pre_topk``
candidates, the NMS keep mask, and DCC over ``max_detections`` slots with
suppressed slots at score 0. ``jax.vmap(decode_one)`` becomes batched tensor
code, so the NMS kernel (``ops/nms.py::nms_keep``) launches once per forward
for the whole batch. Parameter names are the reference's torch names, which
``focoos_tpu.utils.torch_convert.rtmo_rules`` maps. Images enter NHWC; conv
activations are NCHW. In training the forward stops at the raw per-anchor
outputs: the criterion (``loss.py``) assigns positives with SimOTA and runs
DCC once a step on the gathered positives, whose pose-to-keypoint BatchNorm
takes its statistics over the valid slots only (``MaskedBatchNorm1d``).

In a bf16 model (``compute_dtype``, ``nn/layers/common.py``) the dtypes are
flax's: the image is normalized in fp32, then cast; convolutions, dense
layers, attention and BatchNorm outputs are bf16; the AIFI LayerNorms are
fp32; the head's outputs are cast to fp32 (JAX :496-499), so the box decode,
the scores and NMS see fp32; DCC encodes its bins from fp32 positions and
decodes fp32 heatmaps (JAX :271-272, :374-380, :395-396).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from focoos_tpu_torch.models.rtmo.config import RTMOConfig
from focoos_tpu_torch.models.rtmo.ports import RTMOAuxOutputs, RTMOModelOutput
from focoos_tpu_torch.nn.backbone.base import BaseBackbone
from focoos_tpu_torch.nn.backbone.csp_darknet import ConvModule
from focoos_tpu_torch.nn.layers.common import (
    BatchNorm,
    ComputeDtype,
    Conv2d,
    LayerNorm,
    Linear,
    MaskedBatchNorm1d,
    MultiHeadAttention,
    constant_cache,
    init_like_flax_,
)
from focoos_tpu_torch.ops.nms import topk_nms

# ---------------------------------------------------------------------------
# positional encodings (reference: rtmo/transformer.py:9-120)
# ---------------------------------------------------------------------------


def spe_dim_t(out_channels: int, temperature: float) -> np.ndarray:
    pos_dim = out_channels // 2
    return temperature ** (np.arange(pos_dim, dtype=np.float32) / pos_dim)


def spe_1d(position: torch.Tensor, dim_t: torch.Tensor) -> torch.Tensor:
    """[..., P] positions → [..., P, C] (cos ‖ sin)."""
    freq = position[..., None] / dim_t
    return torch.cat([torch.cos(freq), torch.sin(freq)], dim=-1)


def spe_2d_grid(h: int, w: int, out_channels: int, temperature: float) -> np.ndarray:
    """2-D grid encoding → [H*W, 2*out_channels], laid out (h-enc ‖ w-enc),
    each cos ‖ sin (reference decoder.py:326). Not the layout of
    ``sine_position_embedding_2d``."""
    dim_t = spe_dim_t(out_channels, temperature)
    gh, gw = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
    fh = gh.reshape(-1)[:, None] / dim_t
    fw = gw.reshape(-1)[:, None] / dim_t
    enc_h = np.concatenate([np.cos(fh), np.sin(fh)], axis=-1)
    enc_w = np.concatenate([np.cos(fw), np.sin(fw)], axis=-1)
    return np.concatenate([enc_h, enc_w], axis=-1).astype(np.float32)


@constant_cache
def _spe_2d_tensor(h: int, w: int, out_channels: int, temperature: float, device: torch.device) -> torch.Tensor:
    """[1, H*W, 2*out_channels] on ``device``, made once per shape (as an
    ordinary tensor even when first asked for under inference mode)."""
    with torch.inference_mode(False):
        return torch.from_numpy(spe_2d_grid(h, w, out_channels, temperature)).to(device)[None]


# ---------------------------------------------------------------------------
# neck (reference: rtmo/decoder.py)
# ---------------------------------------------------------------------------


class ProjectionConv(nn.Module):
    """conv + BN(eps 1e-5), no activation (reference: decoder.py:54-94)."""

    def __init__(self, ch_in: int, ch_out: int, kernel_size: int = 1, stride: int = 1, padding: int = 0):
        super().__init__()
        self.conv = Conv2d(ch_in, ch_out, kernel_size, stride, padding, bias=False)
        self.bn = BatchNorm(ch_out, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class RepVGGBlock(nn.Module):
    """3x3 + 1x1 two-branch block with SiLU (reference: decoder.py:97-187)."""

    def __init__(self, ch_in: int, ch_out: int):
        super().__init__()
        self.branch_3x3 = ProjectionConv(ch_in, ch_out, 3, padding=1)
        self.branch_1x1 = ProjectionConv(ch_in, ch_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.branch_3x3(x) + self.branch_1x1(x))


class NeckCSPRepLayer(nn.Module):
    """CSP of RepVGG blocks (reference: decoder.py:190-232)."""

    def __init__(self, ch_in: int, ch_out: int, num_blocks: int = 1, widen_factor: float = 1.0):
        super().__init__()
        hidden = int(ch_out * widen_factor)
        self.conv1 = ConvModule(ch_in, hidden, 1)
        self.conv2 = ConvModule(ch_in, hidden, 1)
        self.bottlenecks = nn.Sequential(*(RepVGGBlock(hidden, hidden) for _ in range(num_blocks)))
        self.conv3 = ConvModule(hidden, ch_out, 1) if hidden != ch_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bottlenecks(self.conv1(x)) + self.conv2(x)
        return y if self.conv3 is None else self.conv3(y)


class DetrEncoderLayer(nn.Module):
    """Post-norm DETR encoder layer with an exact-GELU FFN (reference:
    transformer.py:383-430). Submodules ``self_attn.attn``,
    ``ffn.layers.{0.0,1}`` and ``norms.{0,1}`` carry the reference's names."""

    def __init__(self, embed_dims: int, num_heads: int, feedforward_channels: int = 1024):
        super().__init__()
        self.self_attn = nn.ModuleDict({"attn": MultiHeadAttention(embed_dims, num_heads)})
        self.ffn = nn.ModuleDict({"layers": nn.ModuleList([
            nn.Sequential(Linear(embed_dims, feedforward_channels), nn.GELU(approximate="none")),
            Linear(feedforward_channels, embed_dims),
        ])})
        self.norms = nn.ModuleList(LayerNorm(embed_dims, eps=1e-5) for _ in range(2))

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        q = x + pos
        x = self.norms[0](x + self.self_attn["attn"](q, q, x))
        f = self.ffn["layers"][1](self.ffn["layers"][0](x))
        return self.norms[1](x + f)


class RTMOHybridEncoder(nn.Module):
    """Neck (reference: rtmo/decoder.py:235-360): NCHW res3/res4/res5 → the
    projected maps at ``output_indices`` of [P8, P16, P32] ([P16, P32] for
    every registry config)."""

    def __init__(self, cfg: RTMOConfig, in_channels: Sequence[int]):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.hidden_dim
        self.input_proj = nn.ModuleList(ProjectionConv(c, hidden, 1) for c in in_channels)
        layers = [
            DetrEncoderLayer(cfg.transformer_embed_dims, cfg.transformer_num_heads, cfg.transformer_feedforward_channels)
            for _ in range(cfg.transformer_encoder_layers)
        ]
        self.encoder = nn.ModuleList([nn.ModuleDict({"layers": nn.ModuleList(layers)})] if layers else [])
        self.lateral_convs = nn.ModuleList(ConvModule(hidden, hidden, 1) for _ in range(2))
        self.fpn_blocks = nn.ModuleList(
            NeckCSPRepLayer(2 * hidden, hidden, cfg.csp_layers, cfg.widen_factor) for _ in range(2)
        )
        self.downsample_convs = nn.ModuleList(ConvModule(hidden, hidden, 3, stride=2, padding=1) for _ in range(2))
        self.pan_blocks = nn.ModuleList(
            NeckCSPRepLayer(2 * hidden, hidden, cfg.csp_layers, cfg.widen_factor) for _ in range(2)
        )
        self.projector = nn.ModuleDict({"convs": nn.ModuleList(
            ProjectionConv(hidden, cfg.output_dim, 1) for _ in cfg.output_indices
        )})

    def forward(self, feats: dict) -> List[torch.Tensor]:
        cfg = self.cfg
        proj = [p(feats[k]) for p, k in zip(self.input_proj, ("res3", "res4", "res5"))]

        # AIFI on res5
        if len(self.encoder):
            b, c, h, w = proj[2].shape
            tokens = proj[2].flatten(2).transpose(1, 2)
            pos = _spe_2d_tensor(h, w, cfg.hidden_dim // 2, float(cfg.pe_temperature), tokens.device).to(tokens.dtype)
            for layer in self.encoder[0]["layers"]:
                tokens = layer(tokens, pos)
            proj[2] = tokens.transpose(1, 2).reshape(b, c, h, w)

        # top-down FPN with torch-nearest upsampling
        inner = [proj[2]]
        for idx, low_i in enumerate((1, 0)):
            lat = self.lateral_convs[idx](inner[0])
            inner[0] = lat
            low = proj[low_i]
            up = F.interpolate(lat, size=tuple(low.shape[-2:]), mode="nearest")
            inner.insert(0, self.fpn_blocks[idx](torch.cat([up, low], dim=1)))

        # bottom-up PAN with strided-conv downsampling
        outs = [inner[0]]
        for idx in range(2):
            down = self.downsample_convs[idx](outs[-1])
            outs.append(self.pan_blocks[idx](torch.cat([down, inner[idx + 1]], dim=1)))
        return [proj(outs[i]) for proj, i in zip(self.projector["convs"], cfg.output_indices)]


# ---------------------------------------------------------------------------
# head (reference: rtmo/modelling.py:195-380)
# ---------------------------------------------------------------------------


class RTMOHeadModule(nn.Module):
    """Per level: split the channels into a cls half and a pose half; the
    pose branch's layers after the first are grouped convs (8 groups)."""

    def __init__(self, cfg: RTMOConfig, in_channels: int, num_levels: int):
        super().__init__()
        self.cfg = cfg
        wf = cfg.widen_factor
        half = in_channels // 2
        cls_ch = int(cfg.cls_feat_channels * wf)
        pose_ch = 8 * int(wf * 36)  # num_groups * channels_per_group
        self.conv_cls = nn.ModuleList(
            nn.Sequential(*(ConvModule(half if s == 0 else cls_ch, cls_ch, 3, padding=1)
                            for s in range(cfg.stacked_convs)))
            for _ in range(num_levels)
        )
        self.conv_pose = nn.ModuleList(
            nn.Sequential(*(ConvModule(half if s == 0 else pose_ch, pose_ch, 3, padding=1, groups=1 if s == 0 else 8)
                            for s in range(cfg.stacked_convs * 2)))
            for _ in range(num_levels)
        )
        self.out_cls = nn.ModuleList(Conv2d(cls_ch, cfg.num_classes, 1) for _ in range(num_levels))
        self.out_bbox = nn.ModuleList(Conv2d(pose_ch, 4, 1) for _ in range(num_levels))
        self.out_kpt_reg = nn.ModuleList(Conv2d(pose_ch, cfg.num_keypoints * 2, 1) for _ in range(num_levels))
        self.out_kpt_vis = nn.ModuleList(Conv2d(pose_ch, cfg.num_keypoints, 1) for _ in range(num_levels))
        self.out_pose = (
            nn.ModuleList(Conv2d(pose_ch, cfg.pose_vec_channels, 1) for _ in range(num_levels))
            if cfg.pose_vec_channels > 0 else None
        )
        self.pose_feat_channels = cfg.pose_vec_channels if cfg.pose_vec_channels > 0 else pose_ch

    def forward(self, xs: Sequence[torch.Tensor]):
        cls_scores, bbox_preds, kpt_offsets, kpt_vis, pose_feats = [], [], [], [], []
        for i, x in enumerate(xs):
            half = x.shape[1] // 2
            cls_feat = self.conv_cls[i](x[:, :half])
            reg_feat = self.conv_pose[i](x[:, half:])
            cls_scores.append(self.out_cls[i](cls_feat))
            bbox_preds.append(self.out_bbox[i](reg_feat))
            kpt_offsets.append(self.out_kpt_reg[i](reg_feat))
            kpt_vis.append(self.out_kpt_vis[i](reg_feat))
            pose_feats.append(reg_feat if self.out_pose is None else self.out_pose[i](reg_feat))
        return cls_scores, bbox_preds, kpt_offsets, kpt_vis, pose_feats


# ---------------------------------------------------------------------------
# DCC (reference: rtmo/modelling.py:383-668) + GAU (:46-193)
# ---------------------------------------------------------------------------


class ScaleNorm(nn.Module):
    """x / clip(sqrt(Σx² + 1e-12)·d^-0.5, 1e-5) · g (reference :46-80)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = dim**-0.5
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(x.float().square().sum(-1, keepdim=True) + 1e-12) * self.scale
        return x / norm.clamp(min=1e-5).to(x.dtype) * self.g.to(x.dtype)


class Scale(nn.Module):
    """Learnable per-channel (or scalar) multiplier."""

    def __init__(self, shape: Tuple[int, ...], value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full(shape, value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


class GAUEncoder(nn.Module):
    """Gated attention unit over the keypoint axis (reference :46-193):
    ScaleNorm → uv (u ‖ v ‖ base) → relu(qk/√s)² attention → gated output."""

    def __init__(self, s: int = 128, token_dims: int = 128, expansion_factor: int = 2):
        super().__init__()
        self.s = s
        self.e = int(token_dims * expansion_factor)
        self.ln = ScaleNorm(token_dims)
        self.uv = Linear(token_dims, 2 * self.e + s, bias=False)
        self.gamma = nn.Parameter(torch.rand(2, s))
        self.beta = nn.Parameter(torch.rand(2, s))
        self.o = Linear(self.e, token_dims, bias=False)
        self.res_scale = Scale((token_dims,))

    def forward(self, x: torch.Tensor, pos_enc: Optional[torch.Tensor] = None) -> torch.Tensor:
        uv = F.silu(self.uv(self.ln(x)))
        u, v, base = torch.split(uv, [self.e, self.e, self.s], dim=-1)
        q = base * self.gamma[0].to(base.dtype) + self.beta[0].to(base.dtype)
        k = base * self.gamma[1].to(base.dtype) + self.beta[1].to(base.dtype)
        if pos_enc is not None:
            q = q + pos_enc.to(q.dtype)
            k = k + pos_enc.to(k.dtype)
        qk = torch.einsum("...ks,...ls->...kl", q, k)
        kernel = torch.square(F.relu(qk / math.sqrt(float(self.s))))
        out = self.o(u * torch.einsum("...kl,...le->...ke", kernel, v))
        return self.res_scale(x) + out


class DCC(nn.Module):
    """Dynamic coordinate classifier (reference :383-668). In eval the
    pose-to-keypoint BatchNorm uses its running statistics; in training
    (the criterion's call) its statistics are taken over the rows ``mask``
    marks valid."""

    def __init__(self, cfg: RTMOConfig, in_channels: int):
        super().__init__()
        self.cfg = cfg
        k, f = cfg.num_keypoints, cfg.feat_channels_dcc
        nx, ny = cfg.num_bins
        self.register_buffer("x_bins_base", torch.from_numpy(np.linspace(-0.5, 0.5, nx).astype(np.float32)), persistent=False)
        self.register_buffer("y_bins_base", torch.from_numpy(np.linspace(-0.5, 0.5, ny).astype(np.float32)), persistent=False)
        self.register_buffer("spe_dim", torch.from_numpy(spe_dim_t(cfg.spe_channels, 300.0)), persistent=False)
        self.x_fc = Linear(cfg.spe_channels, f)
        self.y_fc = Linear(cfg.spe_channels, f)
        # learnable per-keypoint sigma (the MLE loss's target width)
        self.sigma_fc = nn.Sequential(Linear(in_channels, k), nn.Sigmoid(), Scale((), 0.1))
        # the BatchNorm computes in fp32 and returns the dense layer's dtype (JAX _MaskedBatchNorm)
        self.pose_to_kpts = nn.Sequential(Linear(in_channels, f * k), MaskedBatchNorm1d(f * k, eps=1e-5))
        self.pos_enc = nn.Parameter(torch.randn(k, cfg.gau_s))
        self.gau = GAUEncoder(s=cfg.gau_s, token_dims=f, expansion_factor=cfg.gau_expansion_factor)

    def forward(self, pose_feats: torch.Tensor, bbox_cs: torch.Tensor, grids: torch.Tensor,
                mask: Optional[torch.Tensor] = None):
        """pose_feats [..., C_pose]; bbox_cs [..., 4] (cx, cy, sw, sh);
        grids [..., 2]; ``mask`` [...] the rows whose train statistics count
        → (keypoints [..., K, 2] abs, (x_probs, y_probs), sigmas [..., K])."""
        k, f = self.cfg.num_keypoints, self.cfg.feat_channels_dcc
        center, scale = bbox_cs[..., :2], bbox_cs[..., 2:]
        # bins encoded relative to the grid point ...
        rel_center = center - grids
        x_bins = self.x_bins_base * scale[..., 0:1] + rel_center[..., 0:1]  # [..., NX]
        y_bins = self.y_bins_base * scale[..., 1:2] + rel_center[..., 1:2]
        x_bins_enc = self.x_fc(spe_1d(x_bins, self.spe_dim).float())
        y_bins_enc = self.y_fc(spe_1d(y_bins, self.spe_dim).float())

        sigmas = self.sigma_fc[2](torch.sigmoid(self.sigma_fc[0](pose_feats).float()))

        lin, bn = self.pose_to_kpts
        kf = lin(pose_feats)
        kf = bn(kf, mask=mask).reshape(*kf.shape[:-1], k, f)
        kf = self.gau(kf, pos_enc=self.pos_enc)

        x_hms = torch.einsum("...kf,...bf->...kb", kf, x_bins_enc).float().clamp(-5e4, 5e4)
        y_hms = torch.einsum("...kf,...bf->...kb", kf, y_bins_enc).float().clamp(-5e4, 5e4)
        px = torch.softmax(x_hms, dim=-1)
        py = torch.softmax(y_hms, dim=-1)

        # ... and decoded over ABSOLUTE bins (center, not rel_center; reference :575-585)
        x_bins_abs = self.x_bins_base * scale[..., 0:1] + center[..., 0:1]
        y_bins_abs = self.y_bins_base * scale[..., 1:2] + center[..., 1:2]
        x = (px * x_bins_abs[..., None, :]).sum(-1)
        y = (py * y_bins_abs[..., None, :]).sum(-1)
        return torch.stack([x, y], dim=-1), (px, py), sigmas

    def target_heatmaps(self, kpt_targets: torch.Tensor, bbox_cs: torch.Tensor, sigmas: torch.Tensor,
                        areas: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Laplacian target heatmaps over the ABSOLUTE bins (reference
        :587-623; JAX ``DCC.target_heatmaps``): kpt_targets [..., K, 2],
        bbox_cs [..., 4], sigmas [..., K], areas [...] → (hm_x [..., K, NX],
        hm_y [..., K, NY]), with ``a = clip(sqrt(area), 1)`` and ``s = clip(sigma, 1e-3)``."""
        center, scale = bbox_cs[..., :2], bbox_cs[..., 2:]
        x_bins = self.x_bins_base * scale[..., 0:1] + center[..., 0:1]  # [..., NX]
        y_bins = self.y_bins_base * scale[..., 1:2] + center[..., 1:2]
        dist_x = (kpt_targets[..., 0:1] - x_bins[..., None, :]).abs()  # [..., K, NX]
        dist_y = (kpt_targets[..., 1:2] - y_bins[..., None, :]).abs()
        a = torch.sqrt(areas.clamp(min=0.0)).clamp(min=1.0)[..., None, None]
        s = sigmas.clamp(min=1e-3)[..., None]
        dist_x = dist_x / a / s
        dist_y = dist_y / a / s
        return torch.exp(-dist_x / 2) / s, torch.exp(-dist_y / 2) / s


# ---------------------------------------------------------------------------
# priors
# ---------------------------------------------------------------------------


def grid_priors(
    featmap_sizes: Sequence[Tuple[int, int]], strides: Sequence[int], centralize: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Grid priors → (priors [A, 2] abs xy, strides [A]); levels in order,
    row-major. Offset 0.5·stride (cell centres) unless ``centralize``, which
    shifts by (stride-1)/2 instead (reference loss.py:36,142)."""
    pts, sts = [], []
    for (h, w), s in zip(featmap_sizes, strides):
        off = 0.0 if centralize else 0.5
        xs = (np.arange(w, dtype=np.float32) + off) * s
        ys = (np.arange(h, dtype=np.float32) + off) * s
        if centralize:
            xs += (s - 1) / 2.0
            ys += (s - 1) / 2.0
        gx, gy = np.meshgrid(xs, ys)
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1))
        sts.append(np.full((h * w,), s, np.float32))
    return np.concatenate(pts), np.concatenate(sts)


@constant_cache
def _prior_tensors(featmap_sizes: Tuple[Tuple[int, int], ...], strides: Tuple[int, ...], centralize: bool,
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    with torch.inference_mode(False):
        priors, sts = grid_priors(featmap_sizes, strides, centralize)
        return torch.from_numpy(priors).to(device), torch.from_numpy(sts).to(device)


# ---------------------------------------------------------------------------
# top-level model
# ---------------------------------------------------------------------------


class RTMO(ComputeDtype, nn.Module):
    """RTMO top-level module (reference: rtmo/modelling.py:1506-1666).

    ``forward(images NHWC uint8 or float) -> (RTMOModelOutput, RTMOAuxOutputs)``
    in eval, ``(None, RTMOAuxOutputs)`` in training; normalization happens on
    the device, in fp32, before the cast to the compute dtype (JAX :473-476).
    The training forward runs no DCC: the criterion runs it once a step on
    the gathered positives, so DCC's running statistics move once a step (JAX
    binds DCC on dummy slots here only to create its variables, in eval mode).
    """

    def __init__(self, config: RTMOConfig, backbone: BaseBackbone):
        super().__init__()
        cfg = self.config = config
        self.register_buffer("pixel_mean", torch.tensor(cfg.pixel_mean, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.pixel_std, dtype=torch.float32), persistent=False)
        self.backbone = backbone
        shapes = backbone.output_shape()
        self.neck = RTMOHybridEncoder(cfg, [shapes[k].channels for k in ("res3", "res4", "res5")])
        head = RTMOHeadModule(cfg, cfg.output_dim, len(cfg.output_indices))
        self.head = nn.ModuleDict({"head_module": head, "dcc": DCC(cfg, head.pose_feat_channels)})

    def raw_outputs(self, images: torch.Tensor) -> RTMOAuxOutputs:
        """Normalize, backbone, neck, head → flattened per-anchor predictions."""
        cfg = self.config
        x = ((images.float() - self.pixel_mean) / self.pixel_std).to(self.compute_dtype).permute(0, 3, 1, 2)
        ms = self.neck(self.backbone(x))
        cls_scores, bbox_preds, kpt_offsets, kpt_vis, pose_feats = self.head["head_module"](ms)
        featmap_sizes = tuple((int(m.shape[2]), int(m.shape[3])) for m in ms)
        priors, strides = _prior_tensors(
            featmap_sizes, tuple(cfg.featmap_strides_pointgenerator), cfg.centralize_points_pointgenerator, x.device
        )

        def flat(xs):
            return torch.cat([t.flatten(2).transpose(1, 2) for t in xs], dim=1)

        return RTMOAuxOutputs(
            cls_scores=flat(cls_scores).float(),
            bbox_preds=flat(bbox_preds).float(),
            kpt_offsets=flat(kpt_offsets).float(),
            kpt_vis=flat(kpt_vis).float(),
            pose_feats=flat(pose_feats),
            priors=priors,
            strides=strides,
        )

    @staticmethod
    def candidates(aux: RTMOAuxOutputs):
        """Per anchor: (boxes [B, A, 4] xyxy abs, max score [B, A], label [B, A])
        (reference RTMOHead.predict :1357-1479, decode_bbox utils.py:190)."""
        scores_all = torch.sigmoid(aux.cls_scores)
        xys = aux.bbox_preds[..., :2] * aux.strides[None, :, None] + aux.priors[None]
        whs = torch.exp(aux.bbox_preds[..., 2:]) * aux.strides[None, :, None]
        boxes = torch.cat([xys - whs / 2, xys + whs / 2], dim=-1)
        return boxes, scores_all.max(-1).values, scores_all.argmax(-1)

    def forward(self, images: torch.Tensor):
        cfg = self.config
        aux = self.raw_outputs(images)
        if self.training:
            return None, aux
        boxes, scores, labels = self.candidates(aux)
        # one batched NMS launch for every image
        idx, valid, out_scores = topk_nms(
            boxes, scores, cfg.nms_pre_topk, cfg.nms_thr, cfg.max_detections, cfg.score_thr
        )

        def take(x):
            return torch.gather(x, 1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(-1, -1, *x.shape[2:]))

        sel_boxes = take(boxes)
        sel_vis = take(torch.sigmoid(aux.kpt_vis))
        sel_grids = aux.priors[idx]

        # bbox → center/scale with padding 1.25 (reference bbox_xyxy2cs :113)
        bbox_cs = torch.cat([(sel_boxes[..., 2:] + sel_boxes[..., :2]) * 0.5,
                             (sel_boxes[..., 2:] - sel_boxes[..., :2]) * 1.25], dim=-1)
        keypoints, _, _ = self.head["dcc"](take(aux.pose_feats), bbox_cs, sel_grids)

        out_scores = out_scores * valid.float()
        out = RTMOModelOutput(
            scores=out_scores,
            labels=take(labels),
            boxes=sel_boxes,
            boxes_scores=out_scores,
            keypoints=keypoints,
            keypoints_scores=sel_vis,
            keypoints_visible=sel_vis,
            loss=None,
        )
        return out, aux

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers: lecun-normal
        kernels, zero biases, unit norms, the classifier prior bias
        -log(99), uniform GAU gamma/beta, normal keypoint position encoding.
        Draws on the CPU, so a seed gives the same weights on every device."""
        init_like_flax_(self, generator)
        dcc = self.head["dcc"]
        dcc.gau.gamma.copy_(torch.rand(dcc.gau.gamma.shape, generator=generator))
        dcc.gau.beta.copy_(torch.rand(dcc.gau.beta.shape, generator=generator))
        dcc.gau.ln.g.fill_(1.0)
        dcc.gau.res_scale.scale.fill_(1.0)
        dcc.pos_enc.copy_(torch.randn(dcc.pos_enc.shape, generator=generator))
        dcc.sigma_fc[2].scale.fill_(0.1)
        cls_bias = float(-math.log((1 - 0.01) / 0.01))
        for conv in self.head["head_module"].out_cls:
            conv.bias.fill_(cls_bias)
