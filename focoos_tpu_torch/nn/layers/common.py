"""Shared NN building blocks (PyTorch).

Port of the subset of ``focoos_tpu/nn/layers/common.py`` the fai_detr serving
path uses. Convolutions take NCHW tensors (the port's internal layout; an NHWC
tensor permuted to NCHW is a channels-last view and needs no copy); sequence
layers take ``[B, L, C]``. Parameter names follow the reference's torch
modules, so ``focoos_tpu.utils.torch_convert`` maps a port ``state_dict`` onto
the JAX variables. The TPU-only stem convs, the int8 QDQ paths and
``FREEZE_ALL_BN`` are not ported here.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation registry (reference: focoos/nn/layers/base.py:get_activation_fn)."""
    if name is None or name == "identity":
        return lambda x: x
    table = {
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="none"),
        "silu": F.silu,
        "swish": F.silu,
        "glu": lambda x: F.glu(x, dim=-1),
        "leaky_relu": F.leaky_relu,
        "sigmoid": torch.sigmoid,
        "hardsigmoid": F.hardsigmoid,
        "relu6": F.relu6,
    }
    if name not in table:
        raise ValueError(f"activation must be one of {sorted(table)}, not {name}")
    return table[name]


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW, eps 1e-5. ``frozen=True`` is the reference's
    FrozenBatchNorm2d (focoos/nn/layers/norm.py:6): running statistics always,
    even in train mode. The state_dict keys are BatchNorm2d's either way."""

    def __init__(self, num_features: int, frozen: bool = False):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.frozen = frozen

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.frozen:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        return super().forward(x)


def get_norm(norm: Optional[str], channels: int) -> Optional[nn.Module]:
    """Norm-layer factory for the norms the slice uses (reference: focoos/nn/layers/norm.py:209)."""
    if norm is None or norm == "":
        return None
    if norm in ("BN", "FrozenBN"):
        return BatchNorm(channels, frozen=norm == "FrozenBN")
    raise ValueError(f"Unsupported norm in the port: {norm}")


class ConvNorm(nn.Module):
    """Conv2d (no bias) + norm + activation (reference:
    focoos/nn/layers/conv.py:ConvNormLayer). Padding is ``(k - 1) // 2`` unless given."""

    def __init__(
        self,
        ch_in: int,
        ch_out: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: Optional[int] = None,
        norm: Optional[str] = "BN",
        act: Optional[str] = None,
    ):
        super().__init__()
        pad = (kernel_size - 1) // 2 if padding is None else padding
        self.conv = nn.Conv2d(ch_in, ch_out, kernel_size, stride, pad, bias=False)
        self.norm = get_norm(norm, ch_out)
        self.act = get_activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return self.act(x)


class MLP(nn.Module):
    """Linear→ReLU→…→Linear stack (reference: focoos/nn/layers/base.py:MLP)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MultiHeadAttention(nn.Module):
    """Multi-head attention with torch ``nn.MultiheadAttention``'s merged
    ``in_proj_weight``/``in_proj_bias`` storage; plain matmuls with the
    softmax in fp32, as the JAX layer computes it (common.py:298-304)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        e, h = self.embed_dim, self.num_heads
        hd = e // h
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = F.linear(query, wq, bq).unflatten(-1, (h, hd))
        k = F.linear(key, wk, bk).unflatten(-1, (h, hd))
        v = F.linear(value, wv, bv).unflatten(-1, (h, hd))
        logits = torch.einsum("...qhd,...khd->...hqk", q * hd**-0.5, k)
        weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out = torch.einsum("...hqk,...khd->...qhd", weights, v).flatten(-2)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Post-norm transformer encoder layer
    (reference: focoos/nn/layers/transformer.py:553, normalize_before=False)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048, activation: str = "relu"):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.activation = get_activation(activation)

    def forward(self, src: torch.Tensor, pos_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = src if pos_embed is None else src + pos_embed
        src = self.norm1(src + self.self_attn(q, q, src))
        return self.norm2(src + self.linear2(self.activation(self.linear1(src))))


def sine_position_embedding_2d(
    h: int,
    w: int,
    num_pos_feats: int,
    temperature: float = 10000.0,
    device: Optional[torch.device] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Non-normalized 2-D sine position embedding → [H*W, 2*num_pos_feats],
    concat order (sin(y), cos(y), sin(x), cos(x)), each interleave-sliced
    (reference: focoos/models/fai_detr/modelling.py:110-179)."""
    y = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)
    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    out = torch.cat(
        [
            torch.sin(pos_y[:, :, 0::2]).reshape(h * w, -1),
            torch.cos(pos_y[:, :, 1::2]).reshape(h * w, -1),
            torch.sin(pos_x[:, :, 0::2]).reshape(h * w, -1),
            torch.cos(pos_x[:, :, 1::2]).reshape(h * w, -1),
        ],
        dim=-1,
    )
    return out.to(dtype)


def bilinear_resize(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear NCHW resize with half-pixel centers and no antialiasing — the
    same sampling as the JAX package's ``jax.image.resize(..., antialias=False)``."""
    return F.interpolate(x, size=(int(size[0]), int(size[1])), mode="bilinear", align_corners=False, antialias=False)
