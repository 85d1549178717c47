"""Shared NN building blocks (PyTorch).

Port of the subset of ``focoos_tpu/nn/layers/common.py`` that the fai_detr,
rtmo and fai_mf paths use. Convolutions take NCHW tensors (the port's internal layout; an NHWC
tensor permuted to NCHW is a channels-last view and needs no copy); sequence
layers take ``[B, L, C]``. Parameter names follow the reference's torch
modules, so ``focoos_tpu.utils.torch_convert`` maps a port ``state_dict`` onto
the JAX variables. The TPU-only stem convs and ``FREEZE_ALL_BN`` are not
ported here.

Int8 QDQ (JAX :50-102, :219-230, :504-630): a ``ConvNorm`` and an
``Int8Linear`` (the JAX package's ``Int8Dense`` sites) compute their product
in int8 in eval once ``set_int8_mode`` switched them on. Weights take
per-output-channel symmetric scales, the input one per-tensor scale (the
calibrated one where the layer has it, else ``max|x| / 127``, both floored at
1e-12); ``clip(round(x / sx), -127, 127)`` rounds half to even, as
``jnp.round``; the s8 x s8 → s32 product is ``ops/int8.py``'s; then
``acc * (sx * sw)`` in that order, plus the bias, in fp32, cast to the
compute dtype. The mode is a flag on each module, no global; train mode
always computes in float.

Compute dtype (the JAX package's precision policy, flax's ``dtype=``): the
parameters stay fp32. A layer that the JAX package builds with
``dtype=self.dtype`` is a ``ComputeDtype`` here (``Linear``, ``Conv2d``,
``BatchNorm``, ``MultiHeadAttention``): it casts its input and its weights to
``compute_dtype`` at the call and returns that dtype, the BatchNorm with its
statistics in fp32. A layer built without ``dtype`` (the decoders' and AIFI's
LayerNorms) computes and returns fp32, as flax promotes it. ``set_compute_dtype``
sets the dtype on every such layer of a model once (default fp32). No autocast:
the CPU and the card run the same dtypes.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from focoos_tpu_torch.ops.int8 import int8_conv2d, int8_matmul
from focoos_tpu_torch.parallel import mesh


class ComputeDtype:
    """Mixin of the layers that compute in ``compute_dtype``."""

    compute_dtype: torch.dtype = torch.float32

    def cast(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Parameter ``t`` of this layer in the compute dtype. In a forward that
        records no gradient (serving) the cast copy is kept and reused while
        ``t`` is unchanged, the same storage at the same version (an optimizer
        step, ``load_state_dict`` or ``.to()`` changes one of them), which
        saves a launch per weight and forward."""
        dt = self.compute_dtype
        if t is None or t.dtype == dt:
            return t
        if torch.is_grad_enabled() or torch.compiler.is_exporting():  # a traced weight is fake: no data pointer
            return t.to(dt)
        key = (t.data_ptr(), t._version, t.device, dt)
        cache = self.__dict__.setdefault("_cast_cache", {})
        hit = cache.get(id(t))
        if hit is None or hit[0] != key:
            with torch.inference_mode(False):  # an ordinary tensor, usable outside inference mode too
                hit = cache[id(t)] = (key, t.detach().to(dt))
        return hit[1]


def constant_cache(fn: Callable) -> Callable:
    """``functools.lru_cache(16)`` for a function that makes constant tensors
    (anchors, position grids), bypassed while ``torch.export`` traces: its
    tensors are fake there, and the program keeps them as constants."""
    cached = functools.lru_cache(maxsize=16)(fn)

    @functools.wraps(fn)
    def wrapper(*args):
        return fn(*args) if torch.compiler.is_exporting() else cached(*args)

    return wrapper


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Set ``compute_dtype`` on every ``ComputeDtype`` layer of ``module``."""
    for m in module.modules():
        if isinstance(m, ComputeDtype):
            m.compute_dtype = dtype
    clear_cast_caches(module)


def clear_cast_caches(module: nn.Module) -> None:
    """Drop the cast copies ``ComputeDtype.cast`` keeps of ``module``'s weights."""
    for m in module.modules():
        m.__dict__.pop("_cast_cache", None)


class Linear(ComputeDtype, nn.Linear):
    """``nn.Linear`` in the compute dtype (flax ``nn.Dense(dtype=...)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.compute_dtype), self.cast(self.weight), self.cast(self.bias))


class Conv2d(ComputeDtype, nn.Conv2d):
    """``nn.Conv2d`` in the compute dtype (flax ``nn.Conv(dtype=...)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x.to(self.compute_dtype), self.cast(self.weight), self.cast(self.bias))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm()`` without ``dtype``: it computes and returns the
    promotion of the input's dtype and its scale's, so fp32 statistics and
    output for a bf16 input with fp32 parameters (fp64 for a model cast to fp64)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(torch.promote_types(x.dtype, self.weight.dtype)))


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


class BatchNorm(ComputeDtype, nn.BatchNorm2d):
    """BatchNorm over NCHW with flax's train-mode semantics
    (focoos_tpu/nn/layers/common.py:120-143): normalize with the biased batch
    variance and move the running statistics ``momentum`` of the way to the
    batch mean and the *biased* variance (torch's ``momentum`` is 1 - flax's:
    the default 0.1 is flax's 0.9, the JAX package's default; YOLO-style
    layers take eps 1e-3 and 0.03, flax's 0.97). ``frozen=True`` is the
    reference's FrozenBatchNorm2d (focoos/nn/layers/norm.py:6): running
    statistics always, even in train mode. The state_dict keys are
    BatchNorm2d's either way. As flax's BatchNorm with ``dtype``, statistics
    and normalization are fp32 (torch's batch_norm takes a bf16 input with
    fp32 parameters and computes in fp32) and the output is in the compute
    dtype.

    In training with the batch split over more than one rank, the statistics
    are the global batch's, as under JAX's data mesh (``global_moments``)."""

    def __init__(self, num_features: int, frozen: bool = False, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.frozen = frozen

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.frozen or not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
            return y.to(self.compute_dtype)
        if mesh.data_parallel():
            xf = x.to(torch.promote_types(x.dtype, torch.float32))  # fp32 statistics, fp64 for a model in fp64
            mean, var = global_moments(xf, (0,) + tuple(range(2, x.dim())))
            self._move_running(mean.reshape(-1), var.reshape(-1))
            shape = mean.shape
            y = (xf - mean) * torch.rsqrt(var + self.eps)
            return (y * self.weight.float().reshape(shape) + self.bias.float().reshape(shape)).to(self.compute_dtype)
        m, n = self.momentum, x.numel() // x.shape[1]
        # torch moves the running variance to (1-m)·old + m·var·n/(n-1), the
        # unbiased variance, in a copy the graph keeps; the n/(n-1) comes back
        # out per channel (no second pass over x)
        moved = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, moved, self.weight, self.bias, True, m, self.eps)
        with torch.no_grad():
            old = self.running_var
            self.running_var.copy_((moved - (1 - m) * old) * ((n - 1) / n) + (1 - m) * old)
        return y.to(self.compute_dtype)

    @torch.no_grad()
    def _move_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """flax's moving averages, of the mean and of the biased variance."""
        m = self.momentum
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var + m * var)


def global_moments(x: torch.Tensor, dims: Tuple[int, ...], w: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased variance) of fp32 ``x`` over ``dims`` (kept, size 1) and
    over every rank's batch, weighted by ``w`` (0 or 1, broadcast against
    ``x``) where given, the count floored at 1. Two passes, each one
    ``all_reduce`` that the gradient flows back through
    (``parallel.mesh.all_reduce_sum``): the sums with the count, then the
    squared deviations from the global mean (the port's two-pass variance:
    flax's E[x²] - E[x]² cancels in fp32)."""
    xw = x if w is None else x * w
    count = x.new_full((1,), x.numel() // math.prod(x.shape[d] for d in range(x.dim()) if d not in dims)) \
        if w is None else w.sum().reshape(1)
    sums = xw.sum(dims, keepdim=True)
    first = mesh.all_reduce_sum(torch.cat([sums.reshape(-1), count]))
    n = first[-1].clamp(min=1.0)
    mean = (first[:-1] / n).reshape(sums.shape)
    dev = (x - mean).square()
    var = mesh.all_reduce_sum((dev if w is None else dev * w).sum(dims, keepdim=True)) / n
    return mean, var


class MaskedBatchNorm1d(nn.BatchNorm1d):
    """BatchNorm over the last axis whose train statistics can be restricted
    to valid rows (JAX rtmo ``_MaskedBatchNorm``, modelling.py:295-335):
    rtmo's criterion runs DCC on a fixed number of gathered positives, and the
    padding slots must stay out of the statistics, which the reference never
    sees (it runs DCC on exactly the positives). In training the mean and the
    *biased* variance are taken over the rows where ``mask`` is true (every
    row without a mask), each divided by max(Σmask, 1), and the running
    statistics move flax's way (``momentum`` 0.1 is flax's 0.9); in eval,
    and when ``frozen`` (the trainer's ``freeze_bn``, as JAX's
    ``bn_use_running``), the running statistics normalize. Statistics and
    normalization are fp32; the output takes the input's dtype. The
    state_dict keys are BatchNorm1d's. With the batch split over more than
    one rank, the statistics count the valid rows of every rank
    (``global_moments``)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.frozen = False

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.float().reshape(-1, x.shape[-1])
        if self.training and not self.frozen:
            mean, var = global_moments(xf, (0,), None if mask is None else mask.to(torch.float32).reshape(-1, 1))
            mean, var = mean[0], var[0]
            BatchNorm._move_running(self, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight.float() + self.bias.float()
        return y.to(x.dtype).reshape(x.shape)


def get_norm(norm: Optional[str], channels: int) -> Optional[nn.Module]:
    """Norm-layer factory for the norms the slice uses (reference: focoos/nn/layers/norm.py:209)."""
    if norm is None or norm == "":
        return None
    if norm in ("BN", "FrozenBN"):
        return BatchNorm(channels, frozen=norm == "FrozenBN")
    raise ValueError(f"Unsupported norm in the port: {norm}")


# absmax / 127 as the JAX package's compiled graph computes it: XLA turns a
# division by the constant 127 into a product with its fp32 reciprocal, which
# lands one ulp off the quotient for ~4% of inputs (and a scale one ulp off
# moves the inputs that sit on a rounding edge to the next int8 step)
_INV_127 = 1.0 / 127.0


class Int8QDQ:
    """Mixin of the layers with an int8 QDQ product (``ConvNorm``,
    ``Int8Linear``): the state ``set_int8_mode`` sets, the weight's int8
    copy and the input's quantization."""

    int8: bool = False  # switched on by set_int8_mode; read in eval only
    calibrating: bool = False  # record the input absmax of each forward
    act_scale: Optional[torch.Tensor] = None  # calibrated static input scale; None: dynamic
    absmax: Optional[torch.Tensor] = None  # the largest input absmax while calibrating

    def int8_active(self) -> bool:
        return self.int8 and not self.training

    def quantized_weight(self, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(int8 weight, fp32 scales [O]) of ``w`` [O, ...]: absmax over all
        but the output axis / 127, floored at 1e-12, and ``round(w / sw)``;
        kept while ``w`` is unchanged (same storage, same version)."""
        key = (w.data_ptr(), w._version, w.device)
        hit = self.__dict__.get("_int8_weight")
        if hit is None or hit[0] != key:
            with torch.no_grad(), torch.inference_mode(False):
                wf = w.detach().float()
                sw = torch.clamp_min(wf.abs().amax(dim=tuple(range(1, w.dim()))) * _INV_127, 1e-12)
                wq = torch.round(wf / sw.reshape(-1, *[1] * (w.dim() - 1))).to(torch.int8)
            hit = self.__dict__["_int8_weight"] = (key, (wq, sw))
        return hit[1]

    def quantized_input(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(int8 x, its fp32 scale) with the calibrated scale or the dynamic one."""
        xf = x.float()
        if self.act_scale is None:
            m = xf.abs().amax()
            if self.calibrating:
                self.absmax = m if self.absmax is None else torch.maximum(self.absmax, m)
            sx = m * _INV_127
        else:
            sx = self.act_scale
        sx = torch.clamp_min(sx, 1e-12)
        return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


class Int8Linear(Int8QDQ, Linear):
    """``Linear`` at the JAX package's ``Int8Dense`` sites (JAX common.py:579):
    float unless ``set_int8_mode`` switched it on, then, in eval, an int8 QDQ
    product over the last axis."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.int8_active():
            return super().forward(x)
        wq, sw = self.quantized_weight(self.weight)
        xq, sx = self.quantized_input(x)
        acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), wq).reshape(*x.shape[:-1], wq.shape[0])
        y = acc.float() * (sx * sw)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(self.compute_dtype)


class ConvNorm(Int8QDQ, nn.Module):
    """Conv2d (no bias) + norm + activation (reference:
    focoos/nn/layers/conv.py:ConvNormLayer). Padding is ``(k - 1) // 2`` unless given.
    ``qdq=False`` marks a conv + norm that the JAX package builds from plain
    layers (no ``ConvNorm`` there), so that it never takes the int8 path."""

    def __init__(
        self,
        ch_in: int,
        ch_out: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: Optional[int] = None,
        norm: Optional[str] = "BN",
        act: Optional[str] = None,
        qdq: bool = True,
    ):
        super().__init__()
        pad = (kernel_size - 1) // 2 if padding is None else padding
        self.conv = Conv2d(ch_in, ch_out, kernel_size, stride, pad, bias=False)
        self.norm = get_norm(norm, ch_out)
        self.act = get_activation(act)
        self.qdq = qdq

    def int8_conv(self, x: torch.Tensor) -> torch.Tensor:
        """The conv as JAX's ``_Int8QDQConv`` (common.py:504): NCHW in and out
        (NHWC views), the product in int8."""
        conv = self.conv
        wq, sw = self.quantized_weight(conv.weight)
        xq, sx = self.quantized_input(x.permute(0, 2, 3, 1))
        acc = int8_conv2d(xq, wq, conv.stride[0], conv.padding[0])
        y = acc.float() * (sx * sw)
        if conv.bias is not None:
            y = y + conv.bias.float()
        return y.to(conv.compute_dtype).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.int8_conv(x) if self.int8_active() else self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return self.act(x)


def int8_layers(module: nn.Module) -> dict:
    """{name of the int8 product's module: the layer holding its int8 state}:
    each QDQ ``ConvNorm`` under the name of its ``conv`` (JAX's
    ``_Int8QDQConv`` is that conv's module path), each ``Int8Linear`` under
    its own."""
    out = {}
    for name, m in module.named_modules():
        if isinstance(m, ConvNorm) and m.qdq:
            out[f"{name}.conv" if name else "conv"] = m
        elif isinstance(m, Int8Linear):
            out[name] = m
    return out


def set_int8_mode(
    module: nn.Module, enabled: bool = True, act_scales: Optional[dict] = None, calibrate: bool = False
) -> int:
    """Switch the int8 QDQ products of ``module`` on or off → the number of
    int8 layers. ``act_scales`` maps ``int8_layers`` names to calibrated
    static input scales (absmax / 127); a layer without one quantizes its
    input with the dynamic scale. ``calibrate`` records each layer's input
    absmax (``calibration_absmax`` reads it), as JAX's
    ``int8_calibration_mode`` does, with dynamic scales."""
    layers = int8_layers(module)
    for name, m in layers.items():
        m.int8, m.calibrating, m.absmax = enabled, calibrate, None
        scale = (act_scales or {}).get(name)
        device = next(m.parameters()).device
        m.act_scale = None if scale is None or calibrate else torch.tensor(scale, dtype=torch.float32, device=device)
        m.__dict__.pop("_int8_weight", None)
    return len(layers)


def calibration_absmax(module: nn.Module) -> dict:
    """{``int8_layers`` name: the largest input absmax since ``set_int8_mode(..., calibrate=True)``}."""
    return {name: float(m.absmax) for name, m in int8_layers(module).items() if m.absmax is not None}


class MLP(nn.Module):
    """Linear→ReLU→…→Linear stack (reference: focoos/nn/layers/base.py:MLP)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(Linear(i, o) for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MultiHeadAttention(ComputeDtype, nn.Module):
    """Multi-head attention with torch ``nn.MultiheadAttention``'s merged
    ``in_proj_weight``/``in_proj_bias`` storage; plain matmuls in the compute
    dtype with the softmax in fp32, as the JAX layer computes it
    (common.py:272-307). ``attn_mask`` is boolean, True where a key is
    allowed, broadcast against the ``[..., heads, queries, keys]`` logits; a
    blocked logit takes its dtype's lowest finite value."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        attn_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        e, h = self.embed_dim, self.num_heads
        hd = e // h
        dt = self.compute_dtype
        wq, wk, wv = self.cast(self.in_proj_weight).chunk(3)
        bq, bk, bv = self.cast(self.in_proj_bias).chunk(3)
        q = F.linear(query.to(dt), wq, bq).unflatten(-1, (h, hd))
        k = F.linear(key.to(dt), wk, bk).unflatten(-1, (h, hd))
        v = F.linear(value.to(dt), wv, bv).unflatten(-1, (h, hd))
        logits = torch.einsum("...qhd,...khd->...hqk", q * hd**-0.5, k)
        if attn_mask is not None:
            logits = logits.masked_fill(~attn_mask, torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out = torch.einsum("...hqk,...khd->...qhd", weights, v).flatten(-2)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Transformer encoder layer (reference: focoos/nn/layers/transformer.py:553),
    post-norm or, with ``normalize_before``, pre-norm; attention and FFN in
    the compute dtype, the LayerNorms in fp32 (JAX common.py:310-341)."""

    def __init__(
        self,
        d_model: int,
        nhead: int,
        dim_feedforward: int = 2048,
        activation: str = "relu",
        normalize_before: bool = False,
    ):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.activation = get_activation(activation)
        self.normalize_before = normalize_before

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(self.activation(self.linear1(x)))

    def forward(self, src: torch.Tensor, pos_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.normalize_before:
            s2 = self.norm1(src)
            q = s2 if pos_embed is None else s2 + pos_embed
            src = src + self.self_attn(q, q, s2)
            return src + self._ffn(self.norm2(src))
        q = src if pos_embed is None else src + pos_embed
        src = self.norm1(src + self.self_attn(q, q, src))
        return self.norm2(src + self._ffn(src))


class SelfAttentionBlock(nn.Module):
    """Pre/post-norm residual self-attention (reference:
    focoos/nn/layers/transformer.py:17 SelfAttentionLayer; JAX common.py:438)."""

    def __init__(self, d_model: int, nhead: int, normalize_before: bool = False):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.norm = LayerNorm(d_model, eps=1e-5)
        self.normalize_before = normalize_before

    def forward(self, tgt, query_pos=None, attn_mask=None):
        if self.normalize_before:
            t2 = self.norm(tgt)
            q = t2 if query_pos is None else t2 + query_pos
            return tgt + self.self_attn(q, q, t2, attn_mask=attn_mask)
        q = tgt if query_pos is None else tgt + query_pos
        return self.norm(tgt + self.self_attn(q, q, tgt, attn_mask=attn_mask))


class CrossAttentionBlock(nn.Module):
    """Pre/post-norm residual cross-attention (reference:
    focoos/nn/layers/transformer.py:131 CrossAttentionLayer; JAX common.py:459)."""

    def __init__(self, d_model: int, nhead: int, normalize_before: bool = False):
        super().__init__()
        self.multihead_attn = MultiHeadAttention(d_model, nhead)
        self.norm = LayerNorm(d_model, eps=1e-5)
        self.normalize_before = normalize_before

    def forward(self, tgt, memory, pos=None, query_pos=None, attn_mask=None):
        k = memory if pos is None else memory + pos
        if self.normalize_before:
            t2 = self.norm(tgt)
            q = t2 if query_pos is None else t2 + query_pos
            return tgt + self.multihead_attn(q, k, memory, attn_mask=attn_mask)
        q = tgt if query_pos is None else tgt + query_pos
        return self.norm(tgt + self.multihead_attn(q, k, memory, attn_mask=attn_mask))


class FFNBlock(nn.Module):
    """Pre/post-norm residual FFN (reference: focoos/nn/layers/transformer.py:267
    FFNLayer; JAX common.py:481)."""

    def __init__(self, d_model: int, dim_feedforward: int, activation: str = "relu", normalize_before: bool = False):
        super().__init__()
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm = LayerNorm(d_model, eps=1e-5)
        self.activation = get_activation(activation)
        self.normalize_before = normalize_before

    def forward(self, tgt):
        if self.normalize_before:
            return tgt + self.linear2(self.activation(self.linear1(self.norm(tgt))))
        return self.norm(tgt + self.linear2(self.activation(self.linear1(tgt))))


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


def nearest_resize_torch(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Nearest NCHW resize with torch's floor mapping, src = floor(dst · in / out)
    (JAX common.py:382 ``nearest_resize_torch``: the FPN's upsample at odd sizes)."""
    return F.interpolate(x, size=(int(size[0]), int(size[1])), mode="nearest")


def sine_position_embedding_2d_normalized(
    h: int,
    w: int,
    num_pos_feats: int,
    temperature: float = 10000.0,
    scale: float = 2.0 * math.pi,
    eps: float = 1e-6,
    device: Optional[torch.device] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Normalized 2-D sine position embedding → [H*W, 2*num_pos_feats]
    (reference PositionEmbeddingSine(normalize=True),
    focoos/nn/layers/position_encoding.py:7; JAX common.py:397): 1-based
    coordinates scaled into (0, scale], sin/cos interleaved per pair, the
    y half then the x half."""
    y = (torch.arange(h, dtype=torch.float32, device=device) + 1.0) / (h + eps) * scale
    x = (torch.arange(w, dtype=torch.float32, device=device) + 1.0) / (w + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_pos_feats)

    def interleave(p: torch.Tensor) -> torch.Tensor:
        return torch.stack([torch.sin(p[:, 0::2]), torch.cos(p[:, 1::2])], dim=-1).reshape(p.shape[0], -1)

    py = interleave(y[:, None] / dim_t)  # [H, F]
    px = interleave(x[:, None] / dim_t)  # [W, F]
    out = torch.cat([py[:, None, :].expand(h, w, num_pos_feats), px[None, :, :].expand(h, w, num_pos_feats)], -1)
    return out.reshape(h * w, 2 * num_pos_feats).to(dtype)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal in [-2, 2] std, variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    t = torch.empty(w.shape, dtype=torch.float32)
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    w.copy_(t)


@torch.no_grad()
def init_like_flax_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers on every layer of ``module``: lecun-normal
    conv/dense kernels (and each of q/k/v), zero biases, unit norms with
    reset running statistics. Draws on the CPU from ``generator``."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, MultiHeadAttention):
            for w in m.in_proj_weight.chunk(3):
                lecun_normal_(w, m.embed_dim, generator)
            m.in_proj_bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d, nn.BatchNorm2d)):
            m.reset_parameters()
