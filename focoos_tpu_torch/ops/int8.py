"""The int8 products of the QDQ layers: s8 x s8 → s32.

Port of the products inside the JAX package's ``_Int8QDQConv`` and
``Int8Dense`` (``focoos_tpu/nn/layers/common.py:504-630``), which JAX leaves
to XLA (``lax.conv_general_dilated`` / ``lax.dot_general`` with
``preferred_element_type=int32``) and which no Pallas kernel computes. On the
card the product is the library's int8 GEMM, ``torch._int_mm`` (cuBLASLt,
int32 out): a convolution becomes one GEMM over an im2col of the int8
activations, gathered in JAX's HWIO order by slicing the zero-padded NHWC
tensor (``F.unfold`` has no int8 kernel); a 1x1 convolution is a reshape.
``_int_mm`` takes M > 16 rows and K and N that are multiples of 8, so the
operands are padded with zeros, which adds nothing to any sum.

The plain version (CPU tensors, and the card tests' reference) computes the
same product in float64 on the integer values and casts to int32: every
product is at most 127² and every sum at most 127²·K < 2^53, so it is exact
and the card's result equals it bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0])) if (rows, cols) != tuple(t.shape) else t


def int8_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``int8_matmul``: float64 product of the integers, exact."""
    return (a.double() @ b.double().t()).to(torch.int32)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 x b [N, K] int8 (a weight, rows = output channels) →
    [M, N] int32 = a @ b.T. CUDA tensors: ``torch._int_mm`` on zero-padded
    operands; CPU tensors: the plain version."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"int8_matmul takes [M, K] and [N, K], got {tuple(a.shape)} and {tuple(b.shape)}")
    if not a.is_cuda:
        return int8_matmul_reference(a, b)
    m, k = a.shape
    n = b.shape[0]
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    # [K, N] column-major (b's rows contiguous): the operand layout cuBLASLt's int8 GEMM takes
    out = torch._int_mm(_pad_to(a, max(m, 32), kp), _pad_to(b, np_, kp).t())
    return out[:m, :n]


def im2col_nhwc(x: torch.Tensor, k: int, stride: int, padding: int) -> Tuple[torch.Tensor, int, int]:
    """[B, H, W, C] → ([B·Ho·Wo, k·k·C] with columns in (kh, kw, C) order, Ho, Wo)."""
    b, h, w, c = x.shape
    ho = (h + 2 * padding - k) // stride + 1
    wo = (w + 2 * padding - k) // stride + 1
    if k == 1 and padding == 0:
        return x[:, ::stride, ::stride].reshape(b * ho * wo, c), ho, wo
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    cols = [xp[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
            for dy in range(k) for dx in range(k)]
    return torch.stack(cols, dim=3).reshape(b * ho * wo, k * k * c), ho, wo


def int8_conv2d_reference(xq: torch.Tensor, wq: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """Plain version of ``int8_conv2d``: ``F.conv2d`` in float64, exact."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.double(), stride=stride, padding=padding)
    return y.to(torch.int32).permute(0, 2, 3, 1)


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """xq [B, H, W, C] int8 (NHWC), wq [O, C, k, k] int8 → [B, Ho, Wo, O]
    int32, a square k x k convolution without groups or dilation. CUDA
    tensors: im2col and ``int8_matmul``; CPU tensors: the plain version."""
    if not xq.is_cuda:
        return int8_conv2d_reference(xq, wq, stride, padding)
    o, c, k, _ = wq.shape
    cols, ho, wo = im2col_nhwc(xq, k, stride, padding)
    acc = int8_matmul(cols, wq.permute(0, 2, 3, 1).reshape(o, k * k * c))
    return acc.reshape(xq.shape[0], ho, wo, o)
