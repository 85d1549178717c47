"""Fused ResNet-D deep stem (inference): the wrapper of ``csrc/stem.cu``.

Port of ``focoos_tpu/ops/pallas/stem.py`` (``fused_resnet_stem``). Computes,
NHWC in and NHWC out::

    y1 = relu(conv3x3_s2(x,  k1) * s1 + a1)   # 3 -> 32
    y2 = relu(conv3x3_s1(y1, k2) * s2 + a2)   # 32 -> 32
    y3 = relu(conv3x3_s1(y2, k3) * s3 + a3)   # 32 -> 64
    out = maxpool3x3_s2_p1(y3)                # padded with -inf

with ``(s_i, a_i)`` the eval BatchNorm folded per channel
(``scale = gamma * rsqrt(var + eps)``, ``bias = beta - mean * scale``). For a
tensor on the CPU the wrapper runs the plain version below; for a CUDA tensor
it launches the kernel or raises. Unlike the Pallas wrapper it takes any H and
W (the kernel masks the edges).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from focoos_tpu_torch.ops import cuda_build

_CHANNELS = (3, 32, 32, 64)  # in, conv1, conv2, conv3 (fixed by csrc/stem.cu)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_build.load_library("stem").fused_resnet_stem
        # x, (k, s, a) x 3, out | B, H, W, dtype | stream
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def resnet_stem_reference(
    x: torch.Tensor,
    k1: torch.Tensor, s1: torch.Tensor, a1: torch.Tensor,
    k2: torch.Tensor, s2: torch.Tensor, a2: torch.Tensor,
    k3: torch.Tensor, s3: torch.Tensor, a3: torch.Tensor,
) -> torch.Tensor:
    """Plain version: three ``F.conv2d`` + affine + ReLU steps, then
    ``F.max_pool2d(3, 2, 1)``. NHWC in, NHWC out (a permuted view)."""
    y = x.permute(0, 3, 1, 2)
    for k, s, a, stride in ((k1, s1, a1, 2), (k2, s2, a2, 1), (k3, s3, a3, 1)):
        y = F.conv2d(y, k.permute(3, 2, 0, 1).to(y.dtype), stride=stride, padding=1)
        y = torch.relu(y * s.to(y.dtype)[:, None, None] + a.to(y.dtype)[:, None, None])
    y = F.max_pool2d(y, 3, 2, 1)
    return y.permute(0, 2, 3, 1)


def _check(x, params) -> None:
    if x.dim() != 4 or x.shape[-1] != _CHANNELS[0]:
        raise ValueError(f"x must be [B, H, W, 3], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")
    for i, (k, s, a) in enumerate(zip(params[0::3], params[1::3], params[2::3])):
        cin, cout = _CHANNELS[i], _CHANNELS[i + 1]
        for name, t, shape in ((f"k{i + 1}", k, (3, 3, cin, cout)), (f"s{i + 1}", s, (cout,)), (f"a{i + 1}", a, (cout,))):
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
            if t.device != x.device:
                raise ValueError(f"{name} is on {t.device}, x on {x.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if k.data_ptr() % 16:
            raise ValueError(f"k{i + 1} must be 16-byte aligned (the kernel reads it as float4)")


def fused_resnet_stem(
    x: torch.Tensor,
    k1: torch.Tensor, s1: torch.Tensor, a1: torch.Tensor,
    k2: torch.Tensor, s2: torch.Tensor, a2: torch.Tensor,
    k3: torch.Tensor, s3: torch.Tensor, a3: torch.Tensor,
) -> torch.Tensor:
    """Fused deep-stem forward. x: [B, H, W, 3] normalized float32/bfloat16;
    k_i: HWIO [3, 3, Cin, Cout] float32; s_i, a_i: [Cout] float32.
    Returns [B, ceil(H/4), ceil(W/4), 64] in x's dtype."""
    params = (k1, s1, a1, k2, s2, a2, k3, s3, a3)
    if not x.is_cuda:
        return resnet_stem_reference(x, *params)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        raise NotImplementedError("fused_resnet_stem is inference-only: it has no backward kernel")
    _check(x, params)
    b, h, w, _ = x.shape
    h4, w4 = (((h + 1) // 2) + 1) // 2, (((w + 1) // 2) + 1) // 2
    out = torch.empty((b, h4, w4, _CHANNELS[-1]), dtype=x.dtype, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            x.data_ptr(), *[t.data_ptr() for t in params], out.data_ptr(), b, h, w,
            cuda_build.DTYPE_CODES[str(x.dtype).removeprefix("torch.")], stream,
        )
    cuda_build.check(err, "fused_resnet_stem")
    fused_resnet_stem.launches += 1
    return out


fused_resnet_stem.launches = 0
