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

The forward is the custom op ``focoos::fused_resnet_stem`` (``torch.library``),
so that a ``torch.export`` program holds it: its CUDA implementation is the
launch, its CPU implementation the plain version, its fake implementation
the output's shape, [B, ceil(ceil(H/2)/2), ceil(ceil(W/2)/2), 64].
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
    ``F.max_pool2d(3, 2, 1)``. NHWC in, NHWC out (a permuted view). For bf16
    x the convs take bf16 weights and the affine runs in fp32 on each conv's
    bf16 output, rounded to bf16 once, as flax's BatchNorm with
    ``dtype=bfloat16`` does."""
    y = x.permute(0, 3, 1, 2)
    for k, s, a, stride in ((k1, s1, a1, 2), (k2, s2, a2, 1), (k3, s3, a3, 1)):
        y = F.conv2d(y, k.permute(3, 2, 0, 1).to(x.dtype), stride=stride, padding=1)
        y = torch.relu(y.float() * s[:, None, None] + a[:, None, None]).to(x.dtype)
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


def _out_hw(h, w):
    return ((h + 1) // 2 + 1) // 2, ((w + 1) // 2 + 1) // 2


@torch.library.custom_op("focoos::fused_resnet_stem", mutates_args=(), device_types="cpu")
def fused_resnet_stem_op(
    x: torch.Tensor,
    k1: torch.Tensor, s1: torch.Tensor, a1: torch.Tensor,
    k2: torch.Tensor, s2: torch.Tensor, a2: torch.Tensor,
    k3: torch.Tensor, s3: torch.Tensor, a3: torch.Tensor,
) -> torch.Tensor:
    """The op on CPU tensors: the plain version."""
    return resnet_stem_reference(x, k1, s1, a1, k2, s2, a2, k3, s3, a3).contiguous()


@fused_resnet_stem_op.register_fake
def _fused_resnet_stem_fake(x, *params):
    b, h, w, _ = x.shape
    return x.new_empty((b, *_out_hw(h, w), _CHANNELS[-1]))


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        if not x.is_cuda:
            return resnet_stem_reference(x, *params)
        raise NotImplementedError("fused_resnet_stem is inference-only: it has no backward kernel")
    return fused_resnet_stem_op(x, *params)


@fused_resnet_stem_op.register_kernel("cuda")
def _fused_resnet_stem_cuda(x, k1, s1, a1, k2, s2, a2, k3, s3, a3):
    params = (k1, s1, a1, k2, s2, a2, k3, s3, a3)
    _check(x, params)
    b, h, w, _ = x.shape
    h4, w4 = _out_hw(h, w)
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
