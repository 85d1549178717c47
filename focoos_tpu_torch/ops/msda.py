"""Multi-scale deformable attention forward: the wrapper of ``csrc/msda.cu``.

Port of ``focoos_tpu/ops/pallas/msda.py`` (``msda_pallas``). For a tensor on
the CPU it runs the plain version (``ops/deformable.py::ms_deform_attn``); for
a CUDA tensor it launches the kernel or raises. There is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from focoos_tpu_torch.ops import cuda_build
from focoos_tpu_torch.ops.deformable import ms_deform_attn

_MAX_LEVELS = 8  # kMaxLevels in csrc/msda.cu
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_build.load_library("msda").msda_forward
        # value, loc, aw, out | level (h, w) pairs | n_levels, B, S, Lq, Hh, D, P, dtype | stream
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(value, spatial_shapes, loc, aw) -> None:
    if value.dim() != 4:
        raise ValueError(f"value must be [B, S, Hh, D], got {tuple(value.shape)}")
    b, s, hh, d = value.shape
    n_levels = len(spatial_shapes)
    if not 1 <= n_levels <= _MAX_LEVELS:
        raise ValueError(f"the kernel takes 1..{_MAX_LEVELS} levels, got {n_levels}")
    if sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError(f"spatial_shapes {list(spatial_shapes)} do not sum to S={s}")
    if loc.dim() != 6 or tuple(loc.shape[:4]) != (b, loc.shape[1], hh, n_levels) or loc.shape[-1] != 2:
        raise ValueError(f"sampling_locations must be [B, Lq, Hh, L, P, 2], got {tuple(loc.shape)}")
    if tuple(aw.shape) != tuple(loc.shape[:5]):
        raise ValueError(f"attention_weights must be {tuple(loc.shape[:5])}, got {tuple(aw.shape)}")
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
    if loc.dtype != torch.float32 or aw.dtype != torch.float32:
        raise TypeError(f"sampling_locations and attention_weights must be float32, got {loc.dtype}, {aw.dtype}")
    for name, t in (("value", value), ("sampling_locations", loc), ("attention_weights", aw)):
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def msda_forward(
    value: torch.Tensor,  # [B, S, Hh, D] float32 or bfloat16
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,  # [B, Lq, Hh, L, P, 2] float32
    attention_weights: torch.Tensor,  # [B, Lq, Hh, L, P] float32
) -> torch.Tensor:
    """Fused MSDA → [B, Lq, Hh * D] in value's dtype, fp32 accumulation."""
    spatial_shapes = [(int(h), int(w)) for h, w in spatial_shapes]
    if not value.is_cuda:
        return ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights)
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (value, sampling_locations, attention_weights)
    ):
        raise NotImplementedError(
            "msda_forward has no backward kernel yet (ROADMAP Queue 2, MSDA backward)"
        )
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    b, s, hh, d = value.shape
    lq, p = sampling_locations.shape[1], sampling_locations.shape[4]
    out = torch.empty((b, lq, hh * d), dtype=value.dtype, device=value.device)
    level_hw = (ctypes.c_int * (2 * len(spatial_shapes)))(*[v for hw in spatial_shapes for v in hw])
    fn = _kernel()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            value.data_ptr(), sampling_locations.data_ptr(), attention_weights.data_ptr(), out.data_ptr(),
            level_hw, len(spatial_shapes), b, s, lq, hh, d, p,
            cuda_build.DTYPE_CODES[str(value.dtype).removeprefix("torch.")], stream,
        )
    cuda_build.check(err, "msda_forward")
    msda_forward.launches += 1
    return out


msda_forward.launches = 0
