"""Multi-scale deformable attention: the wrappers of ``csrc/msda.cu`` (forward)
and ``csrc/msda_bwd.cu`` (backward).

Port of ``focoos_tpu/ops/pallas/msda.py``: ``msda_pallas`` and the custom VJP
of ``ms_deform_attn_fused``. For tensors on the CPU the wrappers run the plain
versions (``ops/deformable.py``); for CUDA tensors they launch the kernels or
raise. There is no fallback. ``msda_forward`` on a CUDA tensor that needs a
gradient goes through ``_MSDAFunction``, which pairs the two kernels. Each
kernel has a vector path (16-byte loads, and vector atomics backward) and a
general one for any D and alignment; ``vector_path`` picks, and each
wrapper counts its launches by path in ``.paths``.

The forward is the custom op ``focoos::msda_forward`` (``torch.library``),
so that a ``torch.export`` program holds it: its CUDA implementation is the
launch (checks, ``torch.cuda.current_stream()``, ``cuda_build.check``, the
launch counters), its CPU implementation the plain version, and its fake
implementation gives the output's shape and dtype. ``spatial_shapes`` enters
the op flat, ``[h0, w0, h1, w1, ...]``. The backward stays a plain launch:
no exported graph holds it.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from focoos_tpu_torch.ops import cuda_build
from focoos_tpu_torch.ops.deformable import ms_deform_attn, ms_deform_attn_backward_reference

_MAX_LEVELS = 8  # kMaxLevels in csrc/common.cuh
_fns = {}


def _kernel(name: str):
    """``msda_forward`` from libmsda or ``msda_backward`` from libmsda_bwd, argtypes set."""
    if name not in _fns:
        if name == "msda_forward":
            fn = cuda_build.load_library("msda").msda_forward
            # value, loc, aw, out | level (h, w) pairs | n_levels, B, S, Lq, Hh, D, P, dtype, vector | stream
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        else:
            fn = cuda_build.load_library("msda_bwd").msda_backward
            # value, loc, aw, grad, d_value, acc, d_loc, d_aw | level (h, w) pairs | n_levels, B, S, Lq, Hh, D, P,
            # dtype, vector | stream
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


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


def _level_hw(spatial_shapes):
    return (ctypes.c_int * (2 * len(spatial_shapes)))(*[v for hw in spatial_shapes for v in hw])


def _dtype_code(t: torch.Tensor) -> int:
    return cuda_build.DTYPE_CODES[str(t.dtype).removeprefix("torch.")]


def vector_path(kernel: str, value: torch.Tensor, *aligned: torch.Tensor) -> bool:
    """Whether ``kernel`` ("forward" or "backward") takes its vector path for
    this value: a row of D values is 16, 32, 64 or 128 bytes (forward; 16-byte
    loads) or D is 4, 8, 16 or 32 (backward; four channels a lane), and value
    and the other tensors it reads with vector loads are 16-byte aligned."""
    d = value.shape[-1]
    fits = d * value.element_size() in (16, 32, 64, 128) if kernel == "forward" else d in (4, 8, 16, 32)
    return fits and all(t.data_ptr() % 16 == 0 for t in (value, *aligned))


def _launch_forward(value, spatial_shapes, loc, aw) -> torch.Tensor:
    _check(value, spatial_shapes, loc, aw)
    b, s, hh, d = value.shape
    lq, p = loc.shape[1], loc.shape[4]
    out = torch.empty((b, lq, hh * d), dtype=value.dtype, device=value.device)
    vector = vector_path("forward", value)
    fn = _kernel("msda_forward")
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            value.data_ptr(), loc.data_ptr(), aw.data_ptr(), out.data_ptr(),
            _level_hw(spatial_shapes), len(spatial_shapes), b, s, lq, hh, d, p, _dtype_code(value), int(vector), stream,
        )
    cuda_build.check(err, "msda_forward")
    msda_forward.launches += 1
    msda_forward.paths["vector" if vector else "general"] += 1
    return out


def msda_backward(
    value: torch.Tensor,  # [B, S, Hh, D] float32 or bfloat16
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,  # [B, Lq, Hh, L, P, 2] float32
    attention_weights: torch.Tensor,  # [B, Lq, Hh, L, P] float32
    grad_out: torch.Tensor,  # [B, Lq, Hh * D]
    needs: Tuple[bool, bool, bool] = (True, True, True),
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(d value in value's dtype, d loc fp32, d aw fp32); a gradient whose
    ``needs`` flag is False is None. On the card the kernel reads the
    gradient in value's dtype and accumulates d value in fp32; for bf16
    values into an fp32 scratch that the same launch converts to the bf16 d
    value after its last atomic (bf16 accumulation misses the tolerance on
    rows that many samples share: ``csrc/msda_bwd.cu``)."""
    spatial_shapes = [(int(h), int(w)) for h, w in spatial_shapes]
    if not value.is_cuda:
        grads = ms_deform_attn_backward_reference(value, spatial_shapes, sampling_locations, attention_weights, grad_out)
        return tuple(g if n else None for g, n in zip(grads, needs))
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    b, s, hh, d = value.shape
    lq, p = sampling_locations.shape[1], sampling_locations.shape[4]
    if tuple(grad_out.shape) != (b, lq, hh * d) or grad_out.device != value.device:
        raise ValueError(f"grad_out must be [{b}, {lq}, {hh * d}] on {value.device}, got {tuple(grad_out.shape)}"
                         f" on {grad_out.device}")
    g = grad_out.to(value.dtype).contiguous()
    d_value = acc = None
    if needs[0] and value.dtype == torch.float32:
        d_value = torch.zeros((b, s, hh, d), dtype=torch.float32, device=value.device)
    elif needs[0]:  # the kernel writes every element; the scratch holds the fp32 sums, then a counter
        d_value = torch.empty((b, s, hh, d), dtype=value.dtype, device=value.device)
        acc = torch.zeros(b * s * hh * d + 4, dtype=torch.float32, device=value.device)
    d_loc = torch.empty_like(sampling_locations) if needs[1] else None
    d_aw = torch.empty_like(attention_weights) if needs[2] else None
    vector = vector_path("backward", value, g)
    fn = _kernel("msda_backward")
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            value.data_ptr(), sampling_locations.data_ptr(), attention_weights.data_ptr(), g.data_ptr(),
            *(0 if t is None else t.data_ptr() for t in (d_value, acc, d_loc, d_aw)),
            _level_hw(spatial_shapes), len(spatial_shapes), b, s, lq, hh, d, p, _dtype_code(value), int(vector),
            stream,
        )
    cuda_build.check(err, "msda_backward")
    msda_backward.launches += 1
    msda_backward.paths["vector" if vector else "general"] += 1
    return d_value, d_loc, d_aw


def _pairs(flat: Sequence[int]) -> List[Tuple[int, int]]:
    return [(int(flat[i]), int(flat[i + 1])) for i in range(0, len(flat), 2)]


@torch.library.custom_op("focoos::msda_forward", mutates_args=(), device_types="cpu")
def msda_forward_op(
    value: torch.Tensor, spatial_shapes: List[int], sampling_locations: torch.Tensor, attention_weights: torch.Tensor
) -> torch.Tensor:
    """The op on CPU tensors: the plain version."""
    return ms_deform_attn(value, _pairs(spatial_shapes), sampling_locations, attention_weights).contiguous()


@msda_forward_op.register_kernel("cuda")
def _msda_forward_cuda(value, spatial_shapes, sampling_locations, attention_weights):
    return _launch_forward(value, _pairs(spatial_shapes), sampling_locations, attention_weights)


@msda_forward_op.register_fake
def _msda_forward_fake(value, spatial_shapes, sampling_locations, attention_weights):
    b, _, hh, d = value.shape
    return value.new_empty((b, sampling_locations.shape[1], hh * d))


class _MSDAFunction(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient. Saves only
    value, loc and aw: the backward recomputes the corner weights."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, loc, aw):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, loc, aw)
        if not value.is_cuda:  # the plain version, for the CPU tests of this route
            return ms_deform_attn(value, spatial_shapes, loc, aw)
        return msda_forward_op(value, [v for hw in spatial_shapes for v in hw], loc, aw)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        value, loc, aw = ctx.saved_tensors
        needs = (ctx.needs_input_grad[0], ctx.needs_input_grad[2], ctx.needs_input_grad[3])
        d_value, d_loc, d_aw = msda_backward(value, ctx.spatial_shapes, loc, aw, grad_out, needs)
        return d_value, None, d_loc, d_aw


def msda_forward(
    value: torch.Tensor,  # [B, S, Hh, D] float32 or bfloat16
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,  # [B, Lq, Hh, L, P, 2] float32
    attention_weights: torch.Tensor,  # [B, Lq, Hh, L, P] float32
) -> torch.Tensor:
    """Fused MSDA → [B, Lq, Hh * D] in value's dtype, fp32 accumulation.
    Differentiable: on the card through the backward kernel, on the CPU
    through the plain version's own autograd. Without a gradient it is the
    op ``focoos::msda_forward`` on either device."""
    spatial_shapes = [(int(h), int(w)) for h, w in spatial_shapes]
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (value, sampling_locations, attention_weights)
    ):
        if not value.is_cuda:
            return ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights)
        return _MSDAFunction.apply(value, spatial_shapes, sampling_locations, attention_weights)
    return msda_forward_op(value, [v for hw in spatial_shapes for v in hw], sampling_locations, attention_weights)


msda_forward.launches = 0
msda_backward.launches = 0
# launches by path (``vector_path``); the sum is ``launches``
msda_forward.paths = {"vector": 0, "general": 0}
msda_backward.paths = {"vector": 0, "general": 0}
