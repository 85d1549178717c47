"""Greedy NMS with static shapes, batched: the wrapper of ``csrc/nms.cu``.

Port of ``focoos_tpu/ops/nms.py`` and of the Pallas sweep it dispatches to on
the TPU (``focoos_tpu/ops/pallas/nms_kernel.py::nms_keep_pallas``). The JAX
package runs one image at a time under ``jax.vmap``; here every function takes
the batch as its first axis, so a forward makes one NMS launch for the whole
batch.

``nms_keep`` is the wrapper: for a tensor on the CPU it runs the plain
version (``nms_keep_reference``); for a CUDA tensor it launches the kernel or
raises. There is no fallback. It calls the custom op ``focoos::nms_keep``
(``torch.library``: the launch on CUDA tensors, the plain version on CPU
ones, a [B, K] bool fake), so that a ``torch.export`` program holds it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from focoos_tpu_torch.ops import cuda_build
from focoos_tpu_torch.ops.boxes import box_iou
from focoos_tpu_torch.ops.topk import topk_lowest_index_first

MAX_K = 1024  # kMaxK in csrc/nms.cu: the [K, ceil(K/32)] overlap bitmask lives in shared memory
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_build.load_library("nms").nms_keep
        # boxes, scores, keep | B, K | iou_threshold | stream
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def nms_keep_reference(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.65) -> torch.Tensor:
    """Plain version: the XLA loop of ``focoos_tpu/ops/nms.py::nms_keep``
    (:21-42), over the batch.

    Args:
        boxes: [B, K, 4] xyxy, each row sorted by score descending.
        scores: [B, K] sorted descending; only used for validity (> 0).

    Returns:
        keep [B, K] bool: a box is kept if its score is > 0 and no earlier
        kept box has IoU > ``iou_threshold`` with it.
    """
    k = boxes.shape[-2]
    iou, _ = box_iou(boxes, boxes)
    overlap = iou > iou_threshold
    earlier = torch.arange(k, device=boxes.device)
    keep = scores > 0
    for i in range(k):
        suppressed = (overlap[:, i] & keep & (earlier < i)).any(-1)
        keep[:, i] = ~suppressed & keep[:, i]
    return keep


def _check(boxes: torch.Tensor, scores: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [B, K, 4], got {tuple(boxes.shape)}")
    if tuple(scores.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"scores must be {tuple(boxes.shape[:2])}, got {tuple(scores.shape)}")
    if not 1 <= boxes.shape[1] <= MAX_K:
        raise ValueError(f"the NMS kernel takes 1..{MAX_K} candidates per image, got K={boxes.shape[1]}")
    for name, t in (("boxes", boxes), ("scores", scores)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != boxes.device:
            raise ValueError(f"{name} is on {t.device}, boxes on {boxes.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned: the kernel reads each box as one float4")


@torch.library.custom_op("focoos::nms_keep", mutates_args=(), device_types="cpu")
def nms_keep_op(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The op on CPU tensors: the plain version."""
    return nms_keep_reference(boxes, scores, iou_threshold)


@nms_keep_op.register_fake
def _nms_keep_fake(boxes, scores, iou_threshold):
    return scores.new_empty(scores.shape, dtype=torch.bool)


def nms_keep(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.65) -> torch.Tensor:
    """Greedy NMS keep mask [B, K] bool over score-sorted candidates
    (contract of ``nms_keep_reference``); one launch for the batch on the card.
    The mask carries no gradient."""
    return nms_keep_op(boxes.detach(), scores.detach(), float(iou_threshold))


@nms_keep_op.register_kernel("cuda")
def _nms_keep_cuda(boxes, scores, iou_threshold):
    _check(boxes, scores)
    b, k = scores.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    fn = _kernel()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(), b, k, float(iou_threshold), stream)
    cuda_build.check(err, "nms_keep")
    nms_keep.launches += 1
    return keep


nms_keep.launches = 0


def pre_topk(
    boxes: torch.Tensor,  # [B, A, 4]
    scores: torch.Tensor,  # [B, A]
    pre_topk: int,
    score_threshold: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score filter → top-``pre_topk`` → (boxes [B, K, 4], scores [B, K]
    sorted descending, equal scores by anchor index, anchor idx [B, K])."""
    scores = torch.where(scores >= score_threshold, scores, torch.zeros_like(scores))
    top_scores, top_idx = topk_lowest_index_first(scores, min(pre_topk, scores.shape[1]), dim=1)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    return top_boxes.contiguous(), top_scores.contiguous(), top_idx


def topk_nms(
    boxes: torch.Tensor,  # [B, A, 4]
    scores: torch.Tensor,  # [B, A]
    pre_topk_k: int,
    iou_threshold: float,
    max_out: int,
    score_threshold: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score filter → top-k → NMS → top-``max_out`` survivors, static shapes
    (port of ``focoos_tpu/ops/nms.py::topk_nms`` :45-69, batched).

    Returns (idx [B, max_out] into the A axis, valid [B, max_out] bool,
    scores [B, max_out]). Both top-ks break ties as ``jax.lax.top_k`` does,
    so invalid slots (score 0) carry the indices JAX's do.
    """
    top_boxes, top_scores, top_idx = pre_topk(boxes, scores, pre_topk_k, score_threshold)
    keep = nms_keep(top_boxes, top_scores, iou_threshold)
    kept_scores = torch.where(keep, top_scores, torch.zeros_like(top_scores))
    out_scores, sel = topk_lowest_index_first(kept_scores, min(max_out, kept_scores.shape[1]), dim=1)
    return torch.gather(top_idx, 1, sel), out_scores > 0, out_scores
