"""Mask IoU on the model's device for instance-segmentation evaluation
(port of focoos_tpu/ops/mask_iou.py).

The evaluation decode (``models/fai_mf/processor._device_instance_decode``)
bit-packs the K predicted binary masks on the device. Their only consumer
is the evaluator's detection × ground-truth IoU matrix, so the IoU is taken
there: the (few, small) packed ground-truth masks go up, both sides are
unpacked with shifts (``np.packbits`` order, most significant bit first),
one [K, HW] × [HW, G] product of 0/1 fp32 values gives the intersections,
and only the [K, G] matrix comes back.

Exactness: every count is an integer-valued fp32 sum of 0/1 products, exact
below 2^24 pixels (1024² = 2^20), and the one rounding is the fp32 division
inter / union. ``native.mask_iou`` divides in double and rounds to float:
double rounding of a quotient is innocuous when the wider format has at
least 2·24+2 bits (53 ≥ 50), so the two are bit-identical, the COCO crowd
convention (intersection over the detection's area) included. The JAX
package computes the same product outside any Pallas kernel: no kernel of
its own stands behind this module.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

_SHIFTS = torch.tensor([7, 6, 5, 4, 3, 2, 1, 0], dtype=torch.uint8)


def unpackbits(packed: torch.Tensor) -> torch.Tensor:
    """[..., n] uint8 → [..., 8n] fp32 0/1, ``np.unpackbits`` order."""
    bits = (packed[..., None] >> _SHIFTS.to(packed.device)) & 1
    return bits.flatten(-2).float()


def _iou(dt: torch.Tensor, gt: torch.Tensor, crowd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unpacked dt [K, P] and gt [G, P] fp32, crowd [G] bool → (iou [K, G], dt areas [K])."""
    inter = dt @ gt.T
    a_dt = dt.sum(-1)
    union = torch.where(crowd[None, :], a_dt[:, None], a_dt[:, None] + gt.sum(-1)[None, :] - inter)
    iou = torch.where(union > 0, inter / union.clamp_min(1e-9), torch.zeros((), device=dt.device))
    return iou, a_dt


def _pack_gt(gt_masks: Sequence[np.ndarray], hw: Tuple[int, int], nbytes: int) -> np.ndarray:
    n_pix = hw[0] * hw[1]
    if (n_pix + 7) // 8 != nbytes:
        raise ValueError(f"dt packed width {nbytes} bytes does not match hw={hw} (expected ceil({n_pix}/8))")
    stacked = np.stack([np.asarray(m, np.uint8).reshape(-1) for m in gt_masks])
    if stacked.shape[-1] != n_pix:
        # a silent truncation would give plausible but wrong IoU and AP
        raise ValueError(f"GT mask has {stacked.shape[-1]} pixels, expected {n_pix} (hw={hw}); "
                         "resize GT to the dt decode resolution first")
    return np.packbits(stacked, axis=-1)


def device_mask_iou_packed(dt_packed, hw: Tuple[int, int], gt_masks: Sequence[np.ndarray],
                           gt_crowd: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """[K] × [G] IoU of packed detections (a tensor, usually on the card, or
    an array) against host [G, H, W] ground-truth masks → (iou [K, G] fp32,
    dt areas [K] fp64), numpy."""
    dt_packed = torch.as_tensor(dt_packed)
    k, nbytes = dt_packed.shape
    dt = unpackbits(dt_packed)
    if len(gt_masks) == 0:
        return np.zeros((k, 0), np.float32), dt.sum(-1).double().cpu().numpy()
    gt = unpackbits(torch.from_numpy(_pack_gt(gt_masks, hw, nbytes)).to(dt_packed.device))
    crowd = torch.zeros(len(gt_masks), dtype=torch.bool) if gt_crowd is None else torch.as_tensor(
        np.asarray(gt_crowd) > 0)
    iou, a_dt = _iou(dt, gt, crowd.to(dt_packed.device))
    return iou.cpu().numpy(), a_dt.double().cpu().numpy()


def device_mask_iou_packed_batch(dt_packed_list, hw: Tuple[int, int], gt_lists,
                                 gt_crowds=None) -> List[np.ndarray]:
    """Per image of a batch, the [K, G_i] fp32 IoU of its packed detections
    ([K, ⌈HW/8⌉] each) against its ground-truth masks; the ground truth goes
    up and the matrices come back in one copy each."""
    n = len(dt_packed_list)
    if n == 0:
        return []
    dt_packed = torch.stack([torch.as_tensor(d) for d in dt_packed_list])
    k, nbytes = dt_packed.shape[1:]
    counts = [len(g) for g in gt_lists]
    if sum(counts) == 0:
        return [np.zeros((k, 0), np.float32) for _ in range(n)]
    dev = dt_packed.device
    gt = unpackbits(torch.from_numpy(_pack_gt([m for g in gt_lists for m in g], hw, nbytes)).to(dev))
    crowd = np.concatenate([
        np.zeros(c, bool) if gt_crowds is None or gt_crowds[i] is None else np.asarray(gt_crowds[i]) > 0
        for i, c in enumerate(counts)])
    crowd = torch.from_numpy(crowd).to(dev)
    out, start = [], 0
    for i, c in enumerate(counts):  # one image's unpacked detections at a time
        out.append(_iou(unpackbits(dt_packed[i]), gt[start:start + c], crowd[start:start + c])[0])
        start += c
    flat = torch.cat([o.flatten() for o in out]).cpu().numpy()
    res, pos = [], 0
    for c in counts:
        res.append(flat[pos:pos + k * c].reshape(k, c))
        pos += k * c
    return res
