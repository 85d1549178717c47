"""Dataset evaluators (copy of ``focoos_tpu/trainer/evaluation/evaluators.py``,
trimmed to the tasks the port serves; reference: focoos/trainer/evaluation/).

``DatasetEvaluator`` protocol; COCO bbox AP (``DetectionEvaluator``), segm
and bbox AP (``InstanceSegmentationEvaluator``, the mask IoU on the device
where the decode left its packed masks there) and OKS keypoint AP
(``KeypointEvaluator``) on the numpy core of ``coco_eval.py``; the
confusion-matrix mIoU of ``SemSegEvaluator``; the multi-label F1 of
``ClassificationEvaluator``. One process evaluates the whole dataset; the
classification evaluator keeps the JAX package's ``state_for_gather`` /
``load_gathered_states`` seam. The panoptic evaluator lands with fai_mf's
panoptic decode (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from focoos_tpu_torch.ports import DatasetEntry, Task
from focoos_tpu_torch.trainer.evaluation.coco_eval import CocoStyleEvaluator


class DatasetEvaluator:
    def reset(self):
        pass

    def process(self, inputs: List[DatasetEntry], outputs: List[dict]):
        raise NotImplementedError

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        raise NotImplementedError


class DatasetEvaluators(DatasetEvaluator):
    def __init__(self, evaluators: List[DatasetEvaluator]):
        self._evaluators = evaluators

    def reset(self):
        for e in self._evaluators:
            e.reset()

    def process(self, inputs, outputs):
        for e in self._evaluators:
            e.process(inputs, outputs)

    def evaluate(self):
        results = {}
        for e in self._evaluators:
            r = e.evaluate()
            if r:
                results.update(r)
        return results


def _gt_from_entry(entry: DatasetEntry):
    """(classes, boxes, areas, masks [G, H, W] or None, keypoints [G, K, 3] or None, crowd)
    of an entry's instances."""
    inst = entry.instances
    if inst is None or len(inst) == 0:
        return (np.zeros(0, np.int64), np.zeros((0, 4), np.float32), np.zeros(0, np.float64), None, None,
                np.zeros(0, bool))
    boxes = inst.boxes.tensor
    classes = np.asarray(inst.classes, np.int64)
    areas = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])).astype(np.float64)
    masks = inst.masks.tensor if inst.has("masks") else None
    kpts = np.asarray(inst.keypoints.tensor) if inst.has("keypoints") else None
    # eval-time mappers keep crowd regions marked; both IoU kernels take the
    # COCO crowd (IoA) convention, and the matcher treats crowd GTs as
    # ignores: without this, dts overlapping crowds count as FPs
    crowd = (np.asarray(inst.iscrowd, np.int64) > 0) if inst.has("iscrowd") else np.zeros(len(inst), bool)
    return classes, boxes, areas, masks, kpts, crowd


class DetectionEvaluator(DatasetEvaluator):
    """COCO bbox AP (reference: detection_evaluation.py:35)."""

    def __init__(self, class_names: Optional[List[str]] = None, num_classes: Optional[int] = None):
        self.class_names = class_names
        self.num_classes = num_classes or (len(class_names) if class_names else 80)
        self.reset()

    def reset(self):
        self._coco = CocoStyleEvaluator(self.num_classes, "bbox", self.class_names)

    def process(self, inputs, outputs):
        for entry, out in zip(inputs, outputs):
            inst = out["instances"]
            gt_classes, gt_boxes, gt_areas, _, _, gt_crowd = _gt_from_entry(entry)
            self._coco.add_image(
                dt_classes=np.asarray(inst.classes, np.int64),
                dt_scores=np.asarray(inst.scores, np.float64),
                dt_boxes=np.asarray(inst.boxes.tensor, np.float64),
                gt_classes=gt_classes,
                gt_boxes=np.asarray(gt_boxes, np.float64),
                gt_areas=gt_areas,
                gt_crowd=gt_crowd,
            )

    def evaluate(self):
        return {"bbox": self._coco.summarize("bbox")}


class InstanceSegmentationEvaluator(DatasetEvaluator):
    """COCO segm AP, with bbox AP beside it (reference: detection_evaluation.py:356)."""

    def __init__(self, class_names: Optional[List[str]] = None, num_classes: Optional[int] = None):
        self.class_names = class_names
        self.num_classes = num_classes or (len(class_names) if class_names else 80)
        self.reset()

    def reset(self):
        self._coco = CocoStyleEvaluator(self.num_classes, "mask", self.class_names)
        self._box = CocoStyleEvaluator(self.num_classes, "bbox", self.class_names)

    def process(self, inputs, outputs):
        per_image = []
        for entry, out in zip(inputs, outputs):
            inst = out["instances"]
            gt_classes, gt_boxes, gt_areas, gt_masks, _, gt_crowd = _gt_from_entry(entry)
            gm = [np.asarray(m) for m in gt_masks] if gt_masks is not None else []
            per_image.append((inst, gt_classes, gt_areas, gm, gt_boxes, gt_crowd))

        # detections the decode left packed on the device: the IoU is taken there,
        # for the whole batch at once, and only the [K, G] matrices come back
        packed = [(i, t) for i, t in enumerate(per_image) if t[0].has("masks_packed")]
        ious = {}
        if packed:
            from focoos_tpu_torch.ops.mask_iou import device_mask_iou_packed_batch

            batch_ious = device_mask_iou_packed_batch(
                [t[0].masks_packed for _, t in packed],
                packed[0][1][0]._masks_packed_hw,
                [t[3] for _, t in packed],
                gt_crowds=[t[5] for _, t in packed],
            )
            ious = {i: m for (i, _), m in zip(packed, batch_ious)}

        for i, (inst, gt_classes, gt_areas, gm, gt_boxes, gt_crowd) in enumerate(per_image):
            dt_classes = np.asarray(inst.classes, np.int64)
            dt_scores = np.asarray(inst.scores, np.float64)
            dt_boxes = np.asarray(inst.boxes.tensor, np.float64)
            if i in ious:
                self._coco.add_image(
                    dt_classes=dt_classes, dt_scores=dt_scores, dt_boxes=dt_boxes,
                    gt_classes=gt_classes, gt_areas=gt_areas, iou_matrix=ious[i], gt_crowd=gt_crowd,
                )
            else:
                dt_masks = [np.asarray(m) for m in inst.masks.tensor] if inst.has("masks") else []
                self._coco.add_image(
                    dt_classes=dt_classes, dt_scores=dt_scores, dt_masks=dt_masks, dt_boxes=dt_boxes,
                    gt_classes=gt_classes, gt_areas=gt_areas, gt_masks=gm, gt_crowd=gt_crowd,
                )
            self._box.add_image(
                dt_classes=dt_classes, dt_scores=dt_scores, dt_boxes=dt_boxes,
                gt_classes=gt_classes, gt_boxes=np.asarray(gt_boxes, np.float64), gt_areas=gt_areas,
                gt_crowd=gt_crowd,
            )

    def evaluate(self):
        return {"segm": self._coco.summarize("segm"), "bbox": self._box.summarize("bbox")}


class KeypointEvaluator(DatasetEvaluator):
    """OKS keypoint AP (reference: keypoint.py:63)."""

    def __init__(self, class_names: Optional[List[str]] = None, kpt_sigmas: Optional[np.ndarray] = None):
        self.class_names = class_names
        self.kpt_sigmas = kpt_sigmas
        self.reset()

    def reset(self):
        self._coco = CocoStyleEvaluator(1, "oks", self.class_names, kpt_sigmas=self.kpt_sigmas)

    def process(self, inputs, outputs):
        for entry, out in zip(inputs, outputs):
            inst = out["instances"]
            gt_classes, _, gt_areas, _, gt_kpts, gt_crowd = _gt_from_entry(entry)
            dt_kpts = np.asarray(inst.get("keypoints"), np.float64) if inst.has("keypoints") else np.zeros((0, 17, 3))
            if gt_kpts is None:
                gt_kpts = np.zeros((len(gt_classes), dt_kpts.shape[1] if len(dt_kpts) else 17, 3))
            self._coco.add_image(
                dt_classes=np.zeros(len(dt_kpts), np.int64),
                dt_scores=np.asarray(inst.scores, np.float64),
                dt_kpts=dt_kpts,
                dt_boxes=np.asarray(inst.boxes.tensor, np.float64) if inst.has("boxes") else None,
                gt_classes=np.zeros(len(gt_classes), np.int64),
                gt_areas=gt_areas,
                gt_kpts=np.asarray(gt_kpts, np.float64),
                gt_crowd=gt_crowd,
            )

    def evaluate(self):
        return {"keypoints": self._coco.summarize("keypoints")}


class SemSegEvaluator(DatasetEvaluator):
    """Confusion-matrix mIoU / fwIoU / mACC / pACC (reference: sem_seg_evaluation.py:37)."""

    def __init__(self, num_classes: int, ignore_label: int = 255, class_names: Optional[List[str]] = None):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.class_names = class_names
        self.reset()

    def reset(self):
        self._conf = np.zeros((self.num_classes + 1, self.num_classes + 1), np.int64)

    def process(self, inputs, outputs):
        for entry, out in zip(inputs, outputs):
            pred = np.asarray(out["sem_seg"])
            if pred.ndim == 3:  # [C, H, W] scores → argmax
                pred = pred.argmax(0)
            gt = entry.sem_seg
            if gt is None:
                continue
            gt = np.asarray(gt, np.int64).copy()
            gt[gt == self.ignore_label] = self.num_classes
            pred = pred.astype(np.int64).clip(0, self.num_classes)
            if pred.shape != gt.shape:
                import cv2

                pred = cv2.resize(pred.astype(np.int32), (gt.shape[1], gt.shape[0]),
                                  interpolation=cv2.INTER_NEAREST).astype(np.int64)
            n = self.num_classes + 1
            self._conf += np.bincount(n * gt.reshape(-1) + pred.reshape(-1), minlength=n**2).reshape(n, n)

    def evaluate(self):
        conf = self._conf[: self.num_classes, : self.num_classes].astype(np.float64)
        # rows = gt, cols = pred, the ignore label's row and column dropped
        # (reference sem_seg_evaluation.py:135-140 sums conf_matrix[:-1, :-1])
        tp = np.diag(conf)
        pos_gt = conf.sum(1)
        pos_pred = conf.sum(0)
        union = pos_gt + pos_pred - tp
        valid = pos_gt > 0
        iou = np.where(union > 0, tp / np.maximum(union, 1e-9), 0.0)
        acc = np.where(pos_gt > 0, tp / np.maximum(pos_gt, 1e-9), 0.0)
        miou = float(iou[valid].mean()) * 100 if valid.any() else 0.0
        fwiou = float((iou * pos_gt / max(pos_gt.sum(), 1e-9)).sum()) * 100
        macc = float(acc[valid].mean()) * 100 if valid.any() else 0.0
        pacc = float(tp.sum() / max(pos_gt.sum(), 1e-9)) * 100
        res = {"mIoU": miou, "fwIoU": fwiou, "mACC": macc, "pACC": pacc}
        if self.class_names:
            for i, name in enumerate(self.class_names[: self.num_classes]):
                if valid[i]:
                    res[f"IoU-{name}"] = float(iou[i]) * 100
        return {"sem_seg": res}


class ClassificationEvaluator(DatasetEvaluator):
    """Multi-label F1/precision/recall (reference: classification_evaluation.py:16):
    per-class TP/FP/FN at ``threshold`` over sigmoid probabilities; ``f1``,
    ``precision`` and ``recall`` are means over the classes with support, in
    percent, beside ``micro_f1``."""

    def __init__(self, num_classes: int, threshold: float = 0.5, class_names: Optional[List[str]] = None):
        self.num_classes = num_classes
        self.threshold = threshold
        self.class_names = class_names
        self.reset()

    def reset(self):
        self._tp = np.zeros(self.num_classes)
        self._fp = np.zeros(self.num_classes)
        self._fn = np.zeros(self.num_classes)

    def process(self, inputs, outputs):
        for entry, out in zip(inputs, outputs):
            pred = np.asarray(out["logits"]) > self.threshold  # already sigmoided
            gt = np.zeros(self.num_classes, bool)
            if entry.label is not None:
                gt[np.asarray(entry.label).reshape(-1)] = True
            self._tp += pred & gt
            self._fp += pred & ~gt
            self._fn += ~pred & gt

    def state_for_gather(self):
        return (self._tp, self._fp, self._fn)

    def load_gathered_states(self, states):
        self._tp = np.sum([s[0] for s in states], axis=0)
        self._fp = np.sum([s[1] for s in states], axis=0)
        self._fn = np.sum([s[2] for s in states], axis=0)

    def evaluate(self):
        prec = self._tp / np.maximum(self._tp + self._fp, 1e-9)
        rec = self._tp / np.maximum(self._tp + self._fn, 1e-9)
        f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-9)
        support = (self._tp + self._fn) > 0
        micro_p = self._tp.sum() / max((self._tp + self._fp).sum(), 1e-9)
        micro_r = self._tp.sum() / max((self._tp + self._fn).sum(), 1e-9)
        micro_f1 = 2 * micro_p * micro_r / max(micro_p + micro_r, 1e-9)
        return {
            "classification": {
                "f1": float(f1[support].mean()) * 100 if support.any() else 0.0,
                "precision": float(prec[support].mean()) * 100 if support.any() else 0.0,
                "recall": float(rec[support].mean()) * 100 if support.any() else 0.0,
                "micro_f1": float(micro_f1) * 100,
            }
        }


def get_evaluator(task: Task, num_classes: int, class_names: Optional[List[str]] = None) -> DatasetEvaluator:
    """Task → evaluator dispatch (reference: get_eval.py:5)."""
    if task == Task.DETECTION:
        return DetectionEvaluator(class_names, num_classes)
    if task == Task.INSTANCE_SEGMENTATION:
        return InstanceSegmentationEvaluator(class_names, num_classes)
    if task == Task.KEYPOINT:
        return KeypointEvaluator(class_names)
    if task == Task.SEMSEG:
        return SemSegEvaluator(num_classes, class_names=class_names)
    if task == Task.CLASSIFICATION:
        return ClassificationEvaluator(num_classes, class_names=class_names)
    raise ValueError(f"No evaluator for task {task}")
