"""Dataset evaluators (copy of ``focoos_tpu/trainer/evaluation/evaluators.py``,
trimmed to the tasks the port serves; reference: focoos/trainer/evaluation/).

``DatasetEvaluator`` protocol, and COCO bbox AP (``DetectionEvaluator``) and
OKS keypoint AP (``KeypointEvaluator``) on the numpy core of ``coco_eval.py``.
One process evaluates the whole dataset, so the JAX package's multi-host
gather seam is left out. The other tasks' evaluators land with their
families: instance segmentation and semantic segmentation with fai_mf and
bisenetformer (they need mask IoU from ``utils/native.py`` and a resize of
the prediction), classification with fai_cls (ROADMAP Queue 1 item 7).
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
    """(classes, boxes, areas, keypoints [G, K, 3] or None, crowd) of an entry's instances."""
    inst = entry.instances
    if inst is None or len(inst) == 0:
        return np.zeros(0, np.int64), np.zeros((0, 4), np.float32), np.zeros(0, np.float64), None, np.zeros(0, bool)
    boxes = inst.boxes.tensor
    classes = np.asarray(inst.classes, np.int64)
    areas = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])).astype(np.float64)
    kpts = np.asarray(inst.keypoints.tensor) if inst.has("keypoints") else None
    # eval-time mappers keep crowd regions marked; both IoU kernels take the
    # COCO crowd (IoA) convention, and the matcher treats crowd GTs as
    # ignores: without this, dts overlapping crowds count as FPs
    crowd = (np.asarray(inst.iscrowd, np.int64) > 0) if inst.has("iscrowd") else np.zeros(len(inst), bool)
    return classes, boxes, areas, kpts, crowd


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
            gt_classes, gt_boxes, gt_areas, _, gt_crowd = _gt_from_entry(entry)
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
            gt_classes, _, gt_areas, gt_kpts, gt_crowd = _gt_from_entry(entry)
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


def get_evaluator(task: Task, num_classes: int, class_names: Optional[List[str]] = None) -> DatasetEvaluator:
    """Task → evaluator dispatch (reference: get_eval.py:5)."""
    if task == Task.DETECTION:
        return DetectionEvaluator(class_names, num_classes)
    if task == Task.KEYPOINT:
        return KeypointEvaluator(class_names)
    if task in (Task.INSTANCE_SEGMENTATION, Task.SEMSEG, Task.CLASSIFICATION):
        raise NotImplementedError(f"the {Task(task).value} evaluator is not ported yet (ROADMAP Queue 1 item 7)")
    raise ValueError(f"No evaluator for task {task}")
