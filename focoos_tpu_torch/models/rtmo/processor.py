"""rtmo processor (port of focoos_tpu/models/rtmo/processor.py; reference:
focoos/models/rtmo/processor.py).

The model decodes to static [B, D] tensors on the device; the processor
copies them to the host once, scales boxes and keypoints back to each
original image frame and builds the detections, or, for evaluation, the
``Instances`` the keypoint evaluator scores. In training it batches mapped
entries and pads their keypoint targets to ``max_instances``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from focoos_tpu_torch.ports import DatasetEntry, FocoosDet, FocoosDetections
from focoos_tpu_torch.models.rtmo.config import RTMOConfig
from focoos_tpu_torch.models.rtmo.ports import KeypointTargets, RTMOModelOutput
from focoos_tpu_torch.processor.base_processor import Processor, as_tensors
from focoos_tpu_torch.structures import Boxes, ImageList, Instances


class RTMOProcessor(Processor):
    # boxes and keypoints come out in the input's pixel frame, which the
    # decode rescales from the configured size: no resize to another bucket
    resize_dispatch_safe = False
    def __init__(self, config: RTMOConfig, image_size: Optional[Union[int, Tuple[int, int]]] = None):
        super().__init__(config, image_size)
        self.threshold = config.score_thr

    def preprocess(self, inputs):
        """Images or DatasetEntries → (NHWC batch, None; ``KeypointTargets``
        for entries in training). With no target size the batch is padded,
        never resized, up to a multiple of 32, so the Focus space-to-depth and
        the stride-8/16/32 levels split evenly."""
        if isinstance(inputs, (list, tuple)) and len(inputs) > 0 and isinstance(inputs[0], DatasetEntry):
            return self.preprocess_entries(inputs)
        if self.training:
            raise ValueError("training preprocess expects a list of DatasetEntry")
        batch = self.get_batch(inputs, self._target_size())
        if self._target_size() is None:
            _, h, w, _ = batch.shape
            ph, pw = (-h) % 32, (-w) % 32
            if ph or pw:
                batch = np.pad(batch, ((0, 0), (0, ph), (0, pw), (0, 0)))
        return batch, None

    def preprocess_entries(self, entries: List[DatasetEntry], max_instances: int = 50):
        """Entries' images (no resize), padded together to a multiple of 32 →
        (uint8 NHWC batch, None), and in training the targets padded to
        ``max_instances`` (JAX processor.py:46-86): visible where the
        annotation's visibility is > 0, areas the boxes' w·h."""
        batch = ImageList.from_tensors([e.image for e in entries], size_divisibility=32).tensor.astype(np.uint8, copy=False)
        if not self.training:
            return batch, None
        b, k = len(entries), self.config.num_keypoints
        labels = np.zeros((b, max_instances), np.int64)
        boxes = np.zeros((b, max_instances, 4), np.float32)
        kpts = np.zeros((b, max_instances, k, 2), np.float32)
        vis = np.zeros((b, max_instances, k), np.float32)
        areas = np.zeros((b, max_instances), np.float32)
        valid = np.zeros((b, max_instances), bool)
        for i, e in enumerate(entries):
            inst = e.instances
            if inst is None or len(inst) == 0:
                continue
            n = min(len(inst), max_instances)
            boxes[i, :n] = inst.boxes.tensor[:n]
            labels[i, :n] = inst.classes[:n]
            if inst.has("keypoints"):
                kp = inst.keypoints.tensor[:n]
                kpts[i, :n] = kp[..., :2]
                vis[i, :n] = kp[..., 2] > 0
            areas[i, :n] = (boxes[i, :n, 2] - boxes[i, :n, 0]) * (boxes[i, :n, 3] - boxes[i, :n, 1])
            valid[i, :n] = True
        return batch, KeypointTargets(*(torch.from_numpy(a) for a in (labels, boxes, kpts, vis, areas, valid)))

    def _scaled_arrays(self, output: RTMOModelOutput, input_hw, image_sizes):
        """``input_hw=None`` means the batch was padded, not resized: the
        model's coordinates are already each image's own pixel frame."""
        scores = output.scores.cpu().numpy()
        labels = output.labels.cpu().numpy()
        boxes = output.boxes.cpu().numpy().copy()
        kpts = output.keypoints.cpu().numpy().copy()
        kvis = output.keypoints_scores.cpu().numpy()
        if input_hw is not None:
            ih, iw = input_hw
            for i, (h, w) in enumerate(image_sizes):
                sx, sy = w / iw, h / ih
                boxes[i, :, 0::2] *= sx
                boxes[i, :, 1::2] *= sy
                kpts[i, ..., 0] *= sx
                kpts[i, ..., 1] *= sy
        return scores, labels, boxes, kpts, kvis

    def postprocess(
        self,
        output: RTMOModelOutput,
        inputs,
        class_names: List[str] = [],
        threshold: Optional[float] = None,
        **kw,
    ) -> List[FocoosDetections]:
        threshold = self.threshold if threshold is None else threshold
        image_sizes = self.get_image_sizes(inputs)
        scores, labels, boxes, kpts, kvis = self._scaled_arrays(output, self._target_size(), image_sizes)

        results = []
        for i in range(scores.shape[0]):
            h, w = image_sizes[i]
            keep = scores[i] > threshold
            dets = []
            for s, lab, b, kp, kv in zip(scores[i][keep], labels[i][keep], boxes[i][keep], kpts[i][keep], kvis[i][keep]):
                # reference int conventions (rtmo/processor.py:183-191): boxes
                # clip to [0, max(h, w)] then truncate; keypoint x clips to
                # [0, w], y to [0, h], truncated
                bb = np.clip(b, 0, max(h, w)).astype(int)
                kx = np.clip(kp[:, 0], 0, w).astype(int)
                ky = np.clip(kp[:, 1], 0, h).astype(int)
                dets.append(
                    FocoosDet(
                        bbox=bb.tolist(),
                        conf=float(s),
                        cls_id=int(lab),
                        label=class_names[int(lab)] if class_names else None,
                        keypoints=[(int(x), int(y), float(v)) for x, y, v in zip(kx, ky, kv)],
                    )
                )
            results.append(FocoosDetections(detections=dets))
        return results

    def eval_postprocess(self, output: RTMOModelOutput, batched_inputs: List[DatasetEntry], **kw):
        """→ [{"instances": Instances}] with boxes and keypoints [x, y, vis]
        in each entry's original frame, the detections with score > 0
        (JAX rtmo/processor.py:149-184). The input frame is the configured
        size, else the entry's own image (padding keeps each image's frame)."""
        image_sizes = [(e.height or 1, e.width or 1) for e in batched_inputs]
        ts = self._target_size()
        scores = output.scores.cpu().numpy()
        labels = output.labels.cpu().numpy()
        boxes = output.boxes.cpu().numpy().copy()
        kpts = output.keypoints.cpu().numpy().copy()
        kvis = output.keypoints_scores.cpu().numpy()
        for i, (e, (h, w)) in enumerate(zip(batched_inputs, image_sizes)):
            if ts is not None:
                fh, fw = ts
            elif e.image is not None:
                fh, fw = e.image.shape[:2]
            else:
                fh, fw = h, w
            sx, sy = w / fw, h / fh
            boxes[i, :, 0::2] *= sx
            boxes[i, :, 1::2] *= sy
            kpts[i, ..., 0] *= sx
            kpts[i, ..., 1] *= sy
        results = []
        for i, (h, w) in enumerate(image_sizes):
            keep = scores[i] > 0
            b = Boxes(boxes[i][keep])
            b.clip((h, w))
            inst = Instances(
                (h, w),
                boxes=b,
                scores=scores[i][keep],
                classes=labels[i][keep].astype(np.int64),
                keypoints=np.concatenate([kpts[i][keep], kvis[i][keep][..., None]], axis=-1),
            )
            results.append({"instances": inst})
        return results

    def export_postprocess(self, output, inputs, class_names: List[str] = [], **kw) -> List[FocoosDetections]:
        """(JAX processor.py:186-194)"""
        model_output = RTMOModelOutput(*as_tensors(output), loss=None)
        return self.postprocess(model_output, inputs, class_names, **kw)

    def get_output_names(self) -> List[str]:
        return ["scores", "labels", "boxes", "boxes_scores", "keypoints", "keypoints_scores", "keypoints_visible"]
