"""fai_detr processor (port of focoos_tpu/models/fai_detr/processor.py;
reference: focoos/models/fai_detr/processor.py).

The decode runs on the model's device: flat top-k over the Q×C sigmoid
scores, then a box gather; only the [B, K] scores/labels/boxes go to the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from focoos_tpu_torch.ports import DatasetEntry, FocoosDet, FocoosDetections
from focoos_tpu_torch.structures import Boxes, ImageList, Instances
from focoos_tpu_torch.models.fai_detr.config import DETRConfig
from focoos_tpu_torch.models.fai_detr.ports import DETRModelOutput, DETRTargets
from focoos_tpu_torch.processor.base_processor import Processor, as_tensors
from focoos_tpu_torch.ops.topk import topk_lowest_index_first


def _decode_topk(logits: torch.Tensor, boxes: torch.Tensor, top_k: int):
    """[B,Q,C] scores + [B,Q,4] boxes → per-image flat top-k over Q×C, ties
    in ``jax.lax.top_k``'s order (reference: fai_detr/processor.py:146-151)
    → numpy (scores, labels, boxes)."""
    b, q, c = logits.shape
    scores, idx = topk_lowest_index_first(logits.reshape(b, q * c), min(top_k, q * c), dim=1)
    labels = idx % c
    sel = torch.gather(boxes, 1, (idx // c)[..., None].expand(-1, -1, 4))
    return scores.cpu().numpy(), labels.cpu().numpy(), sel.cpu().numpy()


class DETRProcessor(Processor):
    def __init__(self, config: DETRConfig, image_size: Optional[Union[int, Tuple[int, int]]] = None):
        super().__init__(config, image_size)
        self.top_k = config.top_k
        self.threshold = config.threshold

    def preprocess(self, inputs):
        """Images/DatasetEntries → (NHWC uint8/float32 batch, DETRTargets | None)."""
        if isinstance(inputs, (list, tuple)) and len(inputs) > 0 and isinstance(inputs[0], DatasetEntry):
            return self.preprocess_entries(inputs)
        if self.training:
            raise ValueError("training preprocess expects a list of DatasetEntry")
        return self.get_batch(inputs, self._target_size()), None

    def preprocess_entries(
        self, entries: List[DatasetEntry], max_instances: int = 100
    ) -> Tuple[np.ndarray, Optional[DETRTargets]]:
        """Batch entries (uint8 NHWC, padded to the largest) and, in training,
        build targets padded to ``max_instances`` with a validity mask
        (focoos_tpu/models/fai_detr/processor.py:51-79)."""
        batch = ImageList.from_tensors([e.image for e in entries]).tensor.astype(np.uint8, copy=False)
        if not self.training:
            return batch, None
        b = len(entries)
        h, w = batch.shape[1:3]
        labels = np.zeros((b, max_instances), np.int64)
        boxes = np.zeros((b, max_instances, 4), np.float32)
        valid = np.zeros((b, max_instances), bool)
        for i, e in enumerate(entries):
            inst = e.instances
            if inst is None or len(inst) == 0:
                continue
            n = min(len(inst), max_instances)
            bx = inst.boxes.tensor[:n] / np.array([w, h, w, h], np.float32)
            boxes[i, :n] = np.concatenate([(bx[:, :2] + bx[:, 2:]) / 2, bx[:, 2:] - bx[:, :2]], axis=1)
            labels[i, :n] = inst.classes[:n]
            valid[i, :n] = True
        return batch, DETRTargets(torch.from_numpy(labels), torch.from_numpy(boxes), torch.from_numpy(valid))

    def postprocess(
        self,
        output: DETRModelOutput,
        inputs,
        class_names: List[str] = [],
        top_k: Optional[int] = None,
        threshold: Optional[float] = None,
    ) -> List[FocoosDetections]:
        top_k = top_k or self.top_k
        threshold = self.threshold if threshold is None else threshold
        scores, labels, boxes = _decode_topk(output.logits, output.boxes, top_k)
        results = []
        for i, (h, w) in enumerate(self.get_image_sizes(inputs)):
            keep = scores[i] > threshold
            bx = np.rint(boxes[i][keep] * np.array([w, h, w, h], np.float32)).astype(np.int32)
            results.append(FocoosDetections(detections=[
                FocoosDet(
                    bbox=b_.tolist(),
                    conf=float(s),
                    cls_id=int(lab),
                    label=class_names[int(lab)] if class_names else None,
                )
                for b_, s, lab in zip(bx, scores[i][keep], labels[i][keep])
            ]))
        return results

    def export_postprocess(self, output, inputs, class_names: List[str] = [], **kw) -> List[FocoosDetections]:
        """(JAX processor.py:138-141)"""
        boxes, logits = as_tensors(output)
        return self.postprocess(DETRModelOutput(boxes=boxes, logits=logits, loss=None), inputs, class_names, **kw)

    def get_output_names(self) -> List[str]:
        return ["boxes", "logits"]

    def eval_postprocess(self, output: DETRModelOutput, batched_inputs: List[DatasetEntry], top_k: Optional[int] = None):
        """→ [{"instances": Instances}] scaled to the original image size
        (reference: fai_detr/processor.py:121-144)."""
        scores, labels, boxes = _decode_topk(output.logits, output.boxes, top_k or self.top_k)
        results = []
        for i, entry in enumerate(batched_inputs):
            oh, ow = entry.height or 1, entry.width or 1
            b_obj = Boxes(boxes[i] * np.array([ow, oh, ow, oh], np.float32))
            b_obj.clip((oh, ow))
            inst = Instances((oh, ow), boxes=b_obj, scores=scores[i], classes=labels[i])
            results.append({"instances": inst[b_obj.nonempty()]})
        return results
