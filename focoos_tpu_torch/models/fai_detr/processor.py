"""fai_detr processor (port of focoos_tpu/models/fai_detr/processor.py;
reference: focoos/models/fai_detr/processor.py).

The decode runs on the model's device: flat top-k over the Q×C sigmoid
scores, then a box gather; only the [B, K] scores/labels/boxes go to the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from focoos_tpu.ports import DatasetEntry, FocoosDet, FocoosDetections
from focoos_tpu.structures import Boxes, ImageList, Instances
from focoos_tpu_torch.models.fai_detr.config import DETRConfig
from focoos_tpu_torch.models.fai_detr.ports import DETRModelOutput
from focoos_tpu_torch.processor.base_processor import Processor


def _decode_topk(logits: torch.Tensor, boxes: torch.Tensor, top_k: int):
    """[B,Q,C] scores + [B,Q,4] boxes → per-image flat top-k over Q×C
    (reference: fai_detr/processor.py:146-151) → numpy (scores, labels, boxes)."""
    b, q, c = logits.shape
    scores, idx = torch.topk(logits.reshape(b, q * c), min(top_k, q * c), dim=1)
    labels = idx % c
    sel = torch.gather(boxes, 1, (idx // c)[..., None].expand(-1, -1, 4))
    return scores.cpu().numpy(), labels.cpu().numpy(), sel.cpu().numpy()


class DETRProcessor(Processor):
    def __init__(self, config: DETRConfig, image_size: Optional[Union[int, Tuple[int, int]]] = None):
        super().__init__(config, image_size)
        self.top_k = config.top_k
        self.threshold = config.threshold

    def preprocess(self, inputs):
        """Images → (NHWC uint8/float32 batch, None). A list of DatasetEntry
        is batched for evaluation; training targets come with the training port."""
        if self.training:
            raise NotImplementedError("training preprocess is not ported yet (ROADMAP Queue 1 item 5)")
        if isinstance(inputs, (list, tuple)) and len(inputs) > 0 and isinstance(inputs[0], DatasetEntry):
            return ImageList.from_tensors([e.image for e in inputs]).tensor.astype(np.uint8, copy=False), None
        return self.get_batch(inputs, self._target_size()), None

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
