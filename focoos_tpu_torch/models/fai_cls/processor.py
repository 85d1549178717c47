"""fai_cls processor (port of focoos_tpu/models/fai_cls/processor.py;
reference: focoos/models/fai_cls/processor.py).

Serving squash-resizes each image to the model's resolution; the logits come
to the host ([B, num_classes]) and a class is reported where its sigmoid
exceeds the threshold. Evaluation takes the sigmoid on the device, right
behind the forward (``eval_decode``), and copies only the probabilities.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from focoos_tpu_torch.models.fai_cls.config import ClassificationConfig
from focoos_tpu_torch.models.fai_cls.ports import ClassificationDecode, ClassificationModelOutput, ClassificationTargets
from focoos_tpu_torch.ports import DatasetEntry, FocoosDet, FocoosDetections
from focoos_tpu_torch.processor.base_processor import Processor, as_tensors
from focoos_tpu_torch.structures import ImageList


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


class ClassificationProcessor(Processor):
    def __init__(self, config: ClassificationConfig, image_size: Optional[Union[int, Tuple[int, int]]] = None):
        super().__init__(config, image_size or config.resolution)
        self.num_classes = config.num_classes
        self.threshold = config.threshold

    def preprocess(self, inputs):
        """DatasetEntries → (uint8 NHWC batch padded to the largest, one-hot
        targets); images → (NHWC batch at the model's size, None)."""
        if isinstance(inputs, (list, tuple)) and len(inputs) > 0 and isinstance(inputs[0], DatasetEntry):
            return self.preprocess_entries(inputs)
        if self.training:
            raise ValueError("training preprocess expects a list of DatasetEntry")
        return self.get_batch(inputs, self._target_size()), None

    def preprocess_entries(self, entries: List[DatasetEntry], max_instances: int = 0):
        """Loader entry point → (uint8 NHWC batch, ``ClassificationTargets``
        [B, num_classes] with a 1 at each class of ``DatasetEntry.label``, an
        int or a list); ``max_instances`` is not used by classification."""
        batch = ImageList.from_tensors([e.image for e in entries]).tensor.astype(np.uint8, copy=False)
        labels = np.zeros((len(entries), self.num_classes), np.float32)
        for i, e in enumerate(entries):
            if e.label is not None:
                labels[i, e.label] = 1.0
        return batch, ClassificationTargets(torch.from_numpy(labels))

    def postprocess(
        self,
        output: ClassificationModelOutput,
        inputs,
        class_names: List[str] = [],
        threshold: Optional[float] = None,
        **kw,
    ) -> List[FocoosDetections]:
        threshold = self.threshold if threshold is None else threshold
        probs = _sigmoid(output.logits.cpu().numpy())
        results = []
        for p in probs:
            keep = np.nonzero(p > threshold)[0]
            results.append(FocoosDetections(detections=[
                FocoosDet(conf=float(p[c]), cls_id=int(c),
                          label=class_names[int(c)] if class_names and int(c) < len(class_names) else None)
                for c in keep
            ]))
        return results

    def eval_decode(self, output: ClassificationModelOutput, batched_inputs: List[DatasetEntry]):
        """The device half of ``eval_postprocess``: the sigmoid probabilities."""
        return ClassificationDecode(torch.sigmoid(output.logits.float()))

    def eval_postprocess(self, output, batched_inputs: List[DatasetEntry], **kw):
        """→ [{"logits": the sigmoid probabilities [num_classes]}] (JAX
        processor.py:84), from the model's output or ``eval_decode``'s."""
        if isinstance(output, ClassificationDecode):
            probs = output.probs.cpu().numpy()
        else:
            probs = _sigmoid(output.logits.cpu().numpy())
        return [{"logits": p} for p in probs]

    def export_postprocess(self, output, inputs, class_names: List[str] = [], **kw) -> List[FocoosDetections]:
        """(JAX processor.py:77-81)"""
        (logits,) = as_tensors(output)
        return self.postprocess(ClassificationModelOutput(logits=logits, loss=None), inputs, class_names, **kw)

    def get_output_names(self) -> List[str]:
        return ["logits"]
