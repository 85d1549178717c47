"""bisenetformer processor (port of focoos_tpu/models/bisenetformer/processor.py;
reference: focoos/models/bisenetformer/processor.py): fai_mf's decode, with
training targets at the stride-8 mask features (the FFM over res3)."""

from __future__ import annotations

from typing import List

from focoos_tpu_torch.models.fai_mf.ports import MaskFormerModelOutput
from focoos_tpu_torch.models.fai_mf.processor import MaskFormerProcessor
from focoos_tpu_torch.ports import FocoosDetections
from focoos_tpu_torch.processor.base_processor import as_tensors


class BisenetFormerProcessor(MaskFormerProcessor):
    mask_stride = 8

    def export_postprocess(self, output, inputs, class_names: List[str] = [], **kw) -> List[FocoosDetections]:
        """The reverse of fai_mf's output order (JAX processor.py:19-25)."""
        logits, masks = as_tensors(output)
        return self.postprocess(MaskFormerModelOutput(masks=masks, logits=logits, loss=None), inputs, class_names, **kw)

    def get_output_names(self) -> List[str]:
        return ["logits", "masks"]
