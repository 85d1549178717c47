"""bisenetformer processor (port of focoos_tpu/models/bisenetformer/processor.py;
reference: focoos/models/bisenetformer/processor.py): fai_mf's decode, with
training targets at the stride-8 mask features (the FFM over res3)."""

from __future__ import annotations

from typing import List

from focoos_tpu_torch.models.fai_mf.processor import MaskFormerProcessor


class BisenetFormerProcessor(MaskFormerProcessor):
    mask_stride = 8

    def export_postprocess(self, output, inputs, class_names: List[str] = [], **kw):
        raise NotImplementedError("bisenetformer export is not ported yet (ROADMAP Queue 1 item 6)")

    def get_output_names(self) -> List[str]:
        raise NotImplementedError("bisenetformer export is not ported yet (ROADMAP Queue 1 item 6)")
