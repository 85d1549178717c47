"""fai_mf processor (port of focoos_tpu/models/fai_mf/processor.py;
reference: focoos/models/fai_mf/processor.py).

Semantic mode: einsum of class probabilities × masks (or a per-pixel
argmax). Instance mode: top-k over the Q×C scores, binarized masks,
mask-score rescoring, boxes from masks. Serving (``postprocess``) copies the
[B, Q, H, W] mask stack to the host, as the JAX package does.

Evaluation decodes on the device by default, in ``eval_decode``, which the
evaluation loop queues right behind the forward: the semantic label map
(uint8 up to 255 classes), or the instance scores, labels, boxes and
bit-packed binary masks (``np.packbits`` order). Only those cross to the
host; when no entry of the batch needs a crop or a resize, the packed masks
stay on the device for the evaluator's mask IoU (``ops/mask_iou.py``). The
JAX package's switches pick the host paths instead: FOCOOS_SEMSEG_EVAL_HOST,
FOCOOS_INSTSEG_EVAL_HOST (the reference's exact resize-then-decode) and
FOCOOS_INSTSEG_EVAL_FETCH (packed masks to the host even when exact).
In training, ``preprocess_entries`` makes the padded mask targets. The
panoptic and export decodes are not ported yet (ROADMAP Queue 1 items 6
and 7).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from focoos_tpu_torch.models.fai_mf.config import MaskFormerConfig
from focoos_tpu_torch.models.fai_mf.ports import MaskFormerModelOutput, MaskFormerTargets
from focoos_tpu_torch.ops.topk import topk_lowest_index_first
from focoos_tpu_torch.ports import DatasetEntry, FocoosDet, FocoosDetections
from focoos_tpu_torch.processor.base_processor import Processor, as_tensors
from focoos_tpu_torch.structures import BitMasks, Boxes, ImageList, Instances
from focoos_tpu_torch.utils.vision import mask_to_base64_png


def _masks_to_xyxy(masks: np.ndarray) -> np.ndarray:
    """[N, H, W] bool → [N, 4] int boxes, max inclusive."""
    boxes = np.zeros((masks.shape[0], 4), np.int32)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if len(xs):
            boxes[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    return boxes


def _trim_mask(mask: np.ndarray, bbox) -> np.ndarray:
    """Crop a mask to its box, EXCLUSIVE of the max row and column, as the
    reference's ``trim_mask`` (focoos/utils/vision.py:264) on an inclusive-max
    box. A mask one row or column wide would crop to nothing, which no PNG
    holds (the JAX package raises there: ROADMAP Queue 3): that side keeps
    its one row or column."""
    x0, y0, x1, y1 = [int(v) for v in bbox]
    return mask[y0:max(y1, y0 + 1), x0:max(x1, x0 + 1)]


def _resize_mask_batch(masks: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[N, H, W] float → bilinear resize to (h, w) (cv2, as the JAX package)."""
    import cv2

    h, w = size
    if masks.shape[1:] == (h, w):
        return masks
    if not len(masks):
        return masks.reshape(0, h, w)
    return np.stack([cv2.resize(m.astype(np.float32), (w, h), interpolation=cv2.INTER_LINEAR) for m in masks])


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """``np.packbits(bits, axis=-1)`` on any device: eight booleans a byte,
    the first the most significant bit, the last byte padded with zeros."""
    n = bits.shape[-1]
    pad = (-n) % 8
    b = bits.to(torch.uint8)
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=bits.device)
    return (b.unflatten(-1, (-1, 8)) * weights).sum(-1, dtype=torch.uint8)


def _device_semantic_argmax(logits: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Label map on the model's device (JAX processor.py:52): einsum
    bqc,bqhw→bchw in fp32, then the argmax over classes (the first of equal
    maxima) → [B, H, W] uint8 when the classes fit, else int32."""
    sem = torch.einsum("bqc,bqhw->bchw", logits.float(), masks.float())
    return sem.argmax(1).to(torch.uint8 if logits.shape[-1] <= 255 else torch.int32)


def _device_instance_decode(logits: torch.Tensor, masks: torch.Tensor, top_k: int, mask_threshold: float):
    """Instance decode on the model's device (JAX processor.py:79): the flat
    top-k over the Q·C class probabilities (``jax.lax.top_k``'s tie order),
    the k masks gathered, mask-score rescoring, binarized at the input's
    size (after the model's upsample, the reference's order) and bit-packed.
    → (scores [B, K] fp32, labels [B, K] int32, packed [B, K, ⌈HW/8⌉] uint8,
    boxes [B, K, 4] fp32 as ``BitMasks.get_bounding_boxes``: [xmin, ymin,
    xmax+1, ymax+1], zeros for an empty mask). One image at a time, so the
    fp32 copy of the gathered masks is one image's."""
    b, q, c = logits.shape
    h, w = masks.shape[-2:]
    scores, idx = topk_lowest_index_first(logits.float().reshape(b, q * c), min(top_k, q * c), dim=1)
    labels = (idx % c).to(torch.int32)
    qidx = idx // c
    out_scores, packed, boxes = [], [], []
    ys = torch.arange(h, device=masks.device)
    xs = torch.arange(w, device=masks.device)
    for i in range(b):
        mp = masks[i][qidx[i]].float()  # [K, H, W]
        binm = mp > mask_threshold
        small = binm.float() * 1e-3
        num = (small * mp).flatten(1).sum(-1)
        den = small.flatten(1).sum(-1) + 1e-6
        out_scores.append(scores[i] * (num / den))
        packed.append(packbits(binm.flatten(1)))
        any_y, any_x = binm.any(2), binm.any(1)  # [K, H], [K, W]
        x1 = torch.where(any_x, xs, w).amin(-1)
        x2 = torch.where(any_x, xs + 1, 0).amax(-1)
        y1 = torch.where(any_y, ys, h).amin(-1)
        y2 = torch.where(any_y, ys + 1, 0).amax(-1)
        nonempty = any_x.any(-1)
        boxes.append(torch.stack([x1, y1, x2, y2], -1).float() * nonempty[:, None])
    return torch.stack(out_scores), labels, torch.stack(packed), torch.stack(boxes)


@dataclass
class SemanticDecode:
    """The device half of the semantic evaluation decode: the label map [B, H, W]."""

    sem_seg: torch.Tensor


@dataclass
class InstanceDecode:
    """The device half of the instance evaluation decode. ``packed`` [B, K,
    ⌈HW/8⌉] goes to the host with the rest when a crop or resize follows;
    else it is None and ``packed_on_device`` holds the masks, which the
    evaluation loop leaves where they are (``metadata["device"]``)."""

    scores: torch.Tensor
    labels: torch.Tensor
    boxes: torch.Tensor
    hw: Tuple[int, int]
    packed: Optional[torch.Tensor] = None
    packed_on_device: Optional[torch.Tensor] = field(default=None, metadata={"device": True})


def _numpy(t) -> np.ndarray:
    return t.float().cpu().numpy() if t.dtype == torch.bfloat16 else t.cpu().numpy()


class MaskFormerProcessor(Processor):
    mask_stride = 4  # the mask features' stride: the training targets' grid

    def __init__(self, config: MaskFormerConfig, image_size: Optional[Union[int, Tuple[int, int]]] = None):
        super().__init__(config, image_size)
        self.num_classes = config.num_classes
        self.top_k = config.top_k
        self.threshold = config.threshold
        self.mask_threshold = config.mask_threshold
        self.use_mask_score = config.use_mask_score
        self.predict_all_pixels = config.predict_all_pixels
        self.postprocessing_type = config.postprocessing_type

    # ------------------------------------------------------------------
    def preprocess(self, inputs):
        """Images or DatasetEntries → (NHWC uint8 batch, None). Images go in at
        their native resolution, padded to the largest: the reference does not
        apply image_size at inference (fai_mf/processor.py:94; JAX :140-150)."""
        if isinstance(inputs, (list, tuple)) and len(inputs) > 0 and isinstance(inputs[0], DatasetEntry):
            return self.preprocess_entries(inputs)
        if self.training:
            raise ValueError("training preprocess expects a list of DatasetEntry")
        return self.get_batch(inputs, None), None

    def preprocess_entries(self, entries: List[DatasetEntry], max_instances: int = 100):
        """DatasetEntries → (NHWC uint8 batch padded to the largest image,
        ``MaskFormerTargets`` in training, else None) (JAX processor.py:152-185).
        Each instance's mask is copied into the top-left of an [h, w] canvas
        and resized with cv2's bilinear, on fp32, to the mask features' grid
        ``ceil(h / self.mask_stride)`` x ``ceil(w / self.mask_stride)`` (the
        padded conv chain's size); at most ``max_instances`` a record (the
        loader passes ``TrainerArgs.max_instances_per_image``). CPU tensors only:
        this runs in the loader's worker processes."""
        batch = ImageList.from_tensors([e.image for e in entries]).tensor.astype(np.uint8, copy=False)
        if not self.training:
            return batch, None
        import cv2

        b, h, w = batch.shape[:3]
        hm, wm = -(-h // self.mask_stride), -(-w // self.mask_stride)
        labels = np.zeros((b, max_instances), np.int64)
        masks = np.zeros((b, max_instances, hm, wm), np.float32)
        valid = np.zeros((b, max_instances), bool)
        for i, e in enumerate(entries):
            inst = e.instances
            if inst is None or len(inst) == 0 or not inst.has("masks"):
                continue
            n = min(len(inst), max_instances)
            for j, gj in enumerate(inst.masks.tensor[:n]):
                canvas = np.zeros((h, w), np.float32)
                canvas[: gj.shape[0], : gj.shape[1]] = gj
                masks[i, j] = cv2.resize(canvas, (wm, hm), interpolation=cv2.INTER_LINEAR)
            labels[i, :n] = inst.classes[:n]
            valid[i, :n] = True
        return batch, MaskFormerTargets(torch.from_numpy(labels), torch.from_numpy(masks), torch.from_numpy(valid))

    # ------------------------------------------------------------------
    def semantic_inference(self, cls_probs: np.ndarray, masks: np.ndarray) -> np.ndarray:
        """einsum qc,qhw→chw (reference: fai_mf/processor.py:99-106)."""
        return np.einsum("qc,qhw->chw", cls_probs, masks)

    def instance_inference(self, cls_probs: np.ndarray, masks: np.ndarray) -> Instances:
        """top-k, mask-score rescoring, boxes from masks (reference :107-141).
        ``np.argpartition`` leaves the order of the k unspecified."""
        image_size = masks.shape[-2:]
        flat = cls_probs.reshape(-1)
        k = min(self.top_k, flat.size)
        topk = np.argpartition(-flat, k - 1)[:k]
        scores = flat[topk]
        labels = topk % self.num_classes
        mp = masks[topk // self.num_classes]
        binm = mp > self.mask_threshold
        small = binm * 1e-3
        mask_scores = (small.reshape(k, -1) * mp.reshape(k, -1)).sum(1) / (small.reshape(k, -1).sum(1) + 1e-6)
        return Instances(
            image_size,
            boxes=BitMasks(binm).get_bounding_boxes(),
            masks=BitMasks(binm),
            scores=scores * mask_scores,
            classes=labels.astype(np.int64),
        )

    # ------------------------------------------------------------------
    def eval_decode(self, output: MaskFormerModelOutput, batched_inputs: List[DatasetEntry]):
        """The device half of ``eval_postprocess``, queued behind the forward:
        a ``SemanticDecode`` or ``InstanceDecode``, or ``output`` itself where
        a FOCOOS_*_EVAL_HOST switch asks for the host path."""
        if self.postprocessing_type == "semantic":
            if os.environ.get("FOCOOS_SEMSEG_EVAL_HOST"):
                return output
            return SemanticDecode(_device_semantic_argmax(output.logits, output.masks))
        if os.environ.get("FOCOOS_INSTSEG_EVAL_HOST"):
            return output
        hw = tuple(output.masks.shape[-2:])
        scores, labels, packed, boxes = _device_instance_decode(
            output.logits, output.masks, self.top_k, self.mask_threshold)

        def exact(entry: DatasetEntry) -> bool:
            size = entry.image.shape[:2] if entry.image is not None else hw
            return tuple(size) == hw == (entry.height or size[0], entry.width or size[1])

        if all(exact(e) for e in batched_inputs) and not os.environ.get("FOCOOS_INSTSEG_EVAL_FETCH"):
            return InstanceDecode(scores, labels, boxes, hw, packed_on_device=packed)
        return InstanceDecode(scores, labels, boxes, hw, packed=packed)

    def eval_postprocess(self, output, batched_inputs: List[DatasetEntry], **kw):
        """→ [{"sem_seg": label map}] or [{"instances": Instances}] at each
        entry's original size (JAX processor.py:274-383). ``output`` is the
        model's output or what ``eval_decode`` made of it."""
        if isinstance(output, MaskFormerModelOutput):
            output = self.eval_decode(output, batched_inputs)
        if isinstance(output, SemanticDecode):
            # the einsum commutes with the crop (per pixel) and the bilinear resize
            # (both linear): the evaluator resizes the argmax, nearest, to the
            # ground truth's shape (boundary-pixel deltas against the host path)
            pred = output.sem_seg.cpu().numpy()
            results = []
            for i, entry in enumerate(batched_inputs):
                size = entry.image.shape[:2] if entry.image is not None else pred.shape[-2:]
                results.append({"sem_seg": pred[i][: size[0], : size[1]]})
            return results
        if isinstance(output, InstanceDecode):
            return self._instances_from_decode(output, batched_inputs)
        return self._host_eval_postprocess(output, batched_inputs)

    def _instances_from_decode(self, dec: InstanceDecode, batched_inputs: List[DatasetEntry]) -> List[dict]:
        scores, labels, boxes = dec.scores.cpu().numpy(), dec.labels.cpu().numpy(), dec.boxes.cpu().numpy()
        h_in, w_in = dec.hw
        results = []
        if dec.packed is None:
            # no crop or resize anywhere in the batch: the packed masks stay on the
            # device for the evaluator's IoU (JAX :319-339)
            for i in range(len(batched_inputs)):
                inst = Instances((h_in, w_in), boxes=Boxes(boxes[i]), scores=scores[i],
                                 classes=labels[i].astype(np.int64), masks_packed=dec.packed_on_device[i])
                inst._masks_packed_hw = (h_in, w_in)
                results.append({"instances": inst})
            return results
        import cv2

        packed = dec.packed.cpu().numpy()
        k = packed.shape[1]
        for i, entry in enumerate(batched_inputs):
            size = entry.image.shape[:2] if entry.image is not None else (h_in, w_in)
            height, width = entry.height or size[0], entry.width or size[1]
            binm = np.unpackbits(packed[i], axis=-1, count=h_in * w_in).reshape(k, h_in, w_in)
            exact = (size[0], size[1]) == (h_in, w_in) == (height, width)
            binm = binm[:, : size[0], : size[1]]
            if (size[0], size[1]) != (height, width):
                binm = np.stack([
                    cv2.resize(m, (width, height), interpolation=cv2.INTER_NEAREST) for m in binm
                ]) if k else binm.reshape(0, height, width)
            bm = BitMasks(binm.astype(bool))
            # the device's boxes hold only where no crop or resize intervened
            inst = Instances((height, width), boxes=Boxes(boxes[i]) if exact else bm.get_bounding_boxes(),
                             masks=bm, scores=scores[i], classes=labels[i].astype(np.int64))
            results.append({"instances": inst})
        return results

    def _host_eval_postprocess(self, output: MaskFormerModelOutput, batched_inputs: List[DatasetEntry]) -> List[dict]:
        """The reference's exact path (fai_mf/processor.py:107-167): crop,
        bilinear resize of the probabilities, then decode, on the host."""
        cls_pred = _numpy(output.logits)
        mask_pred = _numpy(output.masks)
        results = []
        for i, entry in enumerate(batched_inputs):
            size = entry.image.shape[:2] if entry.image is not None else mask_pred.shape[-2:]
            height, width = entry.height or size[0], entry.width or size[1]
            mp = _resize_mask_batch(mask_pred[i][:, : size[0], : size[1]], (height, width))
            if self.postprocessing_type == "semantic":
                results.append({"sem_seg": self.semantic_inference(cls_pred[i], mp)})
            else:
                results.append({"instances": self.instance_inference(cls_pred[i], mp)})
        return results

    # ------------------------------------------------------------------
    def postprocess(
        self,
        output: MaskFormerModelOutput,
        inputs,
        class_names: List[str] = [],
        top_k: Optional[int] = None,
        threshold: Optional[float] = None,
        use_mask_score: Optional[bool] = None,
        predict_all_pixels: Optional[bool] = None,
        **kw,
    ) -> List[FocoosDetections]:
        """Detections with base64 PNG masks cropped to their boxes (JAX :385-448)."""
        threshold = self.threshold if threshold is None else threshold
        use_mask_score = self.use_mask_score if use_mask_score is None else use_mask_score
        predict_all_pixels = self.predict_all_pixels if predict_all_pixels is None else predict_all_pixels

        image_sizes = self.get_image_sizes(inputs)
        cls_pred = _numpy(output.logits)  # [B, Q, C] probabilities
        mask_pred = _numpy(output.masks).astype(np.float32, copy=False)  # [B, Q, H, W] probabilities
        scores_all = cls_pred.max(-1)
        labels_all = cls_pred.argmax(-1)

        results = []
        for i, (h, w) in enumerate(image_sizes):
            scores, labels, mp = scores_all[i], labels_all[i], mask_pred[i]
            if predict_all_pixels:
                assign = (scores[:, None, None] * mp).argmax(0)  # [H, W]
                binm = assign[None] == np.arange(mp.shape[0])[:, None, None]
            else:
                binm = mp >= self.mask_threshold

            keep = binm.sum((-2, -1)) > 1
            scores, labels, binm, mp = scores[keep], labels[keep], binm[keep], mp[keep]
            if use_mask_score and len(scores):
                small = binm.astype(np.float32) * 1e-3
                scores = scores * (small * mp).sum((-2, -1)) / (small.sum((-2, -1)) + 1e-5)
            if threshold > 0:
                keep = scores > threshold
                scores, labels, binm = scores[keep], labels[keep], binm[keep]

            dets = []
            if len(scores):
                # the reference (fai_mf/processor.py:282) resizes the binary mask
                # bilinearly and takes ``.bool()``: any value > 0 is foreground
                resized = _resize_mask_batch(binm.astype(np.float32), (h, w)) > 0
                boxes = _masks_to_xyxy(resized)
                for bx, s, lab, m in zip(boxes.tolist(), scores.tolist(), labels.tolist(), resized):
                    dets.append(FocoosDet(
                        bbox=bx,
                        conf=float(s),
                        cls_id=int(lab),
                        mask=mask_to_base64_png(_trim_mask(m, bx)),
                        label=class_names[int(lab)] if class_names else None,
                    ))
            results.append(FocoosDetections(detections=dets))
        return results

    def export_postprocess(self, output, inputs, class_names: List[str] = [], **kw) -> List[FocoosDetections]:
        """(JAX processor.py:450-456)"""
        masks, logits = as_tensors(output)
        return self.postprocess(MaskFormerModelOutput(masks=masks, logits=logits, loss=None), inputs, class_names, **kw)

    def get_output_names(self) -> List[str]:
        return ["masks", "logits"]
