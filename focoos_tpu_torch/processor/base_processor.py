"""Processor protocol: model-family-specific pre/post-processing.

Port of ``focoos_tpu/processor/base_processor.py`` (reference:
focoos/processor/base_processor.py:55-296). Preprocessing produces an NHWC
batch: uint8 when every image is already at the target size, else float32
resized with ``F.interpolate(bilinear, align_corners=False, antialias=False)``
(the reference's resize, and what the JAX package's cv2 resize reproduces).
Neither PIL nor cv2 is needed for ndarray inputs: PIL is imported only when
an input is a PIL image.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from focoos_tpu.ports import DatasetEntry, FocoosDetections, ModelConfig


def _to_numpy_rgb(img) -> np.ndarray:
    """PIL / ndarray → HWC uint8 RGB."""
    if hasattr(img, "convert") and not isinstance(img, np.ndarray):
        from PIL import Image

        if isinstance(img, Image.Image):
            return np.asarray(img.convert("RGB"))
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    return arr


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """HWC image → float32 HWC at ``size`` (h, w), bilinear, half-pixel
    centers, no antialiasing, computed in float32."""
    t = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32)).permute(2, 0, 1)[None]
    out = F.interpolate(t, size=tuple(size), mode="bilinear", align_corners=False, antialias=False)
    return out[0].permute(1, 2, 0).numpy()


class Processor:
    """Abstract family processor (reference: focoos/processor/base_processor.py:55)."""

    def __init__(self, config: ModelConfig, image_size: Optional[Union[int, Tuple[int, int]]] = None):
        self.config = config
        self.image_size = image_size
        self.training = False

    def train(self, training: bool = True) -> "Processor":
        self.training = training
        return self

    def eval(self) -> "Processor":
        return self.train(False)

    def get_image_sizes(self, inputs) -> List[Tuple[int, int]]:
        """(h, w) per input image (reference: base_processor.py:176)."""
        if isinstance(inputs, (list, tuple)):
            return [tuple(_to_numpy_rgb(x).shape[:2]) for x in inputs]
        arr = _to_numpy_rgb(inputs)
        if arr.ndim == 4:
            return [tuple(arr.shape[1:3])] * arr.shape[0]
        return [tuple(arr.shape[:2])]

    def get_batch(self, inputs, target_size: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Images → NHWC batch, squash-resized to ``target_size``
        (reference: base_processor.py:223 get_torch_batch). Images already at
        the target size pass through as uint8."""
        if isinstance(inputs, (list, tuple)):
            imgs = list(inputs)
        else:
            arr = np.asarray(inputs) if isinstance(inputs, np.ndarray) else None
            imgs = [arr[i] for i in range(arr.shape[0])] if arr is not None and arr.ndim == 4 else [inputs]
        imgs = [_to_numpy_rgb(im) for im in imgs]
        if target_size is not None:
            th, tw = target_size
            if all(im.shape[:2] == (th, tw) for im in imgs):
                return np.stack(imgs).astype(np.uint8)
            return np.stack([
                im.astype(np.float32) if im.shape[:2] == (th, tw) else resize_bilinear(im, (th, tw))
                for im in imgs
            ])
        h = max(im.shape[0] for im in imgs)
        w = max(im.shape[1] for im in imgs)
        imgs = [np.pad(im, ((0, h - im.shape[0]), (0, w - im.shape[1]), (0, 0))) for im in imgs]
        return np.stack(imgs).astype(np.uint8)

    def _target_size(self) -> Optional[Tuple[int, int]]:
        if self.image_size is None:
            return None
        if isinstance(self.image_size, int):
            return (self.image_size, self.image_size)
        return tuple(self.image_size)  # type: ignore[return-value]

    # family-specific hooks
    def preprocess(self, inputs):
        raise NotImplementedError

    def postprocess(self, output, inputs, class_names: List[str] = [], **kw) -> List[FocoosDetections]:
        raise NotImplementedError

    def eval_postprocess(self, output, batched_inputs: List[DatasetEntry], **kw):
        raise NotImplementedError
