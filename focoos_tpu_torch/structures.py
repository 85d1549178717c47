"""Host-side containers of the port (copy of ``focoos_tpu/structures.py``,
trimmed to what ``focoos_tpu_torch`` and its tests use: ``BoxMode``,
``Boxes``, ``BitMasks`` with ``polygons_to_bitmask``, ``Keypoints``,
``Instances``, ``ImageList``).

The port keeps its own copy so that it runs without ``focoos_tpu``. Names
and behaviour are those of the JAX package's module. NumPy-backed: these
live on the host (target building, decode bookkeeping); everything on the
device is a tensor.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np


class BoxMode(IntEnum):
    """Box coordinate conventions (reference: focoos/structures.py:426)."""

    XYXY_ABS = 0
    XYWH_ABS = 1

    @staticmethod
    def convert(box: np.ndarray, from_mode: "BoxMode", to_mode: "BoxMode") -> np.ndarray:
        if from_mode == to_mode:
            return box
        box = np.asarray(box, dtype=np.float64).copy()
        if from_mode == BoxMode.XYWH_ABS and to_mode == BoxMode.XYXY_ABS:
            box[..., 2] += box[..., 0]
            box[..., 3] += box[..., 1]
            return box
        if from_mode == BoxMode.XYXY_ABS and to_mode == BoxMode.XYWH_ABS:
            box[..., 2] -= box[..., 0]
            box[..., 3] -= box[..., 1]
            return box
        raise NotImplementedError(f"{from_mode} -> {to_mode}")


class Boxes:
    """Nx4 float boxes in XYXY_ABS (reference: focoos/structures.py:18)."""

    def __init__(self, tensor: Union[np.ndarray, Sequence]):
        t = np.asarray(tensor, dtype=np.float32)
        if t.size == 0:
            t = t.reshape(0, 4)
        assert t.ndim == 2 and t.shape[-1] == 4, t.shape
        self.tensor = t

    def clip(self, box_size: Tuple[int, int]) -> None:
        h, w = box_size
        self.tensor[:, 0::2] = self.tensor[:, 0::2].clip(0, w)
        self.tensor[:, 1::2] = self.tensor[:, 1::2].clip(0, h)

    def nonempty(self, threshold: float = 0.0) -> np.ndarray:
        box = self.tensor
        widths = box[:, 2] - box[:, 0]
        heights = box[:, 3] - box[:, 1]
        return (widths > threshold) & (heights > threshold)

    def __getitem__(self, item) -> "Boxes":
        t = self.tensor[item]
        if t.ndim == 1:
            t = t[None]
        return Boxes(t)

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def __repr__(self) -> str:
        return f"Boxes({self.tensor})"


def polygons_to_bitmask(polygons: List[np.ndarray], height: int, width: int) -> np.ndarray:
    """Rasterize COCO polygons into a bool mask (reference: focoos/structures.py:228),
    with cv2.fillPoly (pycocotools is not a dependency)."""
    import cv2

    mask = np.zeros((height, width), dtype=np.uint8)
    pts = [np.round(np.asarray(p, dtype=np.float64).reshape(-1, 2)).astype(np.int32) for p in polygons]
    pts = [p for p in pts if len(p) >= 3]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask.astype(bool)


class BitMasks:
    """N binary masks of shape [N, H, W] (reference: focoos/structures.py:292)."""

    def __init__(self, tensor: np.ndarray):
        t = np.asarray(tensor)
        if t.dtype != bool:
            t = t.astype(bool)
        assert t.ndim == 3, t.shape
        self.tensor = t
        self.image_size = t.shape[1:]

    def __getitem__(self, item) -> "BitMasks":
        t = self.tensor[item]
        if t.ndim == 2:
            t = t[None]
        return BitMasks(t)

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def nonempty(self) -> np.ndarray:
        return self.tensor.reshape(len(self), -1).any(axis=1)

    def get_bounding_boxes(self) -> Boxes:
        """[xmin, ymin, xmax + 1, ymax + 1] of each mask, zeros for an empty one."""
        boxes = np.zeros((len(self), 4), dtype=np.float32)
        for i, m in enumerate(self.tensor):
            ys, xs = np.nonzero(m)
            if len(xs):
                boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
        return Boxes(boxes)

    @classmethod
    def from_polygon_masks(cls, polygons: List[List[np.ndarray]], height: int, width: int) -> "BitMasks":
        masks = [polygons_to_bitmask(p, height, width) for p in polygons]
        if len(masks) == 0:
            return cls(np.zeros((0, height, width), dtype=bool))
        return cls(np.stack(masks))


class Keypoints:
    """[N, K, 3] keypoints (x, y, visibility) (reference: focoos/structures.py:806)."""

    def __init__(self, keypoints: np.ndarray):
        t = np.asarray(keypoints, dtype=np.float32)
        if t.size == 0:
            t = t.reshape(0, 0, 3)
        assert t.ndim == 3 and t.shape[2] == 3, t.shape
        self.tensor = t

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def __getitem__(self, item) -> "Keypoints":
        t = self.tensor[item]
        if t.ndim == 2:
            t = t[None]
        return Keypoints(t)


class Instances:
    """Per-image field container (reference: focoos/structures.py:884).

    Fields (boxes, classes, scores, masks, keypoints, ...) are stored by name;
    all must share the first dimension. Slicing propagates to every field.
    """

    def __init__(self, image_size: Tuple[int, int], **kwargs: Any):
        self._image_size = tuple(image_size)
        self._fields: Dict[str, Any] = {}
        for k, v in kwargs.items():
            self.set(k, v)

    @property
    def image_size(self) -> Tuple[int, int]:
        return self._image_size

    def __setattr__(self, name: str, val: Any) -> None:
        if name.startswith("_"):
            super().__setattr__(name, val)
        else:
            self.set(name, val)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_") or name not in self._fields:
            raise AttributeError(f"Instances has no field '{name}'")
        return self._fields[name]

    def set(self, name: str, value: Any) -> None:
        if value is None:
            return
        with_len = len(value)
        if len(self._fields):
            assert len(self) == with_len, f"field {name} has length {with_len}, expected {len(self)}"
        self._fields[name] = value

    def has(self, name: str) -> bool:
        return name in self._fields

    def get(self, name: str) -> Any:
        return self._fields[name]

    def get_fields(self) -> Dict[str, Any]:
        return self._fields

    def __getitem__(self, item) -> "Instances":
        ret = Instances(self._image_size)
        for k, v in self._fields.items():
            ret.set(k, v[item])
        return ret

    def __len__(self) -> int:
        for v in self._fields.values():
            return len(v)
        return 0

    def __iter__(self) -> Iterator:
        raise NotImplementedError("`Instances` object is not iterable!")

    def __repr__(self) -> str:
        return f"Instances(num={len(self)}, image_size={self._image_size}, fields={list(self._fields)})"

class ImageList:
    """Pad-and-batch images to a common static shape (reference: focoos/structures.py:682).

    ``tensor`` is [B, H, W, C] NHWC; ``image_sizes`` records the un-padded
    (h, w) per image.
    """

    def __init__(self, tensor: np.ndarray, image_sizes: List[Tuple[int, int]]):
        self.tensor = tensor
        self.image_sizes = image_sizes

    def __len__(self) -> int:
        return len(self.image_sizes)

    @classmethod
    def from_tensors(
        cls,
        tensors: List[np.ndarray],
        size_divisibility: int = 0,
        pad_value: float = 0.0,
        square_size: int = 0,
        dtype: Optional[np.dtype] = None,
    ) -> "ImageList":
        assert len(tensors) > 0
        image_sizes = [(int(t.shape[0]), int(t.shape[1])) for t in tensors]
        max_h = max(s[0] for s in image_sizes)
        max_w = max(s[1] for s in image_sizes)
        if square_size > 0:
            max_h = max_w = square_size
        if size_divisibility > 1:
            d = size_divisibility
            max_h = (max_h + d - 1) // d * d
            max_w = (max_w + d - 1) // d * d
        c = tensors[0].shape[2] if tensors[0].ndim == 3 else 1
        # Batch in the input dtype (uint8 straight from the mapper is 4x less
        # host memory traffic than a float32 staging buffer on this 1-core
        # host; normalization happens on device anyway).
        batch = np.full((len(tensors), max_h, max_w, c), pad_value, dtype=dtype or tensors[0].dtype)
        for i, t in enumerate(tensors):
            if t.ndim == 2:
                t = t[:, :, None]
            batch[i, : t.shape[0], : t.shape[1]] = t
        return cls(batch, image_sizes)
