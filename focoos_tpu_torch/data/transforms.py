"""Augmentation system: numpy/cv2/PIL host-side transforms (copy of
``focoos_tpu/data/transforms.py``).

Re-design of the reference's detectron2-fork transform stack
(focoos/data/transforms/{augmentation,transform}.py): the
``Augmentation.get_transform(image) → Transform`` protocol; deterministic
``Transform``s carry apply_image / apply_coords / apply_box /
apply_segmentation so boxes and keypoints stay consistent. Every random
draw is the JAX package's, in the same order, from the global ``np.random``
state: seeded alike, both packages augment a record identically. cv2 and PIL
are imported where an image is transformed, never at import; uint8 resizes go
through PIL's antialiased bilinear, as the reference's, unless
``FOCOOS_RESIZE_BACKEND=cv2`` (the JAX package's switch). Besides what the
presets build, a user's own augmentation list may name the JAX package's
other augmentations: ``ResizeLongestEdge``, ``ResizeScale``,
``FixedSizeCrop``, ``RandomCropWithInstance``, ``MinIoURandomCrop``
(``MinIoURandomCrop`` draws its IoU mode from Python's ``random``, as JAX's),
``RandomResize``, ``RandomExtent``, the blend-based ``RandomContrast``,
``RandomBrightness``, ``RandomSaturation`` and ``RandomLighting``, and the
``ExtentTransform`` and ``BlendTransform`` they carry.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


# ---------------------------------------------------------------------------
# deterministic transforms
# ---------------------------------------------------------------------------


class Transform:
    def apply_image(self, img: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def apply_box(self, boxes: np.ndarray) -> np.ndarray:
        """[N, 4] xyxy — transformed via the 4 corners (axis-aligned hull)."""
        if len(boxes) == 0:
            return boxes
        idx = np.array([(0, 1), (2, 1), (0, 3), (2, 3)]).flatten()
        corners = np.asarray(boxes, np.float64)[:, idx].reshape(-1, 2)
        corners = self.apply_coords(corners).reshape(-1, 4, 2)
        minxy = corners.min(axis=1)
        maxxy = corners.max(axis=1)
        return np.concatenate([minxy, maxxy], axis=1).astype(np.float32)

    def apply_segmentation(self, seg: np.ndarray) -> np.ndarray:
        return self.apply_image(seg)


class TransformList(Transform):
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = [t for t in transforms if not isinstance(t, NoOpTransform)]

    def apply_image(self, img):
        for t in self.transforms:
            img = t.apply_image(img)
        return img

    def apply_coords(self, coords):
        for t in self.transforms:
            coords = t.apply_coords(coords)
        return coords

    def apply_box(self, boxes):
        for t in self.transforms:
            boxes = t.apply_box(boxes)
        return boxes

    def apply_segmentation(self, seg):
        for t in self.transforms:
            seg = t.apply_segmentation(seg)
        return seg

    def __add__(self, other: "TransformList") -> "TransformList":
        return TransformList(self.transforms + list(getattr(other, "transforms", [other])))


class NoOpTransform(Transform):
    def apply_image(self, img):
        return img

    def apply_coords(self, coords):
        return coords

    def apply_segmentation(self, seg):
        return seg


class HFlipTransform(Transform):
    def __init__(self, width: int):
        self.width = width

    def apply_image(self, img):
        return np.ascontiguousarray(img[:, ::-1])

    def apply_coords(self, coords):
        coords = coords.copy()
        coords[:, 0] = self.width - coords[:, 0]
        return coords


class VFlipTransform(Transform):
    def __init__(self, height: int):
        self.height = height

    def apply_image(self, img):
        return np.ascontiguousarray(img[::-1])

    def apply_coords(self, coords):
        coords = coords.copy()
        coords[:, 1] = self.height - coords[:, 1]
        return coords


class ResizeTransform(Transform):
    """Resize matching the reference's backends EXACTLY
    (transform.py:111-152): uint8 goes through PIL (whose bilinear is
    ANTIALIASED on downscale — cv2 INTER_LINEAR is not, and differs on 96%
    of pixels at 37→21; measured in tools/parity_aug.py), other dtypes
    through the torch-interpolate convention (== cv2 INTER_LINEAR at
    align_corners=False); segmentation uses PIL NEAREST for uint8 and the
    torch floor-mapping nearest otherwise."""

    def __init__(self, h: int, w: int, new_h: int, new_w: int, interp: Optional[int] = None):
        self.h, self.w, self.new_h, self.new_w = h, w, new_h, new_w
        self.interp = interp  # PIL resampling for uint8; None = BILINEAR

    def _pil_resize(self, img: np.ndarray, resample) -> np.ndarray:
        from PIL import Image

        squeeze = img.ndim > 2 and img.shape[2] == 1
        pil = Image.fromarray(img[:, :, 0] if squeeze else img, mode="L" if squeeze else None)
        out = np.asarray(pil.resize((self.new_w, self.new_h), resample))
        return out[..., None] if squeeze else out

    def apply_image(self, img):
        if img.shape[:2] == (self.new_h, self.new_w):
            return img
        if img.dtype == np.uint8:
            # FOCOOS_RESIZE_BACKEND=cv2 trades reference-exactness for host
            # speed (cv2 is not antialiased on downscale, PIL/the reference is)
            if os.environ.get("FOCOOS_RESIZE_BACKEND", "pil").lower() != "cv2":
                from PIL import Image

                return self._pil_resize(img, Image.BILINEAR if self.interp is None else self.interp)
        import cv2

        return cv2.resize(img, (self.new_w, self.new_h), interpolation=cv2.INTER_LINEAR)

    def apply_coords(self, coords):
        coords = coords.copy().astype(np.float64)
        coords[:, 0] *= self.new_w / self.w
        coords[:, 1] *= self.new_h / self.h
        return coords

    def apply_segmentation(self, seg):
        if seg.shape[:2] == (self.new_h, self.new_w):
            return seg
        if seg.dtype == np.uint8:
            from PIL import Image

            return self._pil_resize(seg, Image.NEAREST)
        # torch-convention nearest: floor mapping of output-pixel centers
        ys = np.floor(np.arange(self.new_h) * (self.h / self.new_h)).astype(np.int64)
        xs = np.floor(np.arange(self.new_w) * (self.w / self.new_w)).astype(np.int64)
        return seg[np.clip(ys, 0, self.h - 1)[:, None], np.clip(xs, 0, self.w - 1)[None, :]]


class CropTransform(Transform):
    def __init__(self, x0: int, y0: int, w: int, h: int):
        self.x0, self.y0, self.w, self.h = int(x0), int(y0), int(w), int(h)

    def apply_image(self, img):
        return img[self.y0 : self.y0 + self.h, self.x0 : self.x0 + self.w]

    def apply_coords(self, coords):
        coords = coords.copy()
        coords[:, 0] -= self.x0
        coords[:, 1] -= self.y0
        return coords


class PadTransform(Transform):
    def __init__(self, x0: int, y0: int, x1: int, y1: int, pad_value: float = 128.0, seg_pad_value: int = 255):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.pad_value = pad_value
        self.seg_pad_value = seg_pad_value

    def apply_image(self, img):
        pads = ((self.y0, self.y1), (self.x0, self.x1)) + ((0, 0),) * (img.ndim - 2)
        return np.pad(img, pads, constant_values=self.pad_value)

    def apply_coords(self, coords):
        coords = coords.copy()
        coords[:, 0] += self.x0
        coords[:, 1] += self.y0
        return coords

    def apply_segmentation(self, seg):
        pads = ((self.y0, self.y1), (self.x0, self.x1)) + ((0, 0),) * (seg.ndim - 2)
        return np.pad(seg, pads, constant_values=self.seg_pad_value)


class RotationTransform(Transform):
    """Rotate around the image center, optionally expanding to fit
    (reference: transforms/transform.py RotationTransform)."""

    def __init__(self, h: int, w: int, angle: float, expand: bool = True,
                 center=None, interp: Optional[int] = None):
        import cv2

        self.h, self.w, self.angle, self.expand = h, w, angle, expand
        self.interp = cv2.INTER_LINEAR if interp is None else interp
        # reference-exact conventions (transform.py:159-240): center (w/2,h/2),
        # rint'ed expand bounds, separate coord/image matrices (the image one
        # offset by -0.5 for cv2's warpAffine half-pixel issue, opencv#11784)
        self.image_center = np.array((w / 2, h / 2))
        self.center = self.image_center if center is None else np.asarray(center, np.float64)
        abs_cos, abs_sin = abs(np.cos(np.deg2rad(angle))), abs(np.sin(np.deg2rad(angle)))
        if expand:
            self.new_w, self.new_h = np.rint(
                [h * abs_sin + w * abs_cos, h * abs_cos + w * abs_sin]
            ).astype(int)
        else:
            self.new_w, self.new_h = w, h
        self.rm = self._rotation_matrix()
        self.rm_image = self._rotation_matrix(offset=-0.5)

    def _rotation_matrix(self, offset: float = 0.0):
        import cv2

        center = (float(self.center[0] + offset), float(self.center[1] + offset))
        rm = cv2.getRotationMatrix2D(center, self.angle, 1.0)
        if self.expand:
            rot_im_center = cv2.transform(self.image_center[None, None, :] + offset, rm)[0, 0, :]
            new_center = np.array([self.new_w / 2, self.new_h / 2]) + offset - rot_im_center
            rm[:, 2] += new_center
        return rm

    def apply_image(self, img):
        import cv2

        if len(img) == 0 or self.angle % 360 == 0:
            return img
        return cv2.warpAffine(img, self.rm_image, (self.new_w, self.new_h), flags=self.interp)

    def apply_coords(self, coords):
        coords = np.asarray(coords, np.float64)
        if len(coords) == 0 or self.angle % 360 == 0:
            return coords
        ones = np.ones((len(coords), 1))
        return (np.hstack([coords, ones]) @ self.rm.T).astype(np.float64)

    def apply_segmentation(self, seg):
        import cv2

        if len(seg) == 0 or self.angle % 360 == 0:
            return seg
        # reference fills rotation padding with 0 (transform.py:226 uses the
        # cv2 default border) — kept identical for training parity
        return cv2.warpAffine(
            seg, self.rm_image, (self.new_w, self.new_h), flags=cv2.INTER_NEAREST
        )


class ExtentTransform(Transform):
    """Crop a (possibly out-of-bounds) subrect and resample to a fixed output
    size; out-of-source pixels read the fill color. uint8 goes through PIL
    Image.EXTENT bilinear exactly like the reference (transform.py:28-68);
    other dtypes use a nearest floor-sampled numpy fallback."""

    def __init__(self, src_rect, output_size, fill=0):
        self.src_rect = tuple(float(v) for v in src_rect)  # x0, y0, x1, y1
        self.output_size = (int(output_size[0]), int(output_size[1]))  # h, w
        self.fill = fill

    def apply_image(self, img, nearest: bool = False):
        out_h, out_w = self.output_size
        if img.dtype == np.uint8:
            from PIL import Image

            squeeze = img.ndim > 2 and img.shape[2] == 1
            pil = Image.fromarray(img[:, :, 0] if squeeze else img, mode="L" if squeeze else None)
            pil = pil.transform(size=(out_w, out_h), method=Image.EXTENT, data=self.src_rect,
                                resample=Image.NEAREST if nearest else Image.BILINEAR, fill=self.fill)
            out = np.asarray(pil)
            return out[..., None] if squeeze else out
        x0, y0, x1, y1 = self.src_rect
        xs = x0 + (np.arange(out_w) + 0.5) * (x1 - x0) / out_w
        ys = y0 + (np.arange(out_h) + 0.5) * (y1 - y0) / out_h
        xi = np.floor(xs).astype(np.int64)
        yi = np.floor(ys).astype(np.int64)
        h, w = img.shape[:2]
        valid = (yi[:, None] >= 0) & (yi[:, None] < h) & (xi[None, :] >= 0) & (xi[None, :] < w)
        out_shape = (out_h, out_w) + img.shape[2:]
        out = np.zeros(out_shape, img.dtype)
        yc = np.clip(yi, 0, h - 1)
        xc = np.clip(xi, 0, w - 1)
        sampled = img[yc[:, None], xc[None, :]]
        out[valid] = sampled[valid]
        return out

    def apply_segmentation(self, seg):
        return self.apply_image(seg, nearest=True)

    def apply_coords(self, coords):
        x0, y0, x1, y1 = self.src_rect
        out_h, out_w = self.output_size
        coords = coords.astype(np.float64).copy()
        coords[:, 0] = (coords[:, 0] - x0) * out_w / max(x1 - x0, 1e-9)
        coords[:, 1] = (coords[:, 1] - y0) * out_h / max(y1 - y0, 1e-9)
        return coords


class BlendTransform(Transform):
    """dst = src_weight * src_image + dst_weight * img (color jitter carrier)."""

    def __init__(self, src_image, src_weight: float, dst_weight: float):
        self.src_image = src_image
        self.src_weight = src_weight
        self.dst_weight = dst_weight

    def apply_image(self, img):
        out = self.src_weight * self.src_image + self.dst_weight * img.astype(np.float64)
        return np.clip(out, 0, 255).astype(np.uint8) if img.dtype == np.uint8 else out.astype(img.dtype)

    def apply_coords(self, coords):
        return coords

    def apply_segmentation(self, seg):
        return seg


# ---------------------------------------------------------------------------
# augmentation protocol (reference: transforms/augmentation.py:104-392)
# ---------------------------------------------------------------------------


class AugInput:
    def __init__(self, image: np.ndarray, boxes: Optional[np.ndarray] = None, sem_seg: Optional[np.ndarray] = None):
        self.image = image
        self.boxes = boxes
        self.sem_seg = sem_seg

    def transform(self, tfm: Transform) -> None:
        self.image = tfm.apply_image(self.image)
        if self.boxes is not None:
            self.boxes = tfm.apply_box(self.boxes)
        if self.sem_seg is not None:
            self.sem_seg = tfm.apply_segmentation(self.sem_seg)


class Augmentation:
    def get_transform(self, image: np.ndarray) -> Transform:
        raise NotImplementedError

    def __call__(self, aug_input: AugInput) -> Transform:
        tfm = self.get_transform(aug_input.image)
        aug_input.transform(tfm)
        return tfm


class _FixedTransformAug(Augmentation):
    """Wrap a deterministic Transform as an Augmentation (the reference's
    AugmentationList accepts Union[Augmentation, Transform] the same way,
    augmentation.py _transform_to_aug)."""

    def __init__(self, tfm: Transform):
        self.tfm = tfm

    def get_transform(self, image):
        return self.tfm


class AugmentationList(Augmentation):
    def __init__(self, augs: Sequence[Union[Augmentation, Transform]]):
        self.augs = [a if isinstance(a, Augmentation) else _FixedTransformAug(a) for a in augs]

    def __call__(self, aug_input: AugInput) -> TransformList:
        tfms = []
        for aug in self.augs:
            tfms.append(aug(aug_input))
        return TransformList(tfms)


def _rand(low, high):
    return np.random.uniform(low, high)


class RandomApply(Augmentation):
    def __init__(self, aug: Augmentation, prob: float = 0.5):
        self.aug = aug
        self.prob = prob

    def __call__(self, aug_input):
        if np.random.rand() < self.prob:
            return self.aug(aug_input)
        return NoOpTransform()

    def get_transform(self, image):
        if np.random.rand() < self.prob:
            return self.aug.get_transform(image)
        return NoOpTransform()


class RandomFlip(Augmentation):
    """(reference :433)"""

    def __init__(self, prob: float = 0.5, horizontal: bool = True, vertical: bool = False):
        self.prob = prob
        self.horizontal = horizontal
        self.vertical = vertical

    def get_transform(self, image):
        h, w = image.shape[:2]
        if np.random.rand() < self.prob:
            if self.horizontal:
                return HFlipTransform(w)
            if self.vertical:
                return VFlipTransform(h)
        return NoOpTransform()


class Resize(Augmentation):
    """(reference :470)"""

    def __init__(self, shape: Union[int, Tuple[int, int]], interp: Optional[int] = None):
        self.shape = (shape, shape) if isinstance(shape, int) else tuple(shape)
        self.interp = interp

    def get_transform(self, image):
        h, w = image.shape[:2]
        return ResizeTransform(h, w, self.shape[0], self.shape[1], self.interp)


class ResizeShortestEdge(Augmentation):
    """(reference :492)"""

    def __init__(self, short_edge_length, max_size: int = 1 << 30, sample_style: str = "choice"):
        if isinstance(short_edge_length, int):
            short_edge_length = (short_edge_length, short_edge_length)
        self.short_edge_length = short_edge_length
        self.max_size = max_size
        self.sample_style = sample_style

    def get_transform(self, image):
        h, w = image.shape[:2]
        if self.sample_style == "range":
            size = np.random.randint(self.short_edge_length[0], self.short_edge_length[1] + 1)
        else:
            size = np.random.choice(self.short_edge_length)
        if size == 0:
            return NoOpTransform()
        scale = size / min(h, w)
        if max(h, w) * scale > self.max_size:
            scale = self.max_size / max(h, w)
        return ResizeTransform(h, w, int(h * scale + 0.5), int(w * scale + 0.5))


class ResizeLongestEdge(Augmentation):
    """(reference :568)"""

    def __init__(self, long_edge_length, sample_style: str = "choice"):
        if isinstance(long_edge_length, int):
            long_edge_length = (long_edge_length, long_edge_length)
        self.long_edge_length = long_edge_length
        self.sample_style = sample_style

    def get_transform(self, image):
        h, w = image.shape[:2]
        if self.sample_style == "range":
            size = np.random.randint(self.long_edge_length[0], self.long_edge_length[1] + 1)
        else:
            size = np.random.choice(self.long_edge_length)
        if size == 0:
            return NoOpTransform()
        scale = size / max(h, w)
        return ResizeTransform(h, w, int(h * scale + 0.5), int(w * scale + 0.5))


class ResizeScale(Augmentation):
    """Scale by a random factor then resize into a target box, keeping aspect
    (LSJ component, reference :620)."""

    def __init__(self, min_scale: float, max_scale: float, target_height: int, target_width: int):
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.th = target_height
        self.tw = target_width

    def get_transform(self, image):
        h, w = image.shape[:2]
        scale = _rand(self.min_scale, self.max_scale)
        out_scale = min(self.th * scale / h, self.tw * scale / w)
        return ResizeTransform(h, w, int(h * out_scale + 0.5), int(w * out_scale + 0.5))


class RandomRotation(Augmentation):
    """(reference :681)"""

    def __init__(self, angle, expand: bool = True, sample_style: str = "range", prob: float = 1.0):
        if isinstance(angle, (int, float)):
            angle = (-angle, angle)
        self.angle = angle
        self.expand = expand
        self.sample_style = sample_style
        self.prob = prob

    def get_transform(self, image):
        if np.random.rand() >= self.prob:
            return NoOpTransform()
        h, w = image.shape[:2]
        if self.sample_style == "range":
            angle = _rand(self.angle[0], self.angle[1])
        else:
            angle = np.random.choice(self.angle)
        if angle % 360 == 0:
            return NoOpTransform()
        return RotationTransform(h, w, angle, self.expand)


class FixedSizeCrop(Augmentation):
    """Crop (or pad) to a fixed size (reference :741)."""

    def __init__(self, crop_size: Tuple[int, int], pad_value: float = 128.0, seg_pad_value: int = 255):
        self.crop_size = crop_size
        self.pad_value = pad_value
        self.seg_pad_value = seg_pad_value

    def get_transform(self, image):
        h, w = image.shape[:2]
        ch, cw = self.crop_size
        offset_h = np.random.randint(0, max(h - ch, 0) + 1)
        offset_w = np.random.randint(0, max(w - cw, 0) + 1)
        tfms = [CropTransform(offset_w, offset_h, min(cw, w), min(ch, h))]
        pad_h = max(ch - h, 0)
        pad_w = max(cw - w, 0)
        if pad_h or pad_w:
            tfms.append(PadTransform(0, 0, pad_w, pad_h, self.pad_value, self.seg_pad_value))
        return TransformList(tfms)


class RandomCrop(Augmentation):
    """(reference :818) crop_type: relative_range | relative | absolute | absolute_range"""

    def __init__(self, crop_type: str, crop_size):
        self.crop_type = crop_type
        self.crop_size = crop_size

    def get_crop_size(self, image_size):
        h, w = image_size
        if self.crop_type == "relative":
            ch, cw = self.crop_size
            return int(h * ch + 0.5), int(w * cw + 0.5)
        if self.crop_type == "relative_range":
            cs = np.asarray(self.crop_size, np.float32)
            ch, cw = cs + np.random.rand(2) * (1 - cs)
            return int(h * ch + 0.5), int(w * cw + 0.5)
        if self.crop_type == "absolute":
            return min(self.crop_size[0], h), min(self.crop_size[1], w)
        if self.crop_type == "absolute_range":
            ch = np.random.randint(min(h, self.crop_size[0]), min(h, self.crop_size[1]) + 1)
            cw = np.random.randint(min(w, self.crop_size[0]), min(w, self.crop_size[1]) + 1)
            return ch, cw
        raise NotImplementedError(self.crop_type)

    def get_transform(self, image):
        h, w = image.shape[:2]
        ch, cw = self.get_crop_size((h, w))
        y0 = np.random.randint(h - ch + 1)
        x0 = np.random.randint(w - cw + 1)
        return CropTransform(x0, y0, cw, ch)


class RandomCropWithInstance(RandomCrop):
    """Category-area-constrained crop for semseg (reference :884): retries so
    the crop does not consist of a single category."""

    def __init__(self, crop_type: str, crop_size, single_category_max_area: float = 1.0, ignored_category: int = 255):
        super().__init__(crop_type, crop_size)
        self.single_category_max_area = single_category_max_area
        self.ignored_category = ignored_category

    def get_transform_with_sem_seg(self, image, sem_seg):
        if self.single_category_max_area >= 1.0 or sem_seg is None:
            return super().get_transform(image)
        h, w = image.shape[:2]
        for _ in range(10):
            ch, cw = self.get_crop_size((h, w))
            y0 = np.random.randint(h - ch + 1)
            x0 = np.random.randint(w - cw + 1)
            patch = sem_seg[y0 : y0 + ch, x0 : x0 + cw]
            labels, counts = np.unique(patch, return_counts=True)
            counts = counts[labels != self.ignored_category]
            if len(counts) > 1 and counts.max() < counts.sum() * self.single_category_max_area:
                return CropTransform(x0, y0, cw, ch)
        return CropTransform(x0, y0, cw, ch)


# reference name for the same class (augmentation.py:884)
RandomCrop_CategoryAreaConstraint = RandomCropWithInstance


class RandomContrast(Augmentation):
    """(reference :986)"""

    def __init__(self, intensity_min: float, intensity_max: float):
        self.intensity_min = intensity_min
        self.intensity_max = intensity_max

    def get_transform(self, image):
        w = _rand(self.intensity_min, self.intensity_max)
        return BlendTransform(image.mean(), 1 - w, w)


class RandomBrightness(Augmentation):
    def __init__(self, intensity_min: float, intensity_max: float):
        self.intensity_min = intensity_min
        self.intensity_max = intensity_max

    def get_transform(self, image):
        w = _rand(self.intensity_min, self.intensity_max)
        return BlendTransform(0.0, 1 - w, w)


class RandomSaturation(Augmentation):
    def __init__(self, intensity_min: float, intensity_max: float):
        self.intensity_min = intensity_min
        self.intensity_max = intensity_max

    def get_transform(self, image):
        w = _rand(self.intensity_min, self.intensity_max)
        grayscale = image.astype(np.float64) @ np.array([0.299, 0.587, 0.114])
        return BlendTransform(grayscale[:, :, None], 1 - w, w)


class ColorAugSSD(Augmentation):
    """SSD-style photometric distortion (reference: transform.py:362)."""

    def __init__(self, brightness_delta: int = 32, contrast_low: float = 0.5, contrast_high: float = 1.5,
                 saturation_low: float = 0.5, saturation_high: float = 1.5, hue_delta: int = 18):
        self.bd = brightness_delta
        self.cl, self.ch = contrast_low, contrast_high
        self.sl, self.sh = saturation_low, saturation_high
        self.hd = hue_delta

    def get_transform(self, image):
        return NoOpTransform()  # applied in __call__ directly for efficiency

    def __call__(self, aug_input):
        """Photometric distortion via 256-entry LUTs.

        Every step is a per-value map on uint8 (the float intermediates in
        the textbook formulation are always re-quantized before the next
        cvtColor), so the whole chain collapses to at most three cv2.LUT
        passes + two uint8 cvtColors in place of full-image float32 passes.
        Bit-exact with the float formulation (``_apply_float``): LUT entries
        are computed with the identical float32 op sequence.
        """
        import cv2

        img = aug_input.image
        if img.dtype != np.uint8:
            aug_input.image = self._apply_float(img)
            return NoOpTransform()

        ramp = np.arange(256, dtype=np.float32)

        # brightness/contrast compose into one pre-HSV value map
        pre = ramp.copy()
        pre_used = False
        if np.random.rand() < 0.5:
            pre += np.random.uniform(-self.bd, self.bd)
            pre_used = True
        mode = np.random.rand() < 0.5
        if mode and np.random.rand() < 0.5:
            pre *= np.random.uniform(self.cl, self.ch)
            pre_used = True
        if pre_used:
            img = cv2.LUT(img, np.clip(pre, 0, 255).astype(np.uint8))

        hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
        slut = hlut = None
        if np.random.rand() < 0.5:
            slut = np.clip(ramp * np.random.uniform(self.sl, self.sh), 0, 255).astype(np.uint8)
        if np.random.rand() < 0.5:
            # cvtColor emits H in [0, 179]; entries >=180 are unreachable
            hlut = np.clip((ramp + np.random.uniform(-self.hd, self.hd)) % 180, 0, 255).astype(np.uint8)
        if slut is not None or hlut is not None:
            ident = ramp.astype(np.uint8)
            lut3 = np.stack([hlut if hlut is not None else ident,
                             slut if slut is not None else ident, ident], axis=-1).reshape(256, 1, 3)
            hsv = cv2.LUT(hsv, lut3)
        img = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)

        if not mode and np.random.rand() < 0.5:
            post = np.clip(ramp * np.random.uniform(self.cl, self.ch), 0, 255).astype(np.uint8)
            img = cv2.LUT(img, post)
        aug_input.image = img
        return NoOpTransform()

    def _apply_float(self, image: np.ndarray) -> np.ndarray:
        """Reference float32 formulation — fallback for non-uint8 inputs and
        the equality oracle for the LUT path (reference: transform.py:362)."""
        import cv2

        img = image.astype(np.float32)
        if np.random.rand() < 0.5:
            img += np.random.uniform(-self.bd, self.bd)
        mode = np.random.rand() < 0.5
        if mode and np.random.rand() < 0.5:
            img *= np.random.uniform(self.cl, self.ch)
        hsv = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8), cv2.COLOR_RGB2HSV).astype(np.float32)
        if np.random.rand() < 0.5:
            hsv[:, :, 1] *= np.random.uniform(self.sl, self.sh)
        if np.random.rand() < 0.5:
            hsv[:, :, 0] = (hsv[:, :, 0] + np.random.uniform(-self.hd, self.hd)) % 180
        img = cv2.cvtColor(np.clip(hsv, 0, 255).astype(np.uint8), cv2.COLOR_HSV2RGB).astype(np.float32)
        if not mode and np.random.rand() < 0.5:
            img *= np.random.uniform(self.cl, self.ch)
        return np.clip(img, 0, 255).astype(np.uint8)


class RandomZoomOut(Augmentation):
    """Place the image on a larger canvas (reference :1261)."""

    def __init__(self, side_range: Tuple[float, float] = (1.0, 4.0), fill: float = 0.0, prob: float = 0.5):
        self.side_range = side_range
        self.fill = fill
        self.prob = prob

    def get_transform(self, image):
        if np.random.rand() >= self.prob:
            return NoOpTransform()
        h, w = image.shape[:2]
        ratio = _rand(*self.side_range)
        new_h, new_w = int(h * ratio), int(w * ratio)
        y0 = np.random.randint(0, new_h - h + 1)
        x0 = np.random.randint(0, new_w - w + 1)
        return PadTransform(x0, y0, new_w - w - x0, new_h - h - y0, self.fill)


class MinIoURandomCrop(Augmentation):
    """Crop keeping min IoU with boxes (reference :1175)."""

    def __init__(self, min_ious=(0.1, 0.3, 0.5, 0.7, 0.9), min_crop_size: float = 0.3, prob: float = 0.5):
        self.min_ious = min_ious
        self.min_crop_size = min_crop_size
        self.prob = prob

    def __call__(self, aug_input):
        if np.random.rand() >= self.prob or aug_input.boxes is None or len(aug_input.boxes) == 0:
            return NoOpTransform()
        img = aug_input.image
        h, w = img.shape[:2]
        boxes = aug_input.boxes
        for _ in range(50):
            mode = random.choice((1, *self.min_ious))
            min_iou = mode
            cw = int(_rand(self.min_crop_size * w, w))
            ch = int(_rand(self.min_crop_size * h, h))
            if cw / ch < 0.5 or cw / ch > 2:
                continue
            x0 = int(_rand(0, w - cw))
            y0 = int(_rand(0, h - ch))
            patch = np.array([x0, y0, x0 + cw, y0 + ch], np.float64)
            lt = np.maximum(boxes[:, :2], patch[:2])
            rb = np.minimum(boxes[:, 2:], patch[2:])
            wh = (rb - lt).clip(min=0)
            inter = wh[:, 0] * wh[:, 1]
            a1 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            iou = inter / np.maximum(a1, 1e-9)
            if iou.min() < min_iou:
                continue
            centers = (boxes[:, :2] + boxes[:, 2:]) / 2
            keep = (
                (centers[:, 0] > patch[0]) & (centers[:, 1] > patch[1])
                & (centers[:, 0] < patch[2]) & (centers[:, 1] < patch[3])
            )
            if not keep.any():
                continue
            tfm = CropTransform(x0, y0, cw, ch)
            aug_input.transform(tfm)
            return tfm
        return NoOpTransform()

    def get_transform(self, image):
        return NoOpTransform()


class RandomResize(Augmentation):
    """Pick a size from a list (reference :1118)."""

    def __init__(self, shape_list: List[Tuple[int, int]]):
        self.shape_list = shape_list

    def get_transform(self, image):
        h, w = image.shape[:2]
        nh, nw = self.shape_list[np.random.randint(len(self.shape_list))]
        return ResizeTransform(h, w, nh, nw)


class RandomAspectRatio(Augmentation):
    """Jitter the aspect ratio (reference :1139)."""

    def __init__(self, ratio_range: Tuple[float, float] = (0.75, 1.333), prob: float = 0.5):
        self.ratio_range = ratio_range
        self.prob = prob

    def get_transform(self, image):
        if np.random.rand() >= self.prob:
            return NoOpTransform()
        h, w = image.shape[:2]
        r = _rand(*self.ratio_range)
        return ResizeTransform(h, w, h, int(w * r + 0.5))


class RandomExtent(Augmentation):
    """Random scaled/shifted subrect crop with zero padding outside the source
    (reference :934-983): the rect starts centered at the image, is scaled by
    Uniform(scale_range) and shifted by shift_range * size * Uniform(-.5, .5).
    """

    def __init__(self, scale_range: Tuple[float, float], shift_range: Tuple[float, float]):
        self.scale_range = scale_range
        self.shift_range = shift_range

    def get_transform(self, image):
        h, w = image.shape[:2]
        rect = np.array([-0.5 * w, -0.5 * h, 0.5 * w, 0.5 * h])
        rect *= _rand(*self.scale_range)
        rect[0::2] += self.shift_range[0] * w * (np.random.rand() - 0.5)
        rect[1::2] += self.shift_range[1] * h * (np.random.rand() - 0.5)
        rect[0::2] += 0.5 * w
        rect[1::2] += 0.5 * h
        return ExtentTransform(rect, (int(rect[3] - rect[1]), int(rect[2] - rect[0])))


class RandomLighting(Augmentation):
    """AlexNet PCA lighting jitter over ImageNet statistics, RGB order
    (reference :1079-1115): adds eigvecs @ (N(0, scale) * eigvals)."""

    _EIG_VECS = np.array(
        [[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140], [-0.5836, -0.6948, 0.4203]]
    )
    _EIG_VALS = np.array([0.2175, 0.0188, 0.0045])

    def __init__(self, scale: float):
        self.scale = scale

    def get_transform(self, image):
        assert image.shape[-1] == 3, "RandomLighting needs RGB"
        weights = np.random.normal(scale=self.scale, size=3)
        return BlendTransform(src_image=self._EIG_VECS.dot(weights * self._EIG_VALS),
                              src_weight=1.0, dst_weight=1.0)
