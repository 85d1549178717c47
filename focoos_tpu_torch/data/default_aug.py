"""DatasetAugmentations config → transform pipeline (copy of
``focoos_tpu/data/default_aug.py``; reference: focoos/data/default_aug.py).

Same field surface and preset tables as the reference, so TrainerArgs and
CLI flags carry over unchanged; emits ``focoos_tpu_torch.data.transforms``
Augmentations.
"""

from __future__ import annotations

import copy
import sys
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

from focoos_tpu_torch.data import transforms as T
from focoos_tpu_torch.ports import Task


@dataclass
class DatasetAugmentations:
    resolution: Union[int, Tuple[int, int]] = 640

    color_augmentation: float = 0.0
    color_base_brightness: int = 32
    color_base_saturation: float = 0.5
    color_base_contrast: float = 0.5
    color_base_hue: float = 18

    horizontal_flip: float = 0.0
    vertical_flip: float = 0.0
    zoom_out: float = 0.0
    zoom_out_side: float = 4.0
    rotation: float = 0.0
    aspect_ratio: float = 0.0

    square: float = 0.0
    scale_ratio: float = 0.0
    max_size: int = 4096

    crop: bool = False
    crop_size: Optional[int] = None

    def override(self, args) -> "DatasetAugmentations":
        if not isinstance(args, dict):
            args = vars(args)
        for key, value in args.items():
            if hasattr(self, key) and value is not None:
                setattr(self, key, value)
        return self

    def get_augmentations(self, img_format: str = "RGB", task: Optional[Task] = None) -> List[T.Augmentation]:
        """(reference: default_aug.py:104-190)"""
        augs: List[T.Augmentation] = []
        max_size = self.max_size or sys.maxsize

        if isinstance(self.resolution, int):
            resolution_tuple = (self.resolution, self.resolution)
            resolution_value = self.resolution
        else:
            resolution_tuple = tuple(self.resolution)
            resolution_value = min(self.resolution)

        if self.color_augmentation > 0:
            augs.append(
                T.ColorAugSSD(
                    brightness_delta=int(self.color_base_brightness * self.color_augmentation),
                    contrast_low=1 - self.color_base_contrast * self.color_augmentation,
                    contrast_high=1 + self.color_base_contrast * self.color_augmentation,
                    saturation_low=1 - self.color_base_saturation * self.color_augmentation,
                    saturation_high=1 + self.color_base_saturation * self.color_augmentation,
                    hue_delta=int(self.color_base_hue * self.color_augmentation),
                )
            )
        if self.horizontal_flip > 0:
            augs.append(T.RandomFlip(prob=self.horizontal_flip, horizontal=True))
        if self.vertical_flip > 0:
            augs.append(T.RandomFlip(prob=self.vertical_flip, horizontal=False, vertical=True))
        if self.zoom_out > 0:
            augs.append(T.RandomZoomOut(side_range=(1.0, self.zoom_out_side), fill=0.0, prob=self.zoom_out))
        if self.square > 0:
            augs.append(T.RandomApply(T.Resize(shape=resolution_tuple), prob=self.square))
        elif self.aspect_ratio > 0:
            ratio = 2**self.aspect_ratio
            augs.append(T.RandomAspectRatio(ratio_range=(1.0 / ratio, ratio)))

        is_non_square = isinstance(self.resolution, (tuple, list)) and self.resolution[0] != self.resolution[1]
        if is_non_square:
            augs.append(T.Resize(shape=resolution_tuple))
        else:
            min_scale, max_scale = 2 ** (-self.scale_ratio), 2**self.scale_ratio
            augs.append(
                T.ResizeShortestEdge(
                    short_edge_length=(int(min_scale * resolution_value), int(max_scale * resolution_value)),
                    sample_style="range",
                    max_size=max_size,
                )
            )
        if self.rotation > 0:
            augs.append(T.RandomRotation(angle=self.rotation * 180, expand=False))
        if self.crop:
            size = (self.crop_size, self.crop_size) if self.crop_size else resolution_tuple
            augs.append(T.RandomCrop(crop_type="absolute", crop_size=size))
        return augs


# preset tables (reference: default_aug.py:192-274)
fai_instance_train_augs = DatasetAugmentations(
    resolution=1024, crop=True, scale_ratio=1.0, max_size=2048, horizontal_flip=0.5, color_augmentation=1.0
)
fai_segmentation_train_augs = DatasetAugmentations(
    resolution=640, crop=True, scale_ratio=1.0, max_size=2048, color_augmentation=1.0, horizontal_flip=0.5
)
fai_detection_train_augs = DatasetAugmentations(
    resolution=640, color_augmentation=1.0, horizontal_flip=0.5, aspect_ratio=0.5,
    zoom_out=0.5, zoom_out_side=4.0, square=1.0, scale_ratio=0.5,
)
detection_train_augs = DatasetAugmentations(
    resolution=640, square=1.0, max_size=int(640 * 1.25), crop=True,
    scale_ratio=0.5, color_augmentation=1.0, horizontal_flip=0.5,
)
segmentation_train_augs = DatasetAugmentations(
    resolution=640, crop=True, scale_ratio=0.5, color_augmentation=1.0, horizontal_flip=0.5
)
detection_val_augs = DatasetAugmentations(resolution=640, square=1.0)
segmentation_val_augs = DatasetAugmentations(resolution=640)
classification_train_augs = DatasetAugmentations(
    resolution=224, scale_ratio=0.5, crop=True, color_augmentation=1.0, horizontal_flip=0.5
)
classification_val_augs = DatasetAugmentations(resolution=224)
keypoints_train_augs = DatasetAugmentations(resolution=640, crop=True, scale_ratio=0.5, color_augmentation=1.0)
keypoints_val_augs = DatasetAugmentations(resolution=640)


def get_default_by_task(
    task: Task, resolution: Union[int, Tuple[int, int]] = 640, advanced: bool = False
) -> Tuple[DatasetAugmentations, DatasetAugmentations]:
    """(reference: default_aug.py:275-306)"""
    if task == Task.DETECTION:
        train, val = (fai_detection_train_augs if advanced else detection_train_augs), detection_val_augs
    elif task == Task.SEMSEG:
        train, val = (fai_segmentation_train_augs if advanced else segmentation_train_augs), segmentation_val_augs
    elif task == Task.INSTANCE_SEGMENTATION:
        train, val = (fai_instance_train_augs if advanced else segmentation_train_augs), segmentation_val_augs
    elif task == Task.CLASSIFICATION:
        train, val = classification_train_augs, classification_val_augs
    elif task == Task.KEYPOINT:
        train, val = keypoints_train_augs, keypoints_val_augs
    else:
        raise ValueError(f"Unknown task {task}")
    train, val = copy.deepcopy(train), copy.deepcopy(val)
    train.resolution = resolution
    val.resolution = resolution
    return train, val
