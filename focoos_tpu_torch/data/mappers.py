"""Dataset mappers: record dict → DatasetEntry (copy of
``focoos_tpu/data/mappers.py``; reference: focoos/data/mappers/).

A mapper reads the image, runs the augmentation pipeline, converts the
annotations into numpy ``Instances`` and drops empty training records
(returning None makes MapDataset retry another record): detection,
instance segmentation (COCO polygons or RLE into ``BitMasks``), keypoints,
semantic segmentation and classification.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from focoos_tpu_torch.data.transforms import AugInput, Augmentation, AugmentationList, TransformList
from focoos_tpu_torch.ports import DatasetEntry, Task
from focoos_tpu_torch.structures import BitMasks, Boxes, BoxMode, Instances, Keypoints, polygons_to_bitmask


def _read_image(path: str) -> np.ndarray:
    """RGB uint8 with EXIF orientation applied (reference: data/utils.py:310
    _apply_exif_orientation: phone photos are often stored rotated).

    cv2.imread applies EXIF orientation itself and decodes faster than PIL;
    PIL reads the formats cv2 cannot. A file neither can read raises."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is not None:
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    from PIL import Image, ImageOps

    with Image.open(path) as im:
        im = ImageOps.exif_transpose(im)
        return np.asarray(im.convert("RGB"))


def _mark_outside(kpts: np.ndarray, coords: np.ndarray, image_size) -> np.ndarray:
    """[N, K, 3] keypoints at ``coords`` [N, K, 2], those outside the image marked invisible."""
    vis = kpts[..., 2].copy()
    h, w = image_size
    oob = (coords[..., 0] < 0) | (coords[..., 0] >= w) | (coords[..., 1] < 0) | (coords[..., 1] >= h)
    vis[oob] = 0
    return np.concatenate([coords, vis[..., None]], axis=-1).astype(np.float32)


def _transform_keypoints(kpts: np.ndarray, tfm: TransformList, image_size) -> np.ndarray:
    """[N, K, 3] → transformed, with out-of-image points marked invisible."""
    if len(kpts) == 0:
        return kpts
    n, k, _ = kpts.shape
    return _mark_outside(kpts, tfm.apply_coords(kpts[..., :2].reshape(-1, 2)).reshape(n, k, 2), image_size)


class DatasetMapper:
    """(reference: mappers/mapper.py:10)"""

    def __init__(self, augmentations: List[Augmentation], is_train: bool = True, image_format: str = "RGB"):
        self.augmentations = AugmentationList(augmentations)
        self.is_train = is_train

    def __call__(self, record: dict) -> Optional[DatasetEntry]:
        raise NotImplementedError


class DetectionDatasetMapper(DatasetMapper):
    """(reference: mappers/detection_dataset_mapper.py:19)"""

    use_masks = False
    use_keypoints = False

    def __call__(self, record: dict) -> Optional[DatasetEntry]:
        image = _read_image(record["file_name"])
        h0, w0 = image.shape[:2]

        # training drops crowd regions (reference detection_dataset_mapper.py
        # filters iscrowd); eval keeps them, marked, so the COCO evaluator can
        # apply the crowd-ignore convention (dts overlapping a crowd are
        # neither TP nor FP) instead of counting them as plain FPs
        anns = record.get("annotations", [])
        if self.is_train:
            anns = [a for a in anns if not a.get("iscrowd", 0)]
        boxes = np.array(
            [BoxMode.convert(np.asarray(a["bbox"], np.float64), BoxMode.XYWH_ABS, BoxMode.XYXY_ABS) for a in anns],
            np.float32,
        ).reshape(-1, 4)
        masks = self._masks(anns, h0, w0)
        kpts = np.array(
            [np.asarray(a.get("keypoints", [0] * 51), np.float32).reshape(-1, 3) for a in anns], np.float32
        ).reshape(len(anns), -1, 3) if self.use_keypoints else None
        aug_input = AugInput(image, boxes=boxes.copy())
        tfm = self.augmentations(aug_input)
        image = aug_input.image
        hw = image.shape[:2]
        inst = self._instances(
            anns, aug_input.boxes, hw,
            None if masks is None else [tfm.apply_segmentation(m.astype(np.uint8)).astype(bool) for m in masks],
            None if kpts is None else _transform_keypoints(kpts, tfm, hw),
        )
        if self.is_train and len(inst) == 0:
            return None  # retry another record (reference :150 filter empties)
        # an eval record whose image was resized keeps its ground truth at its own size too: the
        # evaluators score it in the frame eval_postprocess scales the predictions to (the JAX package
        # scores the mapped ground truth against predictions at the record's size, ROADMAP Queue 3)
        original = None
        if not self.is_train and hw != (h0, w0):
            original = self._instances(
                anns, boxes, (h0, w0), masks,
                None if kpts is None or len(kpts) == 0 else _mark_outside(kpts, kpts[..., :2], (h0, w0)),
            )
        return DatasetEntry(
            image=image,
            height=record.get("height", h0),
            width=record.get("width", w0),
            instances=inst,
            file_name=record["file_name"],
            image_id=record.get("image_id"),
            original_instances=original,
        )

    def _masks(self, anns: list, h0: int, w0: int) -> Optional[list]:
        """Each annotation's mask at the record's size, or None where the mapper keeps no masks."""
        if not (self.use_masks and anns and anns[0].get("segmentation") is not None):
            return None
        masks = []
        for a in anns:
            seg = a.get("segmentation")
            if isinstance(seg, list):
                m = polygons_to_bitmask([np.asarray(p) for p in seg], h0, w0)
            elif isinstance(seg, dict):
                # COCO crowd regions ship as RLE (a compressed string or a counts list)
                from focoos_tpu_torch.utils.native import coco_rle_decode

                m = coco_rle_decode(seg, h0, w0)
            else:
                m = np.asarray(seg, bool)
            masks.append(m)
        return masks

    @staticmethod
    def _instances(anns: list, boxes: np.ndarray, hw, masks: Optional[list], kpts: Optional[np.ndarray]) -> Instances:
        """The annotations' Instances in an image of size ``hw``: boxes clipped, the empty ones dropped."""
        classes = np.array([a["category_id"] for a in anns], np.int64)
        inst = Instances(hw)
        b = Boxes(boxes)
        b.clip(hw)
        inst.boxes = b
        inst.classes = classes
        inst.iscrowd = np.array([a.get("iscrowd", 0) for a in anns], np.int64)
        if masks is not None:
            inst.masks = BitMasks(np.stack(masks) if masks else np.zeros((0, *hw), bool))
        if kpts is not None:
            inst.keypoints = Keypoints(kpts)
        return inst[b.nonempty()]


class InstanceDatasetMapper(DetectionDatasetMapper):
    """(reference: detection_dataset_mapper.py:187)"""

    use_masks = True


class KeypointDatasetMapper(DetectionDatasetMapper):
    """(reference: mappers/keypoint.py:21)"""

    use_keypoints = True


class SemanticDatasetMapper(DatasetMapper):
    """(reference: mappers/semantic_dataset_mapper.py:27)"""

    def __init__(self, augmentations, is_train: bool = True, ignore_label: int = 255):
        super().__init__(augmentations, is_train)
        self.ignore_label = ignore_label

    def __call__(self, record: dict) -> Optional[DatasetEntry]:
        from PIL import Image

        image = _read_image(record["file_name"])
        h0, w0 = image.shape[:2]
        with Image.open(record["sem_seg_file_name"]) as m:
            sem_seg = np.asarray(m)
        if sem_seg.ndim == 3:
            sem_seg = sem_seg[..., 0]
        sem_seg = sem_seg.astype(np.uint8)

        aug_input = AugInput(image, sem_seg=sem_seg)
        self.augmentations(aug_input)
        image, sem_seg = aug_input.image, aug_input.sem_seg

        # MaskFormer-style targets: one instance per class present
        classes = np.unique(sem_seg)
        classes = classes[classes != self.ignore_label]
        masks = np.stack([sem_seg == c for c in classes]) if len(classes) else np.zeros((0, *sem_seg.shape), bool)
        inst = Instances(image.shape[:2])
        inst.classes = classes.astype(np.int64)
        inst.masks = BitMasks(masks)
        inst.boxes = inst.masks.get_bounding_boxes() if len(classes) else Boxes(np.zeros((0, 4)))
        if self.is_train and len(classes) == 0:
            return None
        return DatasetEntry(
            image=image,
            height=record.get("height", h0),
            width=record.get("width", w0),
            instances=inst,
            sem_seg=sem_seg,
            file_name=record["file_name"],
            image_id=record.get("image_id"),
        )


class ClassificationDatasetMapper(DatasetMapper):
    """(reference: mappers/classification_dataset_mapper.py:26) A
    folder-per-class record carries its ``label`` (an int); a COCO record
    carries none, and its multi-label is its annotations' ``category_id``s
    (already contiguous; reference :79-83, as coco_2017_cls uses)."""

    def __call__(self, record: dict) -> Optional[DatasetEntry]:
        if record.get("label") is None and record.get("annotations"):
            record = dict(record, label=[a.get("category_id") for a in record["annotations"]])
        image = _read_image(record["file_name"])
        h0, w0 = image.shape[:2]
        aug_input = AugInput(image)
        self.augmentations(aug_input)
        return DatasetEntry(
            image=aug_input.image,
            height=h0,
            width=w0,
            label=record.get("label"),
            file_name=record["file_name"],
            image_id=record.get("image_id"),
        )


def get_mapper_by_task(task: Task, augmentations: List[Augmentation], is_train: bool = True) -> DatasetMapper:
    if task == Task.DETECTION:
        return DetectionDatasetMapper(augmentations, is_train)
    if task == Task.INSTANCE_SEGMENTATION:
        return InstanceDatasetMapper(augmentations, is_train)
    if task == Task.KEYPOINT:
        return KeypointDatasetMapper(augmentations, is_train)
    if task == Task.SEMSEG:
        return SemanticDatasetMapper(augmentations, is_train)
    if task == Task.CLASSIFICATION:
        return ClassificationDatasetMapper(augmentations, is_train)
    raise ValueError(f"No mapper for task {task}")
