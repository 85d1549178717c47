"""Built-in dataset catalog (copy of ``focoos_tpu/data/catalog.py``;
reference: focoos/data/catalog/catalog.py:17-209).

Registers well-known datasets (COCO det/instseg/keypoints, ADE20K, VOC) by
their standard on-disk layouts under ``DATASETS_DIR``. Entries resolve
lazily: a catalog name only needs its files present when it is loaded, and
nothing is downloaded.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Dict

from focoos_tpu_torch import ports
from focoos_tpu_torch.data.datasets import DictDataset
from focoos_tpu_torch.ports import DatasetMetadata, DatasetSplitType, Task


@dataclass
class CatalogSplit:
    loader: Callable[[], DictDataset]


@dataclass
class CatalogDataset:
    name: str
    task: Task
    splits: Dict[DatasetSplitType, CatalogSplit]


_CATALOG: Dict[str, CatalogDataset] = {}

# reference-spelled names accepted as aliases (reference catalog.py:62,114)
_ALIASES = {
    "coco_2017_instance": "coco_2017_ins",
    "coco_2017_person_keypoints": "coco_2017_kpts",
}


def register_catalog_dataset(name: str, task: Task, splits: Dict[DatasetSplitType, CatalogSplit]) -> None:
    _CATALOG[name] = CatalogDataset(name, task, splits)


def list_catalog() -> list:
    return sorted(_CATALOG)


def load_catalog_split(name: str, split: DatasetSplitType) -> DictDataset:
    name = _ALIASES.get(name, name)
    if name not in _CATALOG:
        raise KeyError(f"'{name}' not in catalog; available: {list_catalog()}")
    ds = _CATALOG[name]
    if split not in ds.splits:
        raise KeyError(f"{name} has no split {split}")
    return ds.splits[split].loader()


def _coco_split(json_rel: str, img_rel: str, task: Task, root_rel: str = "coco") -> Callable[[], DictDataset]:
    def load() -> DictDataset:
        root = os.path.join(ports.DATASETS_DIR, root_rel)
        with open(os.path.join(root, json_rel)) as f:
            coco = json.load(f)
        cats = sorted(coco["categories"], key=lambda c: c["id"])
        id_map = {c["id"]: i for i, c in enumerate(cats)}
        anns_by_img: Dict[int, list] = {}
        for a in coco.get("annotations", []):
            anns_by_img.setdefault(a["image_id"], []).append(a)
        records = []
        for img in coco["images"]:
            annotations = []
            for a in anns_by_img.get(img["id"], []):
                ann = dict(bbox=a["bbox"], category_id=id_map[a["category_id"]], iscrowd=a.get("iscrowd", 0))
                if task == Task.INSTANCE_SEGMENTATION and a.get("segmentation"):
                    ann["segmentation"] = a["segmentation"]
                if task == Task.KEYPOINT and a.get("keypoints"):
                    ann["keypoints"] = a["keypoints"]
                annotations.append(ann)
            records.append(
                dict(file_name=os.path.join(root, img_rel, img["file_name"]), image_id=img["id"],
                     height=img["height"], width=img["width"], annotations=annotations)
            )
        meta = DatasetMetadata(
            num_classes=len(cats), task=task, count=len(records), name=root_rel,
            thing_classes=[c["name"] for c in cats],
        )
        return DictDataset(records, meta)

    return load


def _semseg_split(root_rel: str, img_rel: str, gt_rel: str, json_rel: str, name: str) -> Callable[[], DictDataset]:
    """Semantic-seg split: a JSON listing image↔gt-png pairs plus class names
    (reference: catalog/utils.py:16 load_sem_seg — images dict + annotations
    with per-image ``file_name`` ground-truth pngs)."""

    def load() -> DictDataset:
        root = os.path.join(ports.DATASETS_DIR, root_rel)
        with open(os.path.join(root, json_rel)) as f:
            info = json.load(f)
        images = {im["id"]: im["file_name"] for im in info["images"]}
        records = []
        for ann in info["annotations"]:
            records.append(
                dict(
                    file_name=os.path.join(root, img_rel, images[ann["image_id"]]),
                    sem_seg_file_name=os.path.join(root, gt_rel, ann["file_name"]),
                    image_id=ann["image_id"],
                )
            )
        classes = [c["name"] for c in sorted(info.get("categories", []), key=lambda c: c["id"])]
        meta = DatasetMetadata(
            num_classes=len(classes) or 150, task=Task.SEMSEG, count=len(records),
            name=name, stuff_classes=classes or None,
        )
        return DictDataset(records, meta)

    return load


# standard entries (resolved lazily)
register_catalog_dataset(
    "coco_2017_det",
    Task.DETECTION,
    {
        DatasetSplitType.TRAIN: CatalogSplit(_coco_split("annotations/instances_train2017.json", "train2017", Task.DETECTION)),
        DatasetSplitType.VAL: CatalogSplit(_coco_split("annotations/instances_val2017.json", "val2017", Task.DETECTION)),
    },
)
register_catalog_dataset(
    "coco_2017_ins",
    Task.INSTANCE_SEGMENTATION,
    {
        DatasetSplitType.TRAIN: CatalogSplit(
            _coco_split("annotations/instances_train2017.json", "train2017", Task.INSTANCE_SEGMENTATION)
        ),
        DatasetSplitType.VAL: CatalogSplit(
            _coco_split("annotations/instances_val2017.json", "val2017", Task.INSTANCE_SEGMENTATION)
        ),
    },
)
register_catalog_dataset(
    "coco_2017_kpts",
    Task.KEYPOINT,
    {
        DatasetSplitType.TRAIN: CatalogSplit(
            _coco_split("annotations/person_keypoints_train2017.json", "train2017", Task.KEYPOINT)
        ),
        DatasetSplitType.VAL: CatalogSplit(
            _coco_split("annotations/person_keypoints_val2017.json", "val2017", Task.KEYPOINT)
        ),
    },
)
register_catalog_dataset(
    "coco_2017_cls",
    Task.CLASSIFICATION,
    # same COCO jsons; the classification mapper derives the (multi-)label
    # from the annotations' category_ids (reference:
    # classification_dataset_mapper.py:79-83 + catalog.py coco_2017_cls)
    {
        DatasetSplitType.TRAIN: CatalogSplit(
            _coco_split("annotations/instances_train2017.json", "train2017", Task.CLASSIFICATION)
        ),
        DatasetSplitType.VAL: CatalogSplit(
            _coco_split("annotations/instances_val2017.json", "val2017", Task.CLASSIFICATION)
        ),
    },
)
register_catalog_dataset(
    "ade20k_semseg",
    Task.SEMSEG,
    # reference: catalog.py:34-46 (detectron2-style ADE layout)
    {
        DatasetSplitType.TRAIN: CatalogSplit(_semseg_split(
            "ADEChallengeData2016", "images/training", "annotations_detectron2/training",
            "ade20k_semseg_train.json", "ade20k_semseg")),
        DatasetSplitType.VAL: CatalogSplit(_semseg_split(
            "ADEChallengeData2016", "images/validation", "annotations_detectron2/validation",
            "ade20k_semseg_val.json", "ade20k_semseg")),
    },
)
register_catalog_dataset(
    "voc_semseg",
    Task.SEMSEG,
    # reference: catalog.py:49-62 (PascalVOC12 flat layout)
    {
        DatasetSplitType.TRAIN: CatalogSplit(_semseg_split(
            "PascalVOC12", "", "", "train.json", "voc_semseg")),
        DatasetSplitType.VAL: CatalogSplit(_semseg_split(
            "PascalVOC12", "", "", "val.json", "voc_semseg")),
    },
)
register_catalog_dataset(
    "object365",
    Task.DETECTION,
    # reference: catalog.py:127-139 (roboflow-style COCO jsons per split)
    {
        DatasetSplitType.TRAIN: CatalogSplit(_coco_split(
            "train/_annotations.coco.json", "train", Task.DETECTION, root_rel="object365")),
        DatasetSplitType.VAL: CatalogSplit(_coco_split(
            "val/_annotations.coco.json", "val", Task.DETECTION, root_rel="object365")),
    },
)
register_catalog_dataset(
    "ade20k_instance",
    Task.INSTANCE_SEGMENTATION,
    # reference: catalog.py:64-75 (COCO-style instance jsons over ADE images)
    {
        DatasetSplitType.TRAIN: CatalogSplit(_coco_split(
            "ade20k_instance_train.json", "images/training",
            Task.INSTANCE_SEGMENTATION, root_rel="ADEChallengeData2016")),
        DatasetSplitType.VAL: CatalogSplit(_coco_split(
            "ade20k_instance_val.json", "images/validation",
            Task.INSTANCE_SEGMENTATION, root_rel="ADEChallengeData2016")),
    },
)
