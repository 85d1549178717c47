"""Dataset containers and parsers (copy of ``focoos_tpu/data/datasets.py``;
reference: focoos/data/datasets/).

``DictDataset`` holds a list of record dicts and a ``DatasetMetadata``
(COCO-style: file_name, height, width, annotations[{bbox (XYWH),
category_id, segmentation, keypoints, iscrowd}], sem_seg_file_name, label). Parsers:
Roboflow-COCO (detection, instance segmentation, keypoints), Roboflow
semantic segmentation (PNG masks) and classification folders. ``MapDataset`` applies a mapper,
retrying other records where the mapper returns None. Records are plain
dicts, so the loader's worker processes share them as they are.
"""

from __future__ import annotations

import json
import os
import pickle
import random
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from focoos_tpu_torch.ports import DatasetMetadata, Task


class DictDataset:
    """(reference: datasets/dict_dataset.py:33)"""

    def __init__(self, records: List[Dict[str, Any]], metadata: DatasetMetadata):
        self.records = records
        self.metadata = metadata

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        return self.records[i]

    def split(self, fraction: float, seed: int = 0):
        idx = list(range(len(self.records)))
        random.Random(seed).shuffle(idx)
        k = int(len(idx) * fraction)
        a = [self.records[i] for i in idx[:k]]
        b = [self.records[i] for i in idx[k:]]
        return DictDataset(a, self.metadata), DictDataset(b, self.metadata)

    @classmethod
    def from_roboflow_coco(cls, split_dir: str, task: Task = Task.DETECTION) -> "DictDataset":
        """Parse a Roboflow-COCO split dir containing _annotations.coco.json
        (reference: dict_dataset.py:231)."""
        ann_path = os.path.join(split_dir, "_annotations.coco.json")
        if not os.path.isfile(ann_path):
            candidates = [f for f in os.listdir(split_dir) if f.endswith(".json")]
            if not candidates:
                raise FileNotFoundError(f"no COCO json in {split_dir}")
            ann_path = os.path.join(split_dir, candidates[0])
        with open(ann_path) as f:
            coco = json.load(f)

        cats = sorted(coco["categories"], key=lambda c: c["id"])
        # roboflow convention: a super-category occupies id 0 → drop it
        if len(cats) > 1 and cats[0].get("supercategory", "") == "none":
            cats_used = cats[1:] if all(c.get("supercategory") == cats[0]["name"] for c in cats[1:]) else cats
        else:
            cats_used = cats
        id_map = {c["id"]: i for i, c in enumerate(cats_used)}
        class_names = [c["name"] for c in cats_used]
        kpt_names = cats_used[0].get("keypoints") if cats_used else None
        skeleton = cats_used[0].get("skeleton") if cats_used else None

        anns_by_img: Dict[int, list] = {}
        for a in coco.get("annotations", []):
            anns_by_img.setdefault(a["image_id"], []).append(a)

        records = []
        for img in coco["images"]:
            annotations = []
            for a in anns_by_img.get(img["id"], []):
                if a["category_id"] not in id_map:
                    continue
                ann = {
                    "bbox": a["bbox"],  # XYWH
                    "category_id": id_map[a["category_id"]],
                    "iscrowd": a.get("iscrowd", 0),
                    "area": a.get("area"),
                }
                if task == Task.INSTANCE_SEGMENTATION and a.get("segmentation"):
                    ann["segmentation"] = a["segmentation"]
                if task == Task.KEYPOINT and a.get("keypoints"):
                    ann["keypoints"] = a["keypoints"]
                annotations.append(ann)
            records.append(
                dict(
                    file_name=os.path.join(split_dir, img["file_name"]),
                    image_id=img["id"],
                    height=img["height"],
                    width=img["width"],
                    annotations=annotations,
                )
            )
        meta = DatasetMetadata(
            num_classes=len(class_names),
            task=task,
            count=len(records),
            name=os.path.basename(os.path.dirname(split_dir)),
            image_root=split_dir,
            thing_classes=class_names,
            json_file=ann_path,
            keypoints=kpt_names,
            keypoints_skeleton=skeleton,
        )
        return cls(records, meta)

    @classmethod
    def from_roboflow_seg(cls, split_dir: str) -> "DictDataset":
        """Roboflow semantic-segmentation layout: images with ``*_mask.png``
        pairs and ``_classes.csv`` (reference: dict_dataset.py:450)."""
        classes_csv = os.path.join(split_dir, "_classes.csv")
        class_names: List[str] = []
        if os.path.isfile(classes_csv):
            with open(classes_csv) as f:
                lines = [line.strip() for line in f if line.strip()]
            for line in lines[1:]:
                class_names.append(line.split(",")[-1].strip())
        records = []
        for fn in sorted(os.listdir(split_dir)):
            if fn.endswith("_mask.png") or not fn.lower().endswith((".jpg", ".jpeg", ".png")):
                continue
            mask = os.path.join(split_dir, os.path.splitext(fn)[0] + "_mask.png")
            if not os.path.isfile(mask):
                continue
            records.append(dict(file_name=os.path.join(split_dir, fn), sem_seg_file_name=mask))
        meta = DatasetMetadata(
            num_classes=len(class_names) or 1,
            task=Task.SEMSEG,
            count=len(records),
            name=os.path.basename(os.path.dirname(split_dir)),
            image_root=split_dir,
            stuff_classes=class_names,
            ignore_label=255,
        )
        return cls(records, meta)

    @classmethod
    def from_folder(cls, split_dir: str) -> "DictDataset":
        """Classification folder-per-class layout (reference: dict_dataset.py:157)."""
        classes = sorted(d for d in os.listdir(split_dir) if os.path.isdir(os.path.join(split_dir, d)))
        records = []
        for ci, cname in enumerate(classes):
            cdir = os.path.join(split_dir, cname)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith((".jpg", ".jpeg", ".png", ".bmp", ".webp")):
                    records.append(dict(file_name=os.path.join(cdir, fn), label=ci))
        meta = DatasetMetadata(
            num_classes=len(classes),
            task=Task.CLASSIFICATION,
            count=len(records),
            name=os.path.basename(os.path.dirname(split_dir)),
            image_root=split_dir,
            thing_classes=classes,
        )
        return cls(records, meta)

    def save(self, path: str) -> str:
        """Re-export as COCO json (reference: dict_dataset.py save())."""
        images, annotations = [], []
        aid = 1
        for i, r in enumerate(self.records):
            images.append(
                dict(id=r.get("image_id", i), file_name=os.path.basename(r["file_name"]),
                     height=r.get("height"), width=r.get("width"))
            )
            for a in r.get("annotations", []):
                annotations.append(dict(id=aid, image_id=r.get("image_id", i), **a))
                aid += 1
        cats = [dict(id=i, name=n) for i, n in enumerate(self.metadata.classes)]
        with open(path, "w") as f:
            json.dump(dict(images=images, annotations=annotations, categories=cats), f)
        return path


class MapDataset:
    """dataset[i] → mapper(record), retrying other indices on failure
    (reference: datasets/map_dataset.py:15)."""

    def __init__(self, dataset, map_func: Callable):
        self._dataset = dataset
        self._map_func = map_func
        self._rng = random.Random(42)
        self._fallback = []

    @property
    def metadata(self) -> DatasetMetadata:
        return self._dataset.metadata

    def __len__(self) -> int:
        return len(self._dataset)

    def __getitem__(self, idx: int):
        cur_idx = int(idx)
        for _ in range(31):
            data = self._map_func(self._dataset[cur_idx])
            if data is not None:
                return data
            self._fallback.append(cur_idx)
            cur_idx = self._rng.randint(0, len(self._dataset) - 1)
        raise RuntimeError(f"MapDataset failed to map any record after 31 retries (start idx {idx})")


class SerializedDataset:
    """Records pickled into one contiguous numpy byte buffer
    (reference: datasets/serialize.py:11 TorchSerializedDataset): one buffer
    and offsets instead of a Python dict per record, so that forked loader
    workers touch no per-record object (copy-on-write pages stay shared).
    Keeps ``metadata``, so it drops in wherever a DictDataset is read."""

    def __init__(self, records: List[Dict[str, Any]], metadata: Optional[DatasetMetadata] = None):
        blobs = [np.frombuffer(pickle.dumps(r, protocol=-1), dtype=np.uint8) for r in records]
        self._addr = np.cumsum(np.asarray([len(b) for b in blobs], dtype=np.int64))
        self._buf = np.concatenate(blobs) if blobs else np.zeros(0, np.uint8)
        self.metadata = metadata

    def __len__(self) -> int:
        return len(self._addr)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        start = 0 if idx == 0 else int(self._addr[idx - 1])
        return pickle.loads(memoryview(self._buf[start : int(self._addr[idx])]))

    @property
    def nbytes(self) -> int:
        return int(self._buf.nbytes)

    @classmethod
    def from_dict_dataset(cls, ds: "DictDataset") -> "SerializedDataset":
        return cls(ds.records, ds.metadata)
