"""AutoDataset: name + task + layout → mapped train/val splits (copy of
``focoos_tpu/data/auto_dataset.py``; reference: focoos/data/auto_dataset.py:30-181).

A dataset is a directory (or a ``.zip`` of one, extracted beside it) under
``DATASETS_DIR`` or at an absolute path, holding split directories
(train/training, valid/val/validation, test), optionally one directory level
down; or a name of ``data/catalog.py``. Nothing is downloaded.
"""

from __future__ import annotations

import os
import zipfile
from typing import Optional, Union

from focoos_tpu_torch.data.datasets import DictDataset, MapDataset
from focoos_tpu_torch.data.default_aug import DatasetAugmentations, get_default_by_task
from focoos_tpu_torch.data.mappers import get_mapper_by_task
from focoos_tpu_torch.ports import DATASETS_DIR, DatasetLayout, DatasetSplitType, Task
from focoos_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

SPLIT_DIRS = {
    DatasetSplitType.TRAIN: ["train", "training"],
    DatasetSplitType.VAL: ["valid", "val", "validation"],
    DatasetSplitType.TEST: ["test"],
}


class AutoDataset:
    def __init__(
        self,
        dataset_name: str,
        task: Union[str, Task],
        layout: Union[str, DatasetLayout] = DatasetLayout.ROBOFLOW_COCO,
        datasets_dir: str = DATASETS_DIR,
    ):
        self.task = Task(task)
        self.layout = DatasetLayout(layout)
        self.name = dataset_name
        if self.layout == DatasetLayout.CATALOG:  # the catalog resolves its own files
            self.root = None
            return

        path = dataset_name if os.path.isabs(dataset_name) else os.path.join(datasets_dir, dataset_name)
        if path.endswith(".zip") and os.path.isfile(path):
            extract_dir = path[:-4]
            if not os.path.isdir(extract_dir):
                logger.info(f"Extracting {path} → {extract_dir}")
                with zipfile.ZipFile(path) as z:
                    z.extractall(extract_dir)
            path = extract_dir
        if not os.path.isdir(path):
            raise FileNotFoundError(f"dataset dir not found: {path}")
        # tolerate a single nested directory level after zip extraction
        entries = os.listdir(path)
        if len(entries) == 1 and os.path.isdir(os.path.join(path, entries[0])):
            inner = os.path.join(path, entries[0])
            if any(d in os.listdir(inner) for names in SPLIT_DIRS.values() for d in names):
                path = inner
        self.root = path

    def _split_dir(self, split: DatasetSplitType) -> str:
        for cand in SPLIT_DIRS[split]:
            p = os.path.join(self.root, cand)
            if os.path.isdir(p):
                return p
        raise FileNotFoundError(f"no {split.value} split under {self.root}")

    def get_split(self, augs: Optional[DatasetAugmentations] = None, split: DatasetSplitType = DatasetSplitType.TRAIN):
        """→ MapDataset of DatasetEntry (reference: auto_dataset.py:151)."""
        split = DatasetSplitType(split)
        if self.layout == DatasetLayout.CATALOG:
            from focoos_tpu_torch.data.catalog import load_catalog_split

            base = load_catalog_split(self.name, split)
        elif self.layout == DatasetLayout.ROBOFLOW_COCO:
            split_dir = self._split_dir(split)
            if self.task == Task.CLASSIFICATION:
                base = DictDataset.from_folder(split_dir)
            else:
                base = DictDataset.from_roboflow_coco(split_dir, self.task)
        elif self.layout == DatasetLayout.ROBOFLOW_SEG:
            base = DictDataset.from_roboflow_seg(self._split_dir(split))
        elif self.layout == DatasetLayout.CLS_FOLDER:
            base = DictDataset.from_folder(self._split_dir(split))
        else:
            raise ValueError(f"unsupported layout {self.layout}")

        is_train = split == DatasetSplitType.TRAIN
        if augs is None:
            train_augs, val_augs = get_default_by_task(self.task)
            augs = train_augs if is_train else val_augs
        pipeline = augs.get_augmentations(task=self.task)
        mapper = get_mapper_by_task(self.task, pipeline, is_train=is_train)
        return MapDataset(base, mapper)
