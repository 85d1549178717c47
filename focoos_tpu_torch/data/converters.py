"""Dataset format converters (copy of ``focoos_tpu/data/converters.py``;
reference: focoos/data/converters.py).

Supervisely → COCO / sem-seg PNG, DatasetNinja → the Roboflow mask-folder
layout, dataset resize/clone utilities. Host code: numpy, and cv2 imported
where an image is read or written. The same inputs give the JAX package's
files: the same JSON and the same PNGs.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np

from focoos_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


def supervisely_to_coco(ann_dir: str, img_dir: str, out_json: str, class_list: Optional[List[str]] = None) -> str:
    """Convert a Supervisely annotation folder to COCO detection json
    (reference: converters.py supervisely→COCO)."""
    classes: Dict[str, int] = {c: i for i, c in enumerate(class_list)} if class_list else {}
    images, annotations = [], []
    aid = 1
    files = sorted(f for f in os.listdir(ann_dir) if f.endswith(".json"))
    for iid, fn in enumerate(files):
        with open(os.path.join(ann_dir, fn)) as f:
            ann = json.load(f)
        img_name = fn[:-5]  # strip .json
        h = ann.get("size", {}).get("height")
        w = ann.get("size", {}).get("width")
        images.append(dict(id=iid, file_name=img_name, height=h, width=w))
        for obj in ann.get("objects", []):
            title = obj.get("classTitle")
            if title not in classes:
                if class_list is not None:
                    continue
                classes[title] = len(classes)
            geom = obj.get("points", {}).get("exterior", [])
            if obj.get("geometryType") == "rectangle" and len(geom) == 2:
                (x0, y0), (x1, y1) = geom
                bbox = [min(x0, x1), min(y0, y1), abs(x1 - x0), abs(y1 - y0)]
                seg = []
            elif geom:
                pts = np.asarray(geom, np.float64)
                x0, y0 = pts.min(0)
                x1, y1 = pts.max(0)
                bbox = [float(x0), float(y0), float(x1 - x0), float(y1 - y0)]
                seg = [pts.flatten().tolist()]
            else:
                continue
            annotations.append(
                dict(id=aid, image_id=iid, category_id=classes[title], bbox=bbox,
                     segmentation=seg, area=bbox[2] * bbox[3], iscrowd=0)
            )
            aid += 1
    cats = [dict(id=i, name=c) for c, i in sorted(classes.items(), key=lambda kv: kv[1])]
    with open(out_json, "w") as f:
        json.dump(dict(images=images, annotations=annotations, categories=cats), f)
    logger.info(f"wrote {out_json}: {len(images)} images, {len(annotations)} annotations, {len(cats)} classes")
    return out_json


def supervisely_to_semseg_masks(ann_dir: str, out_dir: str, class_list: List[str]) -> str:
    """Rasterize Supervisely polygon annotations to class-index PNG masks."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    class_idx = {c: i for i, c in enumerate(class_list)}
    for fn in sorted(os.listdir(ann_dir)):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(ann_dir, fn)) as f:
            ann = json.load(f)
        h = ann["size"]["height"]
        w = ann["size"]["width"]
        mask = np.full((h, w), 255, np.uint8)
        for obj in ann.get("objects", []):
            ci = class_idx.get(obj.get("classTitle"))
            if ci is None:
                continue
            pts = np.asarray(obj.get("points", {}).get("exterior", []), np.int32)
            if len(pts) >= 3:
                cv2.fillPoly(mask, [pts], int(ci))
        base = os.path.splitext(fn[:-5])[0]
        cv2.imwrite(os.path.join(out_dir, base + "_mask.png"), mask)
    return out_dir


def resize_dataset(src_dir: str, dst_dir: str, max_size: int = 1024) -> str:
    """Clone a roboflow-coco dataset with images resized to max_size on the
    long edge, rescaling annotations (reference: converters.py resize utils)."""
    import cv2

    for split in os.listdir(src_dir):
        sdir = os.path.join(src_dir, split)
        if not os.path.isdir(sdir):
            continue
        ddir = os.path.join(dst_dir, split)
        os.makedirs(ddir, exist_ok=True)
        ann_path = os.path.join(sdir, "_annotations.coco.json")
        if not os.path.isfile(ann_path):
            shutil.copytree(sdir, ddir, dirs_exist_ok=True)
            continue
        with open(ann_path) as f:
            coco = json.load(f)
        scale_by_img: Dict[int, float] = {}
        for img in coco["images"]:
            path = os.path.join(sdir, img["file_name"])
            im = cv2.imread(path)
            if im is None:
                continue
            h, w = im.shape[:2]
            scale = min(1.0, max_size / max(h, w))
            scale_by_img[img["id"]] = scale
            if scale < 1.0:
                im = cv2.resize(im, (int(w * scale), int(h * scale)), interpolation=cv2.INTER_AREA)
                img["height"], img["width"] = im.shape[:2]
            cv2.imwrite(os.path.join(ddir, img["file_name"]), im)
        for a in coco["annotations"]:
            s = scale_by_img.get(a["image_id"], 1.0)
            if s < 1.0:
                a["bbox"] = [v * s for v in a["bbox"]]
                a["area"] = a.get("area", 0) * s * s
                if isinstance(a.get("segmentation"), list):
                    a["segmentation"] = [[v * s for v in poly] for poly in a["segmentation"]]
        with open(os.path.join(ddir, "_annotations.coco.json"), "w") as f:
            json.dump(coco, f)
    return dst_dir


def convert_to_mask_format(dataset, new_data_dir: str) -> str:
    """Export a semantic-seg DictDataset into the roboflow mask-folder layout
    (reference: converters.py:236 — ``_classes.csv`` + ``{img}`` +
    ``{img}_mask.png`` pairs in one split directory)."""
    import csv

    from focoos_tpu_torch.ports import Task

    assert dataset.metadata.task == Task.SEMSEG, "convert_to_mask_format requires a SEMSEG dataset"
    os.makedirs(new_data_dir, exist_ok=True)
    with open(os.path.join(new_data_dir, "_classes.csv"), "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["Pixel Value", "Class"])
        for i, name in enumerate(dataset.metadata.classes):
            writer.writerow([i, name])
    n = 0
    for rec in dataset:
        img, mask = rec["file_name"], rec["sem_seg_file_name"]
        img_name = os.path.basename(img)
        shutil.copy(img, os.path.join(new_data_dir, img_name))
        shutil.copy(mask, os.path.join(new_data_dir, os.path.splitext(img_name)[0] + "_mask.png"))
        n += 1
    logger.info(f"wrote mask-format dataset → {new_data_dir} ({n} pairs)")
    return new_data_dir


def convert_datasetninja_to_mask_dataset(
    dataset_root: str,
    dataset_name: str,
    new_name: str,
    image_folder: str = "img",
    mask_folder: str = "ann",
    ignore_classes: Optional[List[str]] = None,
    use_background: bool = True,
    train_split_name: str = "train",
    val_split_name: str = "val",
) -> str:
    """DatasetNinja (Supervisely-layout) → roboflow mask-folder dataset
    (reference: converters.py:359).

    Input:  ``dataset_root/dataset_name/{split}/{image_folder,mask_folder}``
            with per-image Supervisely JSON polygon annotations and a
            ``meta.json`` listing classes.
    Output: ``dataset_root/new_name/{train,valid}/`` each holding
            ``_classes.csv`` + image/mask pairs, loadable via
            ``DatasetLayout.ROBOFLOW_SEG``.
    """
    import csv

    src = os.path.join(dataset_root, dataset_name)
    dst = os.path.join(dataset_root, new_name)
    ignore = set(ignore_classes or [])

    # class list: meta.json if present, else the union over annotations
    classes: List[str] = []
    meta_path = os.path.join(src, "meta.json")
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        classes = [c["title"] for c in meta.get("classes", []) if c["title"] not in ignore]
    else:
        seen = set()
        for split in (train_split_name, val_split_name):
            ann_dir = os.path.join(src, split, mask_folder)
            if not os.path.isdir(ann_dir):
                continue
            for fn in os.listdir(ann_dir):
                if fn.endswith(".json"):
                    with open(os.path.join(ann_dir, fn)) as f:
                        for obj in json.load(f).get("objects", []):
                            t = obj.get("classTitle")
                            if t and t not in ignore:
                                seen.add(t)
        classes = sorted(seen)
    if use_background:
        classes = ["background"] + [c for c in classes if c != "background"]

    for split, out_split in ((train_split_name, "train"), (val_split_name, "valid")):
        ann_dir = os.path.join(src, split, mask_folder)
        img_dir = os.path.join(src, split, image_folder)
        if not os.path.isdir(ann_dir) or not os.path.isdir(img_dir):
            continue
        out_dir = os.path.join(dst, out_split)
        os.makedirs(out_dir, exist_ok=True)
        # rasterize polygons → "{img}_mask.png" next to copied images
        supervisely_to_semseg_masks(ann_dir, out_dir, classes)
        # masks rasterized with 255 ignore; background index 0 covers the rest
        if use_background:
            import cv2

            for fn in os.listdir(out_dir):
                if fn.endswith("_mask.png"):
                    p = os.path.join(out_dir, fn)
                    m = cv2.imread(p, cv2.IMREAD_UNCHANGED)
                    m[m == 255] = 0
                    cv2.imwrite(p, m)
        for fn in os.listdir(img_dir):
            shutil.copy(os.path.join(img_dir, fn), os.path.join(out_dir, fn))
        with open(os.path.join(out_dir, "_classes.csv"), "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["Pixel Value", "Class"])
            for i, name in enumerate(classes):
                writer.writerow([i, name])
        logger.info(f"datasetninja split {split} → {out_dir}")
    return dst


def get_output_shape(old_height: int, old_width: int, short_edge_length: int, max_size: int) -> Tuple[int, int]:
    """(new_h, new_w) scaling the short edge to ``short_edge_length`` capped at
    ``max_size`` (reference: transforms/resize_short_length.py:8)."""
    scale = short_edge_length / min(old_height, old_width)
    if old_height < old_width:
        new_h, new_w = short_edge_length, old_width * scale
    else:
        new_h, new_w = old_height * scale, short_edge_length
    if max(new_h, new_w) > max_size:
        scale = max_size / max(new_h, new_w)
        new_h, new_w = new_h * scale, new_w * scale
    return int(new_h + 0.5), int(new_w + 0.5)


def resize_shortest_length(
    im_path: str, out_path: str, shortest_length: int = 1024, max_size: int = 2048, is_mask: bool = False
) -> str:
    """Resize one image (or label mask: nearest) to a short-edge target and
    write it under ``out_path`` (reference: transforms/resize_short_length.py:29)."""
    import cv2

    os.makedirs(out_path, exist_ok=True)
    dst = os.path.join(out_path, os.path.basename(im_path))
    flags = cv2.IMREAD_UNCHANGED if is_mask else cv2.IMREAD_COLOR
    im = cv2.imread(im_path, flags)
    new_h, new_w = get_output_shape(im.shape[0], im.shape[1], shortest_length, max_size)
    interp = cv2.INTER_NEAREST if is_mask else cv2.INTER_LINEAR
    cv2.imwrite(dst, cv2.resize(im, (new_w, new_h), interpolation=interp))
    return dst
