"""Dataset converters of the port (``focoos_tpu_torch/data/converters.py``)
against the JAX package's (``focoos_tpu/data/converters.py``): each of the
seven functions, run by both packages on the same seeded folders, writes
equal JSON and pixel-equal images and masks (the same files, by name)."""

import json
import os

import cv2
import numpy as np
import pytest

from focoos_tpu.data import converters as jax_conv
from focoos_tpu.data.datasets import DictDataset as JaxDictDataset
from focoos_tpu_torch.data import converters as conv
from focoos_tpu_torch.data.datasets import DictDataset

CLASSES = ["cat", "dog", "car"]


def _supervisely(root, n=3, seed=0):
    """A Supervisely folder: ``img/<name>.jpg`` and ``ann/<name>.jpg.json``
    with rectangles, polygons and an object of a class outside ``CLASSES``."""
    rng = np.random.default_rng(seed)
    (root / "img").mkdir(parents=True)
    (root / "ann").mkdir()
    for i in range(n):
        h, w = int(rng.integers(30, 60)), int(rng.integers(40, 80))
        cv2.imwrite(str(root / "img" / f"im{i}.jpg"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        objects = []
        for j in range(int(rng.integers(2, 5))):
            title = (CLASSES + ["bird"])[int(rng.integers(0, 4))]
            x0, y0 = int(rng.integers(0, w // 2)), int(rng.integers(0, h // 2))
            x1, y1 = int(rng.integers(x0 + 3, w)), int(rng.integers(y0 + 3, h))
            if j % 2:
                objects.append({"classTitle": title, "geometryType": "rectangle",
                                "points": {"exterior": [[x1, y1], [x0, y0]]}})
            else:
                objects.append({"classTitle": title, "geometryType": "polygon",
                                "points": {"exterior": [[x0, y0], [x1, y0 + 1], [(x0 + x1) // 2, y1]]}})
        (root / "ann" / f"im{i}.jpg.json").write_text(json.dumps({"size": {"height": h, "width": w},
                                                                  "objects": objects}))
    return root


def _tree(path) -> dict:
    """{relative path: JSON, pixels or text} of every file under ``path``."""
    out = {}
    for dirpath, _, files in os.walk(path):
        for fn in files:
            p = os.path.join(dirpath, fn)
            rel = os.path.relpath(p, path)
            if fn.endswith(".json"):
                with open(p) as f:
                    out[rel] = json.load(f)
            elif fn.endswith((".png", ".jpg")):
                out[rel] = cv2.imread(p, cv2.IMREAD_UNCHANGED)
            else:
                with open(p) as f:
                    out[rel] = f.read()
    return out


def _assert_same_tree(got, ref):
    got, ref = _tree(got), _tree(ref)
    assert sorted(got) == sorted(ref) and ref
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("class_list", [None, CLASSES], ids=["classes-found", "classes-given"])
def test_supervisely_to_coco_matches_jax(tmp_path, class_list):
    src = _supervisely(tmp_path / "sv")
    for pkg, mod in (("jax", jax_conv), ("port", conv)):
        (tmp_path / pkg).mkdir()
        mod.supervisely_to_coco(str(src / "ann"), str(src / "img"), str(tmp_path / pkg / "coco.json"), class_list)
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    coco = _tree(tmp_path / "port")["coco.json"]
    assert len(coco["images"]) == 3 and coco["annotations"]


def test_supervisely_to_semseg_masks_matches_jax(tmp_path):
    src = _supervisely(tmp_path / "sv", seed=1)
    jax_conv.supervisely_to_semseg_masks(str(src / "ann"), str(tmp_path / "jax"), CLASSES)
    conv.supervisely_to_semseg_masks(str(src / "ann"), str(tmp_path / "port"), CLASSES)
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    masks = _tree(tmp_path / "port")
    assert any((m < 255).any() for m in masks.values())  # some polygon was drawn


def _roboflow_coco(root, seed=2):
    rng = np.random.default_rng(seed)
    for split in ("train", "valid"):
        d = root / split
        d.mkdir(parents=True)
        images, anns = [], []
        for i, (h, w) in enumerate(((100, 200), (60, 50), (300, 120))):
            cv2.imwrite(str(d / f"a{i}.jpg"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            images.append({"id": i, "file_name": f"a{i}.jpg", "height": h, "width": w})
            anns.append({"id": i + 1, "image_id": i, "category_id": 0, "bbox": [5.0, 6.0, 20.5, 30.25],
                         "area": 620.0, "segmentation": [[5, 6, 25, 6, 25, 36]]})
        (d / "_annotations.coco.json").write_text(json.dumps(
            {"images": images, "annotations": anns, "categories": [{"id": 0, "name": "c"}]}))
    (root / "extra").mkdir()  # a directory without annotations is copied as it is
    (root / "extra" / "notes.txt").write_text("x")
    return root


def test_resize_dataset_matches_jax(tmp_path):
    src = _roboflow_coco(tmp_path / "src")
    jax_conv.resize_dataset(str(src), str(tmp_path / "jax"), max_size=100)
    conv.resize_dataset(str(src), str(tmp_path / "port"), max_size=100)
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")


def _ninja(root):
    """A DatasetNinja folder: ``<split>/{img,ann}`` with Supervisely JSON; meta.json lists one class."""
    for split, seed in (("train", 3), ("val", 4)):
        sv = _supervisely(root / "ninja" / split, n=2, seed=seed)
        assert sv.is_dir()
    (root / "ninja" / "meta.json").write_text(json.dumps({"classes": [{"title": c} for c in CLASSES + ["bird"]]}))


@pytest.mark.parametrize("use_background", [True, False])
def test_convert_datasetninja_to_mask_dataset_matches_jax(tmp_path, use_background):
    _ninja(tmp_path)
    kw = dict(ignore_classes=["bird"], use_background=use_background)
    jax_conv.convert_datasetninja_to_mask_dataset(str(tmp_path), "ninja", "jax", **kw)
    out = conv.convert_datasetninja_to_mask_dataset(str(tmp_path), "ninja", "port", **kw)
    assert out == str(tmp_path / "port")
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")


def test_convert_to_mask_format_matches_jax(tmp_path):
    _ninja(tmp_path)
    split = conv.convert_datasetninja_to_mask_dataset(str(tmp_path), "ninja", "seg") + "/train"
    jax_conv.convert_to_mask_format(JaxDictDataset.from_roboflow_seg(split), str(tmp_path / "jax"))
    conv.convert_to_mask_format(DictDataset.from_roboflow_seg(split), str(tmp_path / "port"))
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    assert len(DictDataset.from_roboflow_seg(str(tmp_path / "port"))) == 2


def test_get_output_shape_matches_jax():
    for h, w in ((480, 640), (640, 480), (100, 3000), (3000, 100), (333, 333), (17, 1023)):
        for short, max_size in ((1024, 2048), (640, 800), (200, 10_000)):
            assert conv.get_output_shape(h, w, short, max_size) == jax_conv.get_output_shape(h, w, short, max_size)


@pytest.mark.parametrize("is_mask", [False, True], ids=["image", "mask"])
def test_resize_shortest_length_matches_jax(tmp_path, is_mask):
    rng = np.random.default_rng(5)
    src = str(tmp_path / ("m.png" if is_mask else "i.jpg"))
    cv2.imwrite(src, rng.integers(0, 4, (61, 90), dtype=np.uint8) if is_mask
                else rng.integers(0, 256, (61, 90, 3), dtype=np.uint8))
    ref = jax_conv.resize_shortest_length(src, str(tmp_path / "jax"), 128, 160, is_mask=is_mask)
    got = conv.resize_shortest_length(src, str(tmp_path / "port"), 128, 160, is_mask=is_mask)
    assert os.path.basename(got) == os.path.basename(ref)
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    assert cv2.imread(got, cv2.IMREAD_UNCHANGED).shape[:2] == (108, 160)  # 128 x 189, capped at 160
