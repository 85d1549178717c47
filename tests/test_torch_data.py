"""Port parity for the data pipeline from disk: the port (focoos_tpu_torch)
and the JAX package read the same seeded Roboflow-COCO datasets
(``tools/make_synthetic_dataset.py``) on the CPU.

Records equal; augmented entries under one ``np.random`` seed equal (uint8
images bit for bit, boxes and keypoints to 1e-5: both take the same float64
transform arithmetic); the port's DataLoader-based ``build_train_loader``
against the JAX package's loader, in process and with worker processes,
and its stream semantics (a finite sampler's partial batch, a failing
worker, per-worker augmentation seeds). Every loader with workers takes a
``timeout``, so a hang fails its test instead of stalling the suite.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from test_torch_checkpoint import few_threads  # noqa: F401 (a fixture)
from test_torch_fai_detr import _tiny_configs

from focoos_tpu.data.auto_dataset import AutoDataset as JaxAutoDataset
from focoos_tpu.data.datasets import DictDataset as JaxDictDataset
from focoos_tpu.data.default_aug import get_default_by_task as jax_get_default_by_task
from focoos_tpu.data.loaders import build_train_loader as jax_build_train_loader
from focoos_tpu.models.fai_detr.processor import DETRProcessor as JaxDETRProcessor
from focoos_tpu.ports import DatasetSplitType as JaxSplit
from focoos_tpu.ports import Task as JaxTask
from focoos_tpu_torch import ModelManager
from focoos_tpu_torch.data.auto_dataset import AutoDataset
from focoos_tpu_torch.data.datasets import DictDataset, MapDataset
from focoos_tpu_torch.data.default_aug import get_default_by_task
from focoos_tpu_torch.data.loaders import InferenceSampler, build_test_loader, build_train_loader
from focoos_tpu_torch.models.fai_detr.processor import DETRProcessor
from focoos_tpu_torch.ports import DatasetSplitType, Task, TrainerArgs

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

RES = 64  # the augmentations' output resolution
TIMEOUT = 60  # seconds a test waits for a worker's batch
BOX_TOL = 1e-5  # boxes and keypoints after the same float64 transforms, float32 storage


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """A seeded detection dataset (96² JPEGs, 1-3 shapes of 3 classes) and a keypoint one (160²)."""
    from make_synthetic_dataset import make, make_keypoints

    base = tmp_path_factory.mktemp("data")
    return {
        "detection": make(str(base / "det"), n_train=8, n_val=5, size=96, seed=0),
        "keypoint": make_keypoints(str(base / "kpt"), n_train=4, n_val=3, size=160, seed=1),
    }


def _augs(task: str, split: str, preset: str):
    """(port augs, JAX augs): the task's defaults at RES, the advanced (fai) train preset on request."""
    adv = preset == "fai"
    port = get_default_by_task(Task(task), RES, advanced=adv)[split != "train"]
    jax_ = jax_get_default_by_task(JaxTask(task), RES, advanced=adv)[split != "train"]
    return port, jax_


def _splits(roots, task: str, split: str, preset: str = "default"):
    """(port MapDataset, JAX MapDataset) of one split."""
    paugs, jaugs = _augs(task, split, preset)
    pds = AutoDataset(roots[task], task=task).get_split(paugs, split=DatasetSplitType(split))
    jds = JaxAutoDataset(roots[task], task=task).get_split(jaugs, split=JaxSplit(split))
    return pds, jds


def _mapped(ds, seed: int) -> list:
    np.random.seed(seed)
    return [ds[i] for i in range(len(ds))]


@pytest.mark.parametrize("task", ["detection", "keypoint"])
def test_roboflow_coco_records_match_jax(roots, task):
    for split in ("train", "valid"):
        d = os.path.join(roots[task], split)
        got, ref = DictDataset.from_roboflow_coco(d, Task(task)), JaxDictDataset.from_roboflow_coco(d, JaxTask(task))
        assert got.records == ref.records and len(got) > 0
        gm, rm = dataclasses.asdict(got.metadata), dataclasses.asdict(ref.metadata)
        assert gm.pop("task").value == rm.pop("task").value and gm == rm


@pytest.mark.parametrize("task,split,preset", [
    ("detection", "train", "default"), ("detection", "train", "fai"), ("detection", "val", "default"),
    ("keypoint", "train", "default"), ("keypoint", "val", "default"),
])
def test_augmented_entries_match_jax(roots, task, split, preset):
    """Every record of the split through both packages' mappers and augmentations under one seed."""
    pds, jds = _splits(roots, task, split, preset)
    got, ref = _mapped(pds, 5), _mapped(jds, 5)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.image.dtype == r.image.dtype == np.uint8 and g.image.shape == r.image.shape, i
        np.testing.assert_array_equal(g.image, r.image, err_msg=f"record {i}")
        assert (g.height, g.width, g.file_name, g.image_id) == (r.height, r.width, r.file_name, r.image_id)
        np.testing.assert_allclose(g.instances.boxes.tensor, r.instances.boxes.tensor, rtol=0, atol=BOX_TOL)
        np.testing.assert_array_equal(g.instances.classes, r.instances.classes)
        np.testing.assert_array_equal(g.instances.iscrowd, r.instances.iscrowd)
        if task == "keypoint":
            np.testing.assert_allclose(g.instances.keypoints.tensor, r.instances.keypoints.tensor, rtol=0, atol=BOX_TOL)
    if split == "train":  # the train augmentations moved something
        assert any(g.image.shape[:2] != (RES, RES) or g.instances.boxes.tensor.size for g in got)


def _processors():
    jcfg, pcfg = _tiny_configs()
    return DETRProcessor(pcfg, RES).train(True), JaxDETRProcessor(jcfg, RES).train(True)


def _take(loader, n: int) -> list:
    return [next(loader) for _ in range(n)]


def test_train_loader_in_process_matches_jax(roots):
    """workers=0 against the JAX package's build_train_loader(num_workers=1)
    (its in-process thread): the same sampler stream, augmentations and
    collated batches and targets, on the fai train preset."""
    pds, jds = _splits(roots, "detection", "train", "fai")
    pproc, jproc = _processors()
    np.random.seed(11)
    loader = build_train_loader(pds, pproc, 3, num_workers=0, seed=4, max_instances=5)
    got = _take(loader, 4)  # 12 of 8 records: the sampler's second epoch too
    loader.close()
    np.random.seed(11)
    jloader = jax_build_train_loader(jds, jproc, 3, num_workers=1, seed=4, max_instances=5)
    it = iter(jloader)
    ref = [next(it) for _ in range(4)]
    jloader.close()
    for (images, targets), (jb, jt) in zip(got, ref):
        assert images.dtype == torch.uint8 and images.shape[0] == 3 and images.shape == jb.shape
        np.testing.assert_array_equal(images.numpy(), jb)
        np.testing.assert_array_equal(targets.labels.numpy(), np.asarray(jt.labels))
        np.testing.assert_array_equal(targets.valid.numpy(), np.asarray(jt.valid))
        np.testing.assert_allclose(targets.boxes.numpy(), np.asarray(jt.boxes), rtol=0, atol=BOX_TOL)


def test_train_loader_workers_keep_order_and_val_batches(roots):
    """Two worker processes over the shuffled sampler on the val split (its
    augmentations draw nothing): the same batches, in the same order, bit for
    bit, as mapped in process."""
    pds, _ = _splits(roots, "detection", "val")
    proc = _processors()[0]
    batches = {}
    for workers in (0, 2):
        loader = build_train_loader(pds, proc, 2, num_workers=workers, seed=9, timeout=TIMEOUT)
        batches[workers] = _take(loader, 5)  # 10 of 5 records: two epochs of the sampler
        loader.close()
    for (a, ta), (b, tb) in zip(batches[0], batches[2]):
        assert torch.equal(a, b)
        for f in ("labels", "boxes", "valid"):
            assert torch.equal(getattr(ta, f), getattr(tb, f)), f


@pytest.mark.parametrize("workers", [0, 2])
def test_finite_sampler_flushes_partial_batch_and_ends(roots, workers):
    pds, _ = _splits(roots, "detection", "val")
    loader = build_train_loader(pds, _processors()[0], 2, num_workers=workers, sampler=InferenceSampler(5),
                                timeout=TIMEOUT if workers else 0)
    procs = list(getattr(loader._it, "_workers", []))
    assert len(procs) == workers
    sizes = [images.shape[0] for images, _ in loader]
    assert sizes == [2, 2, 1]
    for p in procs:  # the ended stream stopped its workers
        p.join(timeout=TIMEOUT)
        assert not p.is_alive()
    loader.close()


class _Failing:
    """A dataset whose record 3 cannot be mapped."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 3:
            raise ValueError("record 3 cannot be read")
        return np.zeros(2)


class _Draws:
    """A dataset whose items are draws from the global numpy state (an augmentation's)."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        return np.random.random(3)


class _Stack:
    """A processor double: entries → (stacked array, None)."""

    def preprocess_entries(self, entries, max_instances=100):
        return np.stack(entries), None


def test_failing_worker_raises_in_parent():
    loader = build_train_loader(_Failing(), _Stack(), 2, num_workers=2, sampler=InferenceSampler(8), timeout=TIMEOUT)
    procs = list(loader._it._workers)
    with pytest.raises(ValueError, match="record 3 cannot be read") as info:
        list(loader)
    assert "DataLoader worker" in str(info.value)
    loader.close()
    for p in procs:
        p.join(timeout=TIMEOUT)
        assert not p.is_alive()


def test_workers_draw_their_own_augmentations():
    """Batch k comes from worker k mod 2; each worker's numpy state is
    seeded seed * 1000 + worker as the JAX package's workers are, so the two
    workers' first draws differ (forked without it, both would draw the
    parent's state)."""
    np.random.seed(0)
    loader = build_train_loader(_Draws(), _Stack(), 1, num_workers=2, seed=7, sampler=InferenceSampler(4),
                                timeout=TIMEOUT)
    got = [images.numpy()[0] for images, _ in loader]
    for w in range(2):
        rs = np.random.RandomState(7 * 1000 + w)
        np.testing.assert_array_equal(got[w], rs.random(3))
        np.testing.assert_array_equal(got[w + 2], rs.random(3))
    assert not np.array_equal(got[0], got[1])


def test_test_loader_batches_in_order(roots):
    pds, _ = _splits(roots, "detection", "val")
    batches = list(build_test_loader(pds, batch_size=2))
    assert [len(b) for b in batches] == [2, 2, 1]
    assert [e.file_name for b in batches for e in b] == [pds[i].file_name for i in range(len(pds))]


@pytest.mark.usefixtures("few_threads")
def test_fai_detr_m_finetunes_and_evaluates_from_disk(roots, tmp_path):
    """The slice's path at a tiny size on the CPU: AutoDataset splits from
    disk → ModelManager.get("fai-detr-m-coco") → model.train with two loader
    workers and validation → model.eval, each scoring bbox AP."""
    auto = AutoDataset(roots["detection"], task="detection")
    train_augs, val_augs = get_default_by_task(Task.DETECTION, RES, advanced=True)
    train = auto.get_split(train_augs, split="train")
    val = auto.get_split(val_augs, split="val")
    assert isinstance(train, MapDataset) and train.metadata.classes == ["circle", "square", "triangle"]
    model = ModelManager.get("fai-detr-m-coco", device="cpu", num_classes=len(train.metadata.classes),
                             classes=train.metadata.classes, image_size=RES, num_queries=10,
                             transformer_predictor_dec_layers=2)
    res = model.train(TrainerArgs(run_name="m", output_dir=str(tmp_path), batch_size=2, max_iters=2, workers=2,
                                  workers_timeout=TIMEOUT, eval_period=2, checkpointer_period=10, samples=0), train, val)
    assert res["iterations"] == 2 and 0.0 <= res["metrics"]["bbox"]["AP"] <= 100.0
    scores = model.eval(TrainerArgs(run_name="e", batch_size=2), val)
    assert set(scores) == {"bbox"} and all(np.isfinite(v) for v in scores["bbox"].values())


def test_catalog_layout_reads_its_own_files(tmp_path, monkeypatch):
    """layout="catalog" resolves a catalog name under DATASETS_DIR (here
    coco/annotations/instances_val2017.json) and parses it as the JAX
    catalog's loader does; the JAX AutoDataset first asserts that a
    directory named after the catalog entry exists, which the catalog never
    reads (ROADMAP Queue 3), so the port skips that check for this layout."""
    import json

    from focoos_tpu.data.catalog import _coco_split as jax_coco_split
    from focoos_tpu_torch import ports

    ann = tmp_path / "coco" / "annotations"
    ann.mkdir(parents=True)
    coco = dict(images=[dict(id=7, file_name="a.jpg", height=64, width=80)],
                annotations=[dict(id=1, image_id=7, category_id=3, bbox=[1, 2, 30, 40], iscrowd=0)],
                categories=[dict(id=1, name="person"), dict(id=3, name="car")])
    (ann / "instances_val2017.json").write_text(json.dumps(coco))
    monkeypatch.setattr(ports, "DATASETS_DIR", str(tmp_path))
    ds = AutoDataset("coco_2017_det", task="detection", layout="catalog").get_split(split="val")
    assert isinstance(ds, MapDataset) and len(ds) == 1 and ds.metadata.classes == ["person", "car"]
    import focoos_tpu.data.catalog as jax_catalog

    monkeypatch.setattr(jax_catalog, "DATASETS_DIR", str(tmp_path))
    ref = jax_coco_split("annotations/instances_val2017.json", "val2017", JaxTask.DETECTION)()
    assert ds._dataset.records == ref.records
    with pytest.raises(AssertionError, match="dataset dir not found"):
        JaxAutoDataset("coco_2017_det", task="detection", layout="catalog", datasets_dir=str(tmp_path))
