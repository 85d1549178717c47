"""Port parity for the segmentation evaluation pieces on the CPU: the host
C++ library and its numpy versions, the mask IoU of packed masks, the segm
and semantic evaluators, the Roboflow segmentation datasets and mask
mappers, and the evaluation loop on a tiny fai_mf, against the JAX package.

Tolerances: IoU matrices and packed bits equal (integer counts and one
rounding each side); AP and mIoU to 1e-9 (the same float64 arithmetic).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mf import _configs, _port_model, tiny  # noqa: F401 (a fixture)
from test_torch_checkpoint import few_threads_module  # noqa: F401 (an autouse fixture: two threads throughout)

from focoos_tpu.data.auto_dataset import AutoDataset as JaxAutoDataset
from focoos_tpu.data.default_aug import get_default_by_task as jax_get_default_by_task
from focoos_tpu.ops.mask_iou import device_mask_iou_packed as jax_mask_iou_packed
from focoos_tpu.ops.mask_iou import device_mask_iou_packed_batch as jax_mask_iou_packed_batch
from focoos_tpu.ports import DatasetEntry as JaxDatasetEntry
from focoos_tpu.ports import DatasetLayout as JaxDatasetLayout
from focoos_tpu.ports import DatasetSplitType as JaxSplit
from focoos_tpu.ports import Task as JaxTask
from focoos_tpu.structures import BitMasks as JaxBitMasks
from focoos_tpu.structures import Boxes as JaxBoxes
from focoos_tpu.structures import Instances as JaxInstances
from focoos_tpu.trainer.evaluation.evaluators import InstanceSegmentationEvaluator as JaxSegmEvaluator
from focoos_tpu.trainer.evaluation.evaluators import SemSegEvaluator as JaxSemSegEvaluator
from focoos_tpu.utils import native as jax_native
from focoos_tpu_torch.data.auto_dataset import AutoDataset
from focoos_tpu_torch.data.default_aug import get_default_by_task
from focoos_tpu_torch.models.fai_mf.processor import InstanceDecode, SemanticDecode
from focoos_tpu_torch.ops.mask_iou import device_mask_iou_packed, device_mask_iou_packed_batch, unpackbits
from focoos_tpu_torch.ports import DatasetEntry, DatasetLayout, DatasetSplitType, Task
from focoos_tpu_torch.structures import BitMasks, Boxes, Instances
from focoos_tpu_torch.trainer import evaluation
from focoos_tpu_torch.trainer.evaluation import InstanceSegmentationEvaluator, SemSegEvaluator, get_evaluator
from focoos_tpu_torch.utils import native

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

AP_TOL = 1e-9


def _masks(seed, n, h, w, p=0.5):
    return np.random.default_rng(seed).random((n, h, w)) > p


# --------------------------------------------------------------------------- native library
def test_native_library_builds_and_matches_numpy(monkeypatch):
    """The C++ library (built by g++ at first use) against the numpy versions
    and the JAX package's module: RLE encode/decode, area, COCO string
    round trip, mask IoU and box IoU with crowds."""
    assert native.available()
    rng = np.random.default_rng(0)
    masks = list(_masks(1, 5, 23, 17, 0.6)) + [np.zeros((23, 17), bool), np.ones((23, 17), bool)]
    gts = list(_masks(2, 3, 23, 17, 0.4))
    crowd = np.array([0, 1, 0], np.uint8)
    boxes_a = np.sort(rng.random((6, 4)) * 50, axis=0).astype(np.float32)[:, [0, 1, 2, 3]]
    boxes_a[:, 2:] += boxes_a[:, :2]
    boxes_b = boxes_a[:3] + rng.normal(0, 3, (3, 4)).astype(np.float32)

    def results():
        rles = [native.rle_encode(m) for m in masks]
        return dict(
            rles=rles,
            decoded=[native.rle_decode(r, 23, 17) for r in rles],
            areas=[native.rle_area(r) for r in rles],
            iou=native.mask_iou(masks, gts, crowd),
            box=native.bbox_iou(boxes_a, boxes_b, crowd),
        )

    lib = results()
    monkeypatch.setattr(native, "_load", lambda: None)
    plain = results()
    ref = dict(rles=[jax_native.rle_encode(m) for m in masks], iou=jax_native.mask_iou(masks, gts, crowd),
               box=jax_native.bbox_iou(boxes_a, boxes_b, crowd))
    for got in (lib, plain):
        for r, g, m in zip(ref["rles"], got["rles"], masks):
            np.testing.assert_array_equal(g, r)
        for d, m in zip(got["decoded"], masks):
            np.testing.assert_array_equal(d, m)
        assert got["areas"] == [int(m.sum()) for m in masks]
        np.testing.assert_array_equal(got["iou"], ref["iou"])
        np.testing.assert_allclose(got["box"], ref["box"], rtol=1e-6, atol=0)
    for r in lib["rles"]:
        np.testing.assert_array_equal(native.rle_from_string(native.rle_to_string(r)), r)
        assert native.rle_to_string(r) == jax_native.rle_to_string(r)
    seg = {"size": [23, 17], "counts": native.rle_to_string(lib["rles"][0])}
    np.testing.assert_array_equal(native.coco_rle_decode(seg, 0, 0), masks[0])


# --------------------------------------------------------------------------- mask IoU
def test_device_mask_iou_equals_the_library_and_jax():
    """The IoU of packed masks (odd HW: the last byte padded) equals
    native.mask_iou bit for bit, crowds included, and JAX's; the batched
    form equals per image, an image without ground truth included."""
    k, h, w = 9, 33, 41
    dt = _masks(3, k, h, w, 0.6)
    dt[2] = False
    gts = [list(_masks(4, 3, h, w)), [], list(_masks(5, 2, h, w, 0.7))]
    crowds = [np.array([0, 1, 0], np.uint8), np.zeros(0, np.uint8), np.array([1, 0], np.uint8)]
    packed = np.packbits(dt.reshape(k, -1), axis=-1)
    np.testing.assert_array_equal(unpackbits(torch.from_numpy(packed)).numpy()[:, : h * w],
                                  dt.reshape(k, -1).astype(np.float32))
    iou, areas = device_mask_iou_packed(torch.from_numpy(packed), (h, w), gts[0], gt_crowd=crowds[0])
    lib = native.mask_iou(list(dt), gts[0], crowds[0])
    assert iou.dtype == np.float32
    np.testing.assert_array_equal(iou, lib)
    np.testing.assert_array_equal(iou, np.asarray(jax_mask_iou_packed(packed, (h, w), gts[0], gt_crowd=crowds[0])[0]))
    np.testing.assert_array_equal(areas, dt.reshape(k, -1).sum(-1))
    batch = device_mask_iou_packed_batch([torch.from_numpy(packed)] * 3, (h, w), gts, gt_crowds=crowds)
    jbatch = jax_mask_iou_packed_batch([jnp.asarray(packed)] * 3, (h, w), gts, gt_crowds=crowds)
    for g, c, b, jb in zip(gts, crowds, batch, jbatch):
        np.testing.assert_array_equal(b, native.mask_iou(list(dt), g, c))
        np.testing.assert_array_equal(b, np.asarray(jb))
    with pytest.raises(ValueError, match="resize GT"):
        device_mask_iou_packed(torch.from_numpy(packed), (h, w), [np.zeros((h, w + 8), bool)])


# --------------------------------------------------------------------------- evaluators
def _segm_case(seed, h=40, w=48, k=12, g=4, ncls=3):
    """One image: ground truth (a crowd among them) and detections near it, with scores."""
    rng = np.random.default_rng(seed)
    gt = _masks(seed, g, h, w, 0.55)
    dt = np.concatenate([gt ^ (rng.random((g, h, w)) > 0.93), _masks(seed + 100, k - g, h, w, 0.6)])
    gcls = rng.integers(0, ncls, g)
    dcls = np.concatenate([gcls, rng.integers(0, ncls, k - g)])
    crowd = np.zeros(g, np.int64)
    crowd[-1] = 1
    scores = rng.random(k).astype(np.float32)
    return dict(gt=gt, dt=dt, gcls=gcls, dcls=dcls, crowd=crowd, scores=scores, hw=(h, w))


def _gt_entry(c, entry_cls, inst_cls, masks_cls, boxes_cls):
    gt_boxes = masks_cls(c["gt"]).get_bounding_boxes().tensor
    inst = inst_cls(c["hw"], boxes=boxes_cls(gt_boxes), classes=c["gcls"].astype(np.int64),
                    masks=masks_cls(c["gt"]), iscrowd=c["crowd"])
    return entry_cls(image=np.zeros((*c["hw"], 3), np.uint8), height=c["hw"][0], width=c["hw"][1], instances=inst)


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_segm_evaluator_matches_jax(packed):
    """segm and bbox AP of the port's evaluator (dense masks, or packed masks
    through the IoU of packed masks) against JAX's dense evaluator, to 1e-9,
    over three images with crowds."""
    cases = [_segm_case(s) for s in range(3)]
    port, jax_ = InstanceSegmentationEvaluator(num_classes=3), JaxSegmEvaluator(num_classes=3)
    for c in cases:
        boxes = BitMasks(c["dt"]).get_bounding_boxes().tensor
        if packed:
            inst = Instances(c["hw"], boxes=Boxes(boxes), scores=c["scores"], classes=c["dcls"],
                             masks_packed=torch.from_numpy(np.packbits(c["dt"].reshape(len(boxes), -1), axis=-1)))
            inst._masks_packed_hw = c["hw"]
        else:
            inst = Instances(c["hw"], boxes=Boxes(boxes), scores=c["scores"], classes=c["dcls"],
                             masks=BitMasks(c["dt"]))
        port.process([_gt_entry(c, DatasetEntry, Instances, BitMasks, Boxes)], [{"instances": inst}])
        jinst = JaxInstances(c["hw"], boxes=JaxBoxes(boxes), scores=c["scores"], classes=c["dcls"],
                             masks=JaxBitMasks(c["dt"]))
        jax_.process([_gt_entry(c, JaxDatasetEntry, JaxInstances, JaxBitMasks, JaxBoxes)], [{"instances": jinst}])
    got, ref = port.evaluate(), jax_.evaluate()
    assert sorted(got) == sorted(ref) == ["bbox", "segm"]
    for key in ref:
        assert sorted(got[key]) == sorted(ref[key])
        for m, v in ref[key].items():
            assert (np.isnan(v) and np.isnan(got[key][m])) or abs(got[key][m] - v) <= AP_TOL, (key, m)
    assert 0 < ref["segm"]["AP"] < 100


def test_semseg_evaluator_matches_jax():
    """mIoU, fwIoU, mACC, pACC and per-class IoU against JAX's, with the
    ignore label, a class scored but absent, and a prediction resized
    (nearest) to the ground truth's shape."""
    rng = np.random.default_rng(6)
    names = ["a", "b", "c", "d"]
    port, jax_ = SemSegEvaluator(4, class_names=names), JaxSemSegEvaluator(4, class_names=names)
    for i in range(3):
        gt = rng.integers(0, 3, (30, 28)).astype(np.uint8)
        gt[:3] = 255
        pred = rng.integers(0, 4, (15, 14) if i == 2 else (30, 28)).astype(np.uint8)
        port.process([DatasetEntry(sem_seg=gt)], [{"sem_seg": pred}])
        jax_.process([JaxDatasetEntry(sem_seg=gt)], [{"sem_seg": pred}])
    got, ref = port.evaluate()["sem_seg"], jax_.evaluate()["sem_seg"]
    assert sorted(got) == sorted(ref)
    for m, v in ref.items():
        assert abs(got[m] - v) <= AP_TOL, m


def test_get_evaluator_serves_the_segmentation_tasks():
    assert isinstance(get_evaluator(Task.INSTANCE_SEGMENTATION, 3), InstanceSegmentationEvaluator)
    assert isinstance(get_evaluator(Task.SEMSEG, 3), SemSegEvaluator)
    assert type(get_evaluator(Task.CLASSIFICATION, 3)).__name__ == "ClassificationEvaluator"


# --------------------------------------------------------------------------- data
@pytest.fixture(scope="module")
def seg_roots(tmp_path_factory):
    """A seeded Roboflow semantic-segmentation set (96² JPEGs + PNG masks) and a
    Roboflow-COCO set with polygons, at 96²."""
    from make_synthetic_dataset import make, make_semseg

    base = tmp_path_factory.mktemp("segdata")
    return {
        "semseg": make_semseg(str(base / "sem"), n_train=3, n_val=3, size=96, seed=2),
        "instseg": make(str(base / "ins"), n_train=3, n_val=3, size=96, seed=3),
    }


@pytest.mark.parametrize("task", ["semseg", "instseg"])
def test_segmentation_datasets_and_mappers_match_jax(seg_roots, task):
    """from_roboflow_seg's records and metadata, and the validation split's
    mapped entries (images, the semantic map, classes, boxes, masks, crowd
    flags) against the JAX package's."""
    paugs = get_default_by_task(Task(task), 64)[1]
    jaugs = jax_get_default_by_task(JaxTask(task), 64)[1]
    layout = "roboflow_seg" if task == "semseg" else "roboflow_coco"
    pds = AutoDataset(seg_roots[task], task=task, layout=DatasetLayout(layout)).get_split(
        paugs, split=DatasetSplitType.VAL)
    jds = JaxAutoDataset(seg_roots[task], task=task, layout=JaxDatasetLayout(layout)).get_split(
        jaugs, split=JaxSplit.VAL)
    assert len(pds) == len(jds) == 3
    pm, jm = pds.metadata, jds.metadata
    assert (pm.num_classes, pm.thing_classes, pm.stuff_classes, pm.ignore_label) == (
        jm.num_classes, jm.thing_classes, jm.stuff_classes, jm.ignore_label)
    for i in range(3):
        p, j = pds[i], jds[i]
        np.testing.assert_array_equal(p.image, j.image)
        assert (p.height, p.width, p.file_name) == (j.height, j.width, j.file_name)
        if task == "semseg":
            np.testing.assert_array_equal(p.sem_seg, j.sem_seg)
        pi, ji = p.instances, j.instances
        assert len(pi) > 0 and len(pi) == len(ji)
        np.testing.assert_array_equal(pi.classes, ji.classes)
        np.testing.assert_allclose(pi.boxes.tensor, ji.boxes.tensor, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(pi.masks.tensor, ji.masks.tensor)
        if task == "instseg":
            np.testing.assert_array_equal(pi.iscrowd, ji.iscrowd)


# --------------------------------------------------------------------------- evaluation loop
def test_evaluation_loop_copies_only_the_decode(tiny, monkeypatch):
    """evaluate_dataset on a tiny fai_mf: what the loop hands to the host copy
    is the processor's decode (a label map, or scores/labels/boxes with the
    packed masks marked to stay on the device), never the [B, Q, H, W] mask
    stack, and the results equal the evaluator run on eval_postprocess of
    the model's forward."""
    from focoos_tpu_torch.models.focoos_model import FocoosModel
    from focoos_tpu_torch.ports import ModelFamily, ModelInfo

    kind = tiny["kind"]
    pcfg = tiny["pcfg"]
    task = Task.INSTANCE_SEGMENTATION if kind == "ins" else Task.SEMSEG
    info = ModelInfo(name="tiny", model_family=ModelFamily.MASKFORMER, classes=[f"c{i}" for i in range(pcfg.num_classes)],
                     im_size=64, task=task, config=pcfg.to_dict())
    model = FocoosModel(_port_model(pcfg, tiny["flat"]), pcfg, info, device="cpu", init_weights=False)
    rng = np.random.default_rng(8)
    entries = []
    for i in range(3):
        img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        gt = _masks(20 + i, 2, 64, 64, 0.5)
        inst = Instances((64, 64), boxes=BitMasks(gt).get_bounding_boxes(), classes=np.array([1, 2]),
                         masks=BitMasks(gt))
        entries.append(DatasetEntry(image=img, height=64, width=64, instances=inst,
                                    sem_seg=rng.integers(0, 3, (64, 64)).astype(np.uint8)))
    seen = []
    real = evaluation._to_host

    def spy(out, device):
        seen.append(out)
        return real(out, device)

    monkeypatch.setattr(evaluation, "_to_host", spy)
    got = evaluation.evaluate_dataset(model, entries, batch_size=2)
    assert len(seen) == 2 and evaluation.stats["batches"] == 2
    for out in seen:
        if kind == "ins":
            assert isinstance(out, InstanceDecode) and out.packed is None and out.packed_on_device is not None
            assert out.scores.shape == out.labels.shape == (out.boxes.shape[0], out.boxes.shape[1])
        else:
            assert isinstance(out, SemanticDecode) and out.sem_seg.dtype == torch.uint8
    ev = get_evaluator(task, pcfg.num_classes, info.classes)
    for i in range(0, 3, 2):
        batch = entries[i:i + 2]
        x, _ = model.processor.preprocess(batch)
        ev.process(batch, model.processor.eval_postprocess(model.forward(x), batch))
    ref = ev.evaluate()
    assert sorted(got) == sorted(ref)
    for key in ref:
        for m, v in ref[key].items():
            assert (np.isnan(v) and np.isnan(got[key][m])) or got[key][m] == v, (key, m)
