"""Panoptic inference and panoptic quality of the port against the JAX
package, on seeded probabilities on the CPU: fai_mf's
``MaskFormerProcessor.panoptic_inference`` (JAX
``focoos_tpu/models/fai_mf/processor.py:214``) gives the equal id map and
the same segments; ``PanopticEvaluator`` (JAX
``trainer/evaluation/evaluators.py:353``) the same PQ, SQ and RQ, things
and stuff apart. Both are exact: equal, not close."""

import numpy as np
import pytest
import torch

from focoos_tpu.models.fai_mf.config import MaskFormerConfig as JaxMaskFormerConfig
from focoos_tpu.models.fai_mf.processor import MaskFormerProcessor as JaxMaskFormerProcessor
from focoos_tpu.trainer.evaluation.evaluators import PanopticEvaluator as JaxPanopticEvaluator
from focoos_tpu_torch.models.fai_mf.config import MaskFormerConfig
from focoos_tpu_torch.models.fai_mf.processor import MaskFormerProcessor
from focoos_tpu_torch.trainer.evaluation import PanopticEvaluator

Q, C, H, W = 14, 6, 40, 48
THINGS = {0, 1, 2}


def _queries(seed, q=Q):
    """[Q, C] class probabilities (each query sure of a class, several queries
    of one class: stuff fragments to merge) and [Q, H, W] mask probabilities
    made of smooth blobs that overlap."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, q)
    labels[:4] = [3, 3, 4, 1]  # two stuff queries of class 3, a thing of class 1 twice below
    labels[4] = 1
    logits = rng.normal(0, 1, (q, C))
    logits[np.arange(q), labels] += rng.uniform(1.5, 6.0, q)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    low = rng.normal(0, 2.0, (q, H // 8, W // 8)) - 2.5
    field = np.kron(low, np.ones((8, 8))) + rng.normal(0, 0.3, (q, H, W))
    masks = 1 / (1 + np.exp(-2 * field))
    return probs.astype(np.float32), masks.astype(np.float32)


def _processors():
    return (JaxMaskFormerProcessor(JaxMaskFormerConfig(num_classes=C)),
            MaskFormerProcessor(MaskFormerConfig(num_classes=C)))


@pytest.mark.parametrize("object_threshold,overlap_threshold", [(0.8, 0.8), (0.5, 0.8), (0.5, 0.3), (0.99, 0.8)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_panoptic_inference_matches_jax(seed, object_threshold, overlap_threshold):
    probs, masks = _queries(seed)
    jproc, proc = _processors()
    kw = dict(thing_ids=THINGS, object_threshold=object_threshold, overlap_threshold=overlap_threshold)
    ref_map, ref_segs = jproc.panoptic_inference(probs, masks, **kw)
    got_map, got_segs = proc.panoptic_inference(probs, masks, **kw)
    assert got_map.dtype == ref_map.dtype == np.int32
    np.testing.assert_array_equal(got_map, ref_map)
    assert got_segs == ref_segs
    # tensors in give the same map as numpy in
    t_map, t_segs = proc.panoptic_inference(torch.from_numpy(probs), torch.from_numpy(masks), **kw)
    np.testing.assert_array_equal(t_map, ref_map)
    assert t_segs == ref_segs


def test_panoptic_inference_merges_stuff_and_counts_things():
    """A case that exercises both rules: class 3 (stuff) is one merged
    segment, class 1 (thing) two instances; nothing is kept above a
    threshold no query reaches."""
    probs, masks = _queries(0)
    _, proc = _processors()
    masks[[0, 1, 3, 4]] = 0.02
    masks[0, H // 2:, : W // 2], masks[1, H // 2:, W // 2:] = 0.97, 0.97  # two stuff fragments, side by side
    masks[4, : H // 2, : W // 2], masks[3, : H // 2, W // 2:] = 0.99, 0.99  # two things above them
    masks[[2] + list(range(5, Q))] *= 0.3  # the other queries win no pixel from these four
    probs[[0, 1, 3, 4]] = np.eye(C, dtype=np.float32)[[3, 3, 1, 1]] * 0.95 + 0.01
    ref = _processors()[0].panoptic_inference(probs, masks, thing_ids=THINGS, object_threshold=0.5)
    pan, segs = proc.panoptic_inference(probs, masks, thing_ids=THINGS, object_threshold=0.5)
    np.testing.assert_array_equal(pan, ref[0])
    assert segs == ref[1]
    assert [s["id"] for s in segs if s["category_id"] == 3] == [3001]
    assert [s["id"] for s in segs if s["category_id"] == 1] == [1001, 1002]
    assert proc.panoptic_inference(probs, masks, object_threshold=0.999)[1] == []
    assert not proc.panoptic_inference(probs, masks, object_threshold=0.999)[0].any()


def _ground_truth(pred: np.ndarray, seed: int) -> np.ndarray:
    """A ground-truth map near ``pred``: a void band, one segment shifted,
    one split in two, one new segment the prediction misses."""
    rng = np.random.default_rng(seed)
    gt = pred.copy()
    gt[:, :3] = 0  # void
    ids = [i for i in np.unique(pred) if i]
    if ids:
        gt[np.roll(pred == ids[0], 4, axis=1)] = ids[0]
    if len(ids) > 1:
        part = (pred == ids[1]) & (np.arange(H)[:, None] < H // 2)
        gt[part] = ids[1] + 50
    gt[H - 6:, W - 6:] = 5 * 1000 + 7
    gt[rng.uniform(size=gt.shape) < 0.02] = 0
    return gt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_panoptic_evaluator_matches_jax(seed):
    """PQ/SQ/RQ over three images (things and stuff, per class), the states
    gathered; a prediction that lies on ground-truth void is no false positive."""
    jproc, _ = _processors()
    names = [f"c{i}" for i in range(C)]
    jev = JaxPanopticEvaluator(C, class_names=names, thing_ids=sorted(THINGS))
    ev = PanopticEvaluator(C, class_names=names, thing_ids=sorted(THINGS))
    for i in range(3):
        probs, masks = _queries(10 * seed + i)
        pred, _ = jproc.panoptic_inference(probs, masks, thing_ids=THINGS, object_threshold=0.5)
        gt = _ground_truth(pred, i)
        for e in (jev, ev):
            e.process([{"pan_seg": gt}], [{"panoptic_seg": (pred, None)}])
    ref, got = jev.evaluate(), ev.evaluate()
    assert got == ref
    assert {"PQ", "SQ", "RQ", "PQ_th", "PQ_st"} <= set(got["panoptic_seg"])
    assert 0 < got["panoptic_seg"]["PQ"] < 100
    merged = PanopticEvaluator(C, thing_ids=sorted(THINGS))
    merged.load_gathered_states([ev.state_for_gather(), ev.state_for_gather()])
    jmerged = JaxPanopticEvaluator(C, thing_ids=sorted(THINGS))
    jmerged.load_gathered_states([jev.state_for_gather(), jev.state_for_gather()])
    assert merged.evaluate() == jmerged.evaluate()


def test_prediction_on_void_is_not_a_false_positive():
    gt = np.zeros((H, W), np.int64)
    gt[:, : W // 2] = 3001
    pred = np.zeros((H, W), np.int32)
    pred[:, : W // 2] = 3001
    pred[:10, W // 2 + 2:] = 1001  # all of it on ground-truth void
    for cls in (JaxPanopticEvaluator, PanopticEvaluator):
        ev = cls(C, thing_ids=sorted(THINGS))
        ev.process([{"pan_seg": gt}], [{"panoptic_seg": (pred, None)}])
        assert ev.evaluate()["panoptic_seg"]["PQ"] == 100.0
