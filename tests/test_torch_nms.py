"""Port parity for the greedy NMS (``focoos_tpu_torch/ops/nms.py``) on the CPU.

The port's ``nms_keep`` takes its plain version for CPU tensors; it is held
against the JAX package's XLA loop (``focoos_tpu/ops/nms.py::nms_keep``) and
against the Pallas sweep in interpret mode
(``focoos_tpu/ops/pallas/nms_kernel.py::nms_keep_pallas``), as
``tests/test_ops.py`` runs it. Keep masks must be equal, not close: the
batched port runs every image at once, the JAX functions one image at a time.
The boxes are clustered so that many overlap, with exact duplicates,
zero-area boxes and a zero-score tail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focoos_tpu.ops.nms import nms_keep as jax_nms_keep
from focoos_tpu.ops.nms import topk_nms as jax_topk_nms
from focoos_tpu.ops.pallas.nms_kernel import nms_keep_pallas
from focoos_tpu_torch.ops import nms as port_nms
from focoos_tpu_torch.ops.boxes import box_iou


def clustered_boxes(rng: np.random.Generator, b: int, k: int, zero_tail: int):
    """[B, K, 4] xyxy boxes around K/8 centres (so many overlap), with a
    duplicated run, two zero-area boxes, and scores sorted descending whose
    last ``zero_tail`` entries are 0."""
    centres = rng.uniform(0, 600, (b, k // 8 + 1, 2))
    pick = rng.integers(0, centres.shape[1], (b, k))
    xy = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 8, (b, k, 2))
    wh = rng.uniform(20, 100, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, 5:9] = boxes[:, 1:5]  # exact duplicates of higher-scored boxes
    boxes[:, 10:12, 2:] = boxes[:, 10:12, :2]  # zero area
    scores = -np.sort(-rng.uniform(0.05, 1.0, (b, k)), axis=-1).astype(np.float32)
    scores[:, k - zero_tail:] = 0.0
    return boxes, scores


@pytest.mark.parametrize("thr", [0.5, 0.65])
@pytest.mark.parametrize("k", [64, 128, 300])
def test_nms_keep_matches_jax_and_pallas_interpret(k, thr):
    boxes, scores = clustered_boxes(np.random.default_rng(k), 3, k, zero_tail=k // 6)
    got = port_nms.nms_keep(torch.from_numpy(boxes), torch.from_numpy(scores), thr).numpy()
    assert got.dtype == np.bool_ and got.shape == (3, k)
    for i in range(3):
        want = np.asarray(jax_nms_keep(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), thr))
        pallas = np.asarray(nms_keep_pallas(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), thr, interpret=True))
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(got[i], pallas)
    valid = scores > 0
    assert not got[~valid].any(), "a zero-score box was kept"
    assert got.sum() < valid.sum(), "the clustered boxes suppressed nothing: the case tests nothing"


def test_nms_keep_non_finite_boxes_match_jax():
    """A NaN or infinite coordinate (exp() of a box-size output can overflow)
    gives the same keep mask: NaN IoUs compare false on both sides."""
    boxes, scores = clustered_boxes(np.random.default_rng(3), 1, 64, zero_tail=4)
    boxes[0, 2] = [np.nan, 10.0, 50.0, 60.0]
    boxes[0, 3, 2:] = np.inf
    boxes[0, 20:22] = boxes[0, 2:4]
    boxes[0, 30] = [-np.inf, -np.inf, np.inf, np.inf]
    got = port_nms.nms_keep(torch.from_numpy(boxes), torch.from_numpy(scores), 0.65).numpy()
    want = np.asarray(jax_nms_keep(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), 0.65))
    np.testing.assert_array_equal(got[0], want)


def exact_iou_pairs(boxes: np.ndarray, scores: np.ndarray, at=(0, 31, 100, 511)) -> list:
    """Put pairs whose IoU is exactly 0.5 (``[0, 0, 2, 1]`` and ``[0, 0, 1, 1]``,
    moved far from every other box and from each other) at rows s, s+1 of
    every image, for each s whose pair has positive scores; the starts used."""
    starts = [s for s in at if s + 1 < boxes.shape[1] and scores[0, s + 1] > 0]
    for p, s in enumerate(starts):
        o = 10000.0 + 100.0 * p
        boxes[:, s] = [o, o, o + 2, o + 1]
        boxes[:, s + 1] = [o, o, o + 1, o + 1]
    return starts


def bitmask_model(overlap: np.ndarray) -> np.ndarray:
    """The overlap bitmask of ``csrc/nms.cu`` as [K, W] uint32 (the kernel
    stores it by column word): bit t of word l of row r is
    ``overlap[r, 32l + t]``, set only for columns after the row."""
    k = overlap.shape[0]
    w = -(-k // 32)
    padded = np.zeros((k, 32 * w), bool)
    padded[:, :k] = np.triu(overlap, 1)
    return np.packbits(padded.reshape(k, w, 32), axis=-1, bitorder="little").view("<u4")[..., 0]


def block_sweep_model(mask: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The sweep of ``csrc/nms.cu`` over 32 boxes at a time: removed[l] holds
    word l of the invalid or suppressed boxes; word-block b decides its boxes
    in order against removed[b] and its diagonal words, then ORs word l of its
    kept rows into removed[l] for every later l. Returns keep [K]."""
    k, w = mask.shape
    padded = np.zeros(32 * w, bool)
    padded[:k] = valid
    removed = [~int(v) & 0xFFFFFFFF for v in np.packbits(padded.reshape(w, 32), axis=-1, bitorder="little").view("<u4")[:, 0]]
    for b in range(w):
        rows = range(32 * b, min(k, 32 * b + 32))
        cur = removed[b]
        for t, r in enumerate(rows):
            if not (cur >> t) & 1:
                cur |= int(mask[r, b])
        kept = [r for t, r in enumerate(rows) if not (cur >> t) & 1]
        for l in range(b + 1, w):
            for r in kept:
                removed[l] |= int(mask[r, l])
        removed[b] = cur
    return np.array([not (removed[i >> 5] >> (i & 31)) & 1 for i in range(k)])


HALF = np.float32(0.5)


@pytest.mark.parametrize(
    "thr", [HALF, np.nextafter(HALF, np.float32(0)), np.nextafter(HALF, np.float32(1))], ids=["0.5", "0.5-ulp", "0.5+ulp"]
)
@pytest.mark.parametrize("k", [1, 31, 32, 33, 300, 1024])
def test_block_sweep_model_matches_reference_and_jax(k, thr):
    """A numpy model of the kernel's bitmask and 32-box block sweep, held
    against the plain version and JAX's XLA loop where there is no card:
    clustered boxes, word-block boundaries (K = 31, 32, 33, a pair across
    rows 31/32) and pairs whose IoU is exactly 0.5, at the threshold and one
    ulp either side of it."""
    thr = float(thr)
    boxes, scores = clustered_boxes(np.random.default_rng(k), 1, k, zero_tail=k // 6)
    starts = exact_iou_pairs(boxes, scores)
    bt, st = torch.from_numpy(boxes), torch.from_numpy(scores)
    overlap = (box_iou(bt, bt)[0] > thr)[0].numpy()
    got = block_sweep_model(bitmask_model(overlap), scores[0] > 0)
    ref = port_nms.nms_keep_reference(bt, st, thr)[0].numpy()
    want = np.asarray(jax_nms_keep(jnp.asarray(boxes[0]), jnp.asarray(scores[0]), thr))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, want)
    for s in starts:  # the pair's first box is kept; its second falls only below IoU 0.5
        assert got[s] and got[s + 1] == (thr >= 0.5)
    if k >= 300:
        assert got.sum() < (scores > 0).sum(), "the clustered boxes suppressed nothing: the case tests nothing"


def test_topk_nms_matches_jax():
    """Score filter → top-k → NMS → top-max_out on distinct scores: the same
    anchor indices, validity and scores per slot."""
    rng = np.random.default_rng(7)
    b, a, pre, max_out, thr, score_thr = 2, 200, 60, 60, 0.65, 0.2
    boxes, _ = clustered_boxes(rng, b, a, zero_tail=0)
    scores = rng.permutation(b * a).reshape(b, a).astype(np.float32) / (b * a)  # distinct
    idx, valid, out = port_nms.topk_nms(torch.from_numpy(boxes), torch.from_numpy(scores), pre, thr, max_out, score_thr)
    for i in range(b):
        j_idx, j_valid, j_out = (
            np.asarray(t) for t in jax_topk_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), pre, thr, max_out, score_thr)
        )
        np.testing.assert_array_equal(valid[i].numpy(), j_valid)
        np.testing.assert_array_equal(out[i].numpy(), j_out)
        np.testing.assert_array_equal(idx[i].numpy()[j_valid], j_idx[j_valid])
        assert 0 < j_valid.sum() < max_out


def test_nms_kernel_input_checks():
    """What the kernel does not take is refused before any launch."""
    ok_boxes, ok_scores = torch.zeros(2, 8, 4), torch.ones(2, 8)
    port_nms._check(ok_boxes, ok_scores)
    for boxes, scores, exc in (
        (torch.zeros(2, port_nms.MAX_K + 1, 4), torch.ones(2, port_nms.MAX_K + 1), ValueError),
        (torch.zeros(2, 0, 4), torch.ones(2, 0), ValueError),
        (torch.zeros(2, 8, 4, dtype=torch.float64), torch.ones(2, 8), TypeError),
        (torch.zeros(2, 8, 4), torch.ones(2, 7), ValueError),
        (torch.zeros(2, 4, 8).transpose(1, 2), torch.ones(2, 8), ValueError),
    ):
        with pytest.raises(exc):
            port_nms._check(boxes, scores)
