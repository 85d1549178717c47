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
