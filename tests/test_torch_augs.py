"""The 13 augmentations a user's own list may name (port
``focoos_tpu_torch/data/transforms.py`` against the JAX package's
``focoos_tpu/data/transforms.py``), one case each: the same seed (numpy's
global state and Python's ``random``) gives the same transform in both
packages. Compared on one seeded record: the image and the segmentation map
(uint8, equal), the boxes and the keypoint coordinates (≤ 1e-5 px).
"""

import random

import numpy as np
import pytest

from focoos_tpu.data import transforms as jax_T
from focoos_tpu_torch.data import transforms as T

H, W = 48, 64
GEOM_TOL = 1e-5


def _record():
    """A textured uint8 image, 3 boxes, a 3-class segmentation map, 4 keypoints."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    img[10:30, 15:40] = rng.integers(150, 256, 3, dtype=np.uint8)
    boxes = np.array([[15, 10, 40, 30], [2, 3, 20, 25], [30, 20, 60, 44]], np.float32)
    seg = np.zeros((H, W), np.uint8)
    seg[10:30, 15:40] = 1
    seg[30:, :20] = 2
    kpts = np.array([[20.5, 12.0], [3.0, 40.0], [63.0, 47.0], [33.3, 21.7]], np.float64)
    return img, boxes, seg, kpts


CASES = {
    "ExtentTransform": lambda M: M.ExtentTransform((-10.5, 5.2, 70.3, 50.8), (40, 60), fill=0),
    "BlendTransform": lambda M: M.BlendTransform(
        np.random.default_rng(1).uniform(0, 255, (H, W, 3)), src_weight=0.3, dst_weight=0.7),
    "ResizeLongestEdge": lambda M: M.ResizeLongestEdge((40, 90), sample_style="range"),
    "ResizeScale": lambda M: M.ResizeScale(0.5, 1.5, 64, 64),
    "FixedSizeCrop": lambda M: M.FixedSizeCrop((40, 90)),
    "RandomCropWithInstance": lambda M: M.RandomCropWithInstance("relative_range", (0.5, 0.5),
                                                                 single_category_max_area=0.7),
    "MinIoURandomCrop": lambda M: M.MinIoURandomCrop(min_ious=(0.1, 0.3), min_crop_size=0.3, prob=1.0),
    "RandomResize": lambda M: M.RandomResize([(40, 50), (30, 70), (56, 56)]),
    "RandomExtent": lambda M: M.RandomExtent((0.8, 1.2), (0.3, 0.3)),
    "RandomContrast": lambda M: M.RandomContrast(0.5, 1.5),
    "RandomBrightness": lambda M: M.RandomBrightness(0.5, 1.5),
    "RandomSaturation": lambda M: M.RandomSaturation(0.5, 1.5),
    "RandomLighting": lambda M: M.RandomLighting(50.0),
}


def _run(M, name, seed):
    """The case's augmentation from package ``M`` on the record, its draws
    seeded with ``seed`` → (image, boxes, segmentation, keypoints, transform)."""
    np.random.seed(seed)
    random.seed(seed)
    aug = CASES[name](M)
    img, boxes, seg, kpts = _record()
    inp = M.AugInput(img, boxes=boxes, sem_seg=seg)
    if isinstance(aug, M.Transform):
        tfm = aug
        inp.transform(tfm)
    elif name == "RandomCropWithInstance":  # the category-area rule reads the segmentation map
        tfm = aug.get_transform_with_sem_seg(img, seg)
        inp.transform(tfm)
    else:  # as the mappers call a list
        tfm = M.AugmentationList([aug])(inp)
    return inp.image, inp.boxes, inp.sem_seg, tfm.apply_coords(kpts.copy()), tfm


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [3, 11])
def test_augmentation_matches_jax(name, seed):
    img0 = _record()[0]
    ref = _run(jax_T, name, seed)
    got = _run(T, name, seed)
    assert type(got[4]).__name__ == type(ref[4]).__name__
    assert got[0].dtype == ref[0].dtype == np.uint8
    np.testing.assert_array_equal(got[0], ref[0], err_msg="image")
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=GEOM_TOL, err_msg="boxes")
    np.testing.assert_array_equal(got[2], ref[2], err_msg="segmentation")
    np.testing.assert_allclose(got[3], ref[3], rtol=0, atol=GEOM_TOL, err_msg="keypoints")
    # every case changes the record: a draw that left it alone would compare nothing
    assert got[0].shape != img0.shape or not np.array_equal(got[0], img0)


def test_blend_transform_keeps_float_images_float():
    """A float image blends without the uint8 clip, in both packages."""
    img = np.random.default_rng(2).uniform(-50, 300, (8, 8, 3)).astype(np.float32)
    ref = jax_T.BlendTransform(10.0, 0.5, 2.0).apply_image(img)
    got = T.BlendTransform(10.0, 0.5, 2.0).apply_image(img)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
