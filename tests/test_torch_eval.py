"""Port parity for evaluation: the port's COCO evaluators, its
``evaluate_dataset`` on the tiny fai-detr (R18 at 96², 20 queries, 2 decoder
layers) and the tiny rtmo-s (128², ``nms_pre_topk`` 50), the rtmo
``eval_postprocess``, and ``FocoosModel.eval`` / in-training validation,
against the JAX package on the same numpy inputs and weights, on the CPU.

Tolerances: the evaluators on the same detections, every key of the result
within 1e-9 (both are float64 numpy on the same values), -1 for a slice
without ground truth in the same places; ``eval_postprocess`` of the two
fp32 forwards, scores within 1e-4 absolute, fai-detr's boxes (pixels of a
96² image) within 1e-4 absolute, rtmo's boxes and keypoints within 1e-4 ×
max|ref| as tests/test_torch_rtmo.py holds its forward; AP dicts of ``evaluate_dataset`` within 1e-3 AP
points (a detection moved by 1e-4 px crosses an IoU threshold only by chance).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fai_detr import NUM_CLASSES, SIZE, _perturb, _tiny_configs
from test_torch_rtmo import SIZE as RTMO_SIZE
from test_torch_rtmo import TINY as RTMO_TINY
from test_torch_rtmo import _outputs
from test_torch_rtmo import _perturb as _perturb_rtmo
from test_torch_fai_detr import _flat
from test_torch_checkpoint import few_threads  # noqa: F401 (a fixture)

from focoos_tpu.model_manager import ModelManager as JaxModelManager
from focoos_tpu.models.rtmo.config import RTMOConfig as JaxRTMOConfig
from focoos_tpu.models.rtmo.processor import RTMOProcessor as JaxRTMOProcessor
from focoos_tpu.nn.backbone.csp_darknet import CSPConfig as JaxCSPConfig
from focoos_tpu.ports import ArtifactName, DatasetEntry as JaxDatasetEntry, ModelFamily, ModelInfo, Task
from focoos_tpu.structures import Boxes as JaxBoxes
from focoos_tpu.structures import Instances as JaxInstances
from focoos_tpu.structures import Keypoints as JaxKeypoints
from focoos_tpu.trainer.evaluation import evaluate_dataset as jax_evaluate_dataset
from focoos_tpu.trainer.evaluation.evaluators import DetectionEvaluator as JaxDetectionEvaluator
from focoos_tpu.trainer.evaluation.evaluators import KeypointEvaluator as JaxKeypointEvaluator
from focoos_tpu.utils.checkpoint import save_variables_npz, unflatten_tree
from focoos_tpu.utils.torch_convert import convert_state_dict
from focoos_tpu_torch.model_manager import ModelManager
from focoos_tpu_torch.models.fai_detr.modelling import FAIDetr
from focoos_tpu_torch.models.rtmo.config import RTMOConfig
from focoos_tpu_torch.models.rtmo.processor import RTMOProcessor
from focoos_tpu_torch.nn.backbone.csp_darknet import CSPConfig
from focoos_tpu_torch.nn.backbone.resnet import ResNet
from focoos_tpu_torch.ports import DatasetEntry, TrainerArgs
from focoos_tpu_torch.structures import Boxes, Instances, Keypoints
from focoos_tpu_torch.trainer.evaluation import evaluate_dataset, get_evaluator
from focoos_tpu_torch.trainer.evaluation.evaluators import DetectionEvaluator, KeypointEvaluator
from focoos_tpu_torch.trainer.trainer import FocoosTrainer

EVAL_TOL = 1e-9
POST_TOL = 1e-4
AP_TOL = 1e-3

pytestmark = pytest.mark.usefixtures("few_threads")


def _entry(jax_package: bool, image, h, w, boxes, classes, crowd=None, kpts=None):
    """A DatasetEntry of either package holding the same ground truth."""
    entry_cls, inst_cls, boxes_cls, kpts_cls = (
        (JaxDatasetEntry, JaxInstances, JaxBoxes, JaxKeypoints) if jax_package
        else (DatasetEntry, Instances, Boxes, Keypoints))
    fields = dict(boxes=boxes_cls(np.asarray(boxes, np.float32).reshape(-1, 4)), classes=np.asarray(classes, np.int64))
    if crowd is not None:
        fields["iscrowd"] = np.asarray(crowd, np.int64)
    if kpts is not None:
        fields["keypoints"] = kpts_cls(kpts)
    return entry_cls(image=image, height=h, width=w, instances=inst_cls((h, w), **fields))


def _assert_results_equal(got: dict, ref: dict, tol: float):
    assert sorted(got) == sorted(ref)
    for task in ref:
        assert sorted(got[task]) == sorted(ref[task]), task
        for k, r in ref[task].items():
            g = got[task][k]
            assert (g == -1.0) == (r == -1.0), f"{task}/{k}: {g} vs {r} (-1 marks a slice without ground truth)"
            assert abs(g - r) <= tol, f"{task}/{k}: {g} vs {r}"


# --------------------------------------------------------------------------- evaluators
def _random_boxes(rng, n, h, w):
    """n xyxy boxes from 4 to 150 px a side: small, medium and large areas."""
    wh = rng.uniform(4, 150, (n, 2))
    xy = rng.uniform(0, 1, (n, 2)) * (np.array([w, h]) - wh)
    return np.concatenate([xy, xy + wh], 1)


def _det_case(seed, n_classes=5, n_images=6, h=200, w=240):
    """Ground truth and detections: crowd boxes; the last class has no
    ground truth (but detections); image 2 has no ground truth; detections
    jitter some GT boxes, with wrong classes and random boxes mixed in."""
    rng = np.random.default_rng(seed)
    gts, dets = [], []
    for i in range(n_images):
        g = 0 if i == 2 else int(rng.integers(1, 9))
        boxes = _random_boxes(rng, g, h, w)
        classes = rng.integers(0, n_classes - 1, g)
        crowd = (rng.random(g) < 0.2).astype(np.int64)
        gts.append((boxes, classes, crowd))
        hit = boxes[rng.random(g) < 0.7]
        jitter = hit + rng.normal(0, 6, hit.shape)
        d_boxes = np.concatenate([jitter, _random_boxes(rng, int(rng.integers(0, 6)), h, w)])
        d_boxes[:, 2:] = np.maximum(d_boxes[:, 2:], d_boxes[:, :2] + 1)
        d_classes = np.concatenate([classes[: len(hit)] if len(hit) else np.zeros(0, np.int64),
                                    rng.integers(0, n_classes, len(d_boxes) - len(hit))])
        flip = rng.random(len(d_classes)) < 0.15
        d_classes = np.where(flip, rng.integers(0, n_classes, len(d_classes)), d_classes)
        dets.append((d_boxes, rng.uniform(0.05, 1.0, len(d_boxes)), d_classes))
    return gts, dets, (h, w)


def _kpt_case(seed, n_images=5, h=160, w=200, k=17):
    """People with 17 keypoints: visibility 0, 1 or 2 (some people with none
    visible), a crowd box, image 1 without ground truth; detections are the
    keypoints moved by a few pixels, plus strays."""
    rng = np.random.default_rng(seed)
    gts, dets = [], []
    for i in range(n_images):
        g = 0 if i == 1 else int(rng.integers(1, 6))
        boxes = _random_boxes(rng, g, h, w)
        kx = rng.uniform(boxes[:, None, 0], boxes[:, None, 2], (g, k))
        ky = rng.uniform(boxes[:, None, 1], boxes[:, None, 3], (g, k))
        vis = rng.choice([0, 1, 2], (g, k), p=[0.3, 0.2, 0.5]).astype(np.float64)
        if g > 1:
            vis[-1] = 0  # a person with no visible keypoint
        kpts = np.stack([kx, ky, vis], -1)
        crowd = (rng.random(g) < 0.15).astype(np.int64)
        gts.append((boxes, np.zeros(g, np.int64), crowd, kpts))
        n_stray = int(rng.integers(0, 3))
        d_kpts = np.concatenate([kpts[..., :2] + rng.normal(0, 3, (g, k, 2)), rng.uniform(0, min(h, w), (n_stray, k, 2))])
        d_kpts = np.concatenate([d_kpts, rng.random((g + n_stray, k, 1))], -1)
        d_boxes = np.concatenate([boxes + rng.normal(0, 3, boxes.shape), _random_boxes(rng, n_stray, h, w)])
        d_boxes[:, 2:] = np.maximum(d_boxes[:, 2:], d_boxes[:, :2] + 1)
        dets.append((d_boxes, rng.uniform(0.05, 1.0, g + n_stray), np.zeros(g + n_stray, np.int64), d_kpts))
    return gts, dets, (h, w)


def _outputs_of(jax_package, dets, hw, keypoints=False):
    inst_cls, boxes_cls = (JaxInstances, JaxBoxes) if jax_package else (Instances, Boxes)
    out = []
    for d in dets:
        fields = dict(boxes=boxes_cls(np.asarray(d[0], np.float32).reshape(-1, 4)), scores=np.asarray(d[1], np.float32),
                      classes=np.asarray(d[2], np.int64))
        if keypoints:
            fields["keypoints"] = np.asarray(d[3], np.float32).reshape(-1, 17, 3)
        out.append({"instances": inst_cls(hw, **fields)})
    return out


def _run(evaluator, entries, outputs, split=2):
    evaluator.reset()
    for i in range(0, len(entries), split):
        evaluator.process(entries[i:i + split], outputs[i:i + split])
    return evaluator.evaluate()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_evaluator_matches_jax(seed):
    names = [f"c{i}" for i in range(5)]
    gts, dets, (h, w) = _det_case(seed)
    ref = _run(JaxDetectionEvaluator(names, 5),
               [_entry(True, None, h, w, b, c, cr) for b, c, cr in gts], _outputs_of(True, dets, (h, w)))
    got = _run(DetectionEvaluator(names, 5),
               [_entry(False, None, h, w, b, c, cr) for b, c, cr in gts], _outputs_of(False, dets, (h, w)))
    _assert_results_equal(got, ref, EVAL_TOL)
    assert 0 < got["bbox"]["AP"] < 100 and "AP-c4" not in got["bbox"]  # no ground truth: no AP, not 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keypoint_evaluator_matches_jax(seed):
    gts, dets, (h, w) = _kpt_case(seed)
    ref = _run(JaxKeypointEvaluator(["person"]), [_entry(True, None, h, w, b, c, cr, k) for b, c, cr, k in gts],
               _outputs_of(True, dets, (h, w), keypoints=True))
    got = _run(KeypointEvaluator(["person"]), [_entry(False, None, h, w, b, c, cr, k) for b, c, cr, k in gts],
               _outputs_of(False, dets, (h, w), keypoints=True))
    _assert_results_equal(got, ref, EVAL_TOL)
    assert 0 < got["keypoints"]["AP"] < 100


@pytest.mark.parametrize("task", ["bbox", "keypoints"])
def test_oracle_predictions_score_100(task):
    """Detections equal to the ground truth (no crowd) score AP 100."""
    if task == "bbox":
        gts, _, (h, w) = _det_case(5)
        entries = [_entry(False, None, h, w, b, c) for b, c, _ in gts]
        outputs = _outputs_of(False, [(b, np.linspace(1, 0.5, len(b)), c) for b, c, _ in gts], (h, w))
        evaluator = get_evaluator(Task.DETECTION, 5, [f"c{i}" for i in range(5)])
    else:
        gts, _, (h, w) = _kpt_case(5)
        for _, _, _, k in gts:
            k[(k[..., 2] > 0).sum(-1) == 0, 0, 2] = 2  # each person has a visible keypoint (see the next test)
        entries = [_entry(False, None, h, w, b, c, None, k) for b, c, _, k in gts]
        dets = [(b, np.linspace(1, 0.5, len(b)), c, np.concatenate([k[..., :2], np.ones_like(k[..., :1])], -1))
                for b, c, _, k in gts]
        outputs = _outputs_of(False, dets, (h, w), keypoints=True)
        evaluator = get_evaluator(Task.KEYPOINT, 1, ["person"])
    res = _run(evaluator, entries, outputs)[task]
    assert res["AP"] == pytest.approx(100.0) and res["AP50"] == pytest.approx(100.0)


def test_keypoint_gt_without_visible_keypoints_counts_as_a_miss():
    """A fault of the reference, kept for parity (ROADMAP Queue 3): COCOeval
    ignores a person with no visible keypoint (``num_keypoints == 0``); the
    JAX package's evaluator counts it as a positive that no detection can
    match (OKS 0), and so does the port's. Two people, one without visible
    keypoints, detected exactly: AP 50.5 in both packages where COCO gives 100."""
    kpts = np.zeros((2, 17, 3))
    kpts[..., 0], kpts[..., 1] = np.arange(17) * 5 + 10, 40.0
    kpts[0, :, 2] = 2
    boxes = np.array([[5, 20, 100, 60], [110, 20, 190, 60]], np.float64)
    dets = [(boxes, np.array([0.9, 0.8]), np.zeros(2, np.int64), np.concatenate([kpts[..., :2], np.ones((2, 17, 1))], -1))]
    res = []
    for jax_package, evaluator in ((True, JaxKeypointEvaluator(["person"])), (False, KeypointEvaluator(["person"]))):
        entries = [_entry(jax_package, None, 100, 200, boxes, np.zeros(2, np.int64), None, kpts)]
        res.append(_run(evaluator, entries, _outputs_of(jax_package, dets, (100, 200), keypoints=True))["keypoints"])
    assert res[0]["AP"] == res[1]["AP"] == pytest.approx(50.495049504950494)


def test_get_evaluator_refuses_the_tasks_not_ported():
    """Every Task has its evaluator since fai_cls's landed; the panoptic
    task, which has none yet (ROADMAP Queue 1 item 7), is refused."""
    assert all(get_evaluator(task, 3) is not None for task in Task)
    with pytest.raises(ValueError, match="No evaluator"):
        get_evaluator("panoptic", 3)


# --------------------------------------------------------------------------- rtmo eval_postprocess
@pytest.mark.parametrize("image_size", [None, 256], ids=["own-frame", "resized"])
def test_rtmo_eval_postprocess_matches_jax(image_size):
    """The same model arrays → the same Instances: boxes clipped to each
    entry's original size, keypoints [x, y, vis], only score > 0 kept."""
    k = 3
    jcfg = JaxRTMOConfig(num_classes=2, num_keypoints=k, backbone_config=JaxCSPConfig())
    pcfg = RTMOConfig(num_classes=2, num_keypoints=k, backbone_config=CSPConfig())
    jout, pout = _outputs(np.random.default_rng(19), 2, 6, k)
    imgs = [np.zeros((128, 96, 3), np.uint8), np.zeros((64, 256, 3), np.uint8)]
    sizes = [(256, 192), (100, 300)]  # original (h, w): the entries' images were resized from these
    jents = [JaxDatasetEntry(image=im, height=h, width=w) for im, (h, w) in zip(imgs, sizes)]
    pents = [DatasetEntry(image=im, height=h, width=w) for im, (h, w) in zip(imgs, sizes)]
    want = JaxRTMOProcessor(jcfg, image_size).eval_postprocess(jout, jents)
    got = RTMOProcessor(pcfg, image_size).eval_postprocess(pout, pents)
    assert sum(len(r["instances"]) for r in got) > 0
    for g, w_ in zip(got, want):
        gi, wi = g["instances"], w_["instances"]
        assert gi.image_size == wi.image_size and len(gi) == len(wi)
        np.testing.assert_array_equal(gi.boxes.tensor, wi.boxes.tensor)
        for f in ("scores", "classes", "keypoints"):
            np.testing.assert_array_equal(gi.get(f), np.asarray(wi.get(f)), err_msg=f)


# --------------------------------------------------------------------------- evaluate_dataset, model against model
def _run_dir(path, family, name, task, classes, im_size, config, flat):
    info = ModelInfo(name=name, model_family=family, classes=classes, im_size=im_size, task=task, config=config)
    info.dump_json(str(path))
    save_variables_npz(os.path.join(path, ArtifactName.WEIGHTS.value), unflatten_tree(flat))
    return str(path)


@pytest.fixture(scope="module")
def detr_models(tmp_path_factory):
    """Both packages' tiny fai-detr on one model_final.npz: the port's seeded
    init carried into the JAX tree by torch_convert and perturbed there."""
    jcfg, pcfg = _tiny_configs()
    port = FAIDetr(pcfg, ResNet(pcfg.backbone_config))
    port.init_weights(torch.Generator().manual_seed(0))
    tree, _ = convert_state_dict({k: v.numpy() for k, v in port.state_dict().items()}, "fai_detr", verbose=False)
    flat = _perturb(_flat(tree), seed=0)
    run_dir = _run_dir(tmp_path_factory.mktemp("detr"), ModelFamily.DETR, "tiny-detr", Task.DETECTION,
                       [f"c{i}" for i in range(NUM_CLASSES)], SIZE, jcfg.to_dict(), flat)
    return JaxModelManager.get(run_dir), ModelManager.get(run_dir, device="cpu")


@pytest.fixture(scope="module")
def rtmo_models(tmp_path_factory):
    """Both packages' tiny rtmo-s on one model_final.npz (perturbed as tests/test_torch_rtmo.py's)."""
    pm = ModelManager.get("rtmo-s-coco", device="cpu", image_size=RTMO_SIZE, **RTMO_TINY)
    tree, _ = convert_state_dict({k: v.numpy() for k, v in pm.module.state_dict().items()}, "rtmo", verbose=False)
    flat = _perturb_rtmo(_flat(tree), seed=0)
    run_dir = _run_dir(tmp_path_factory.mktemp("rtmo"), ModelFamily.RTMO, "tiny-rtmo", Task.KEYPOINT, ["person"],
                       RTMO_SIZE, pm.model_info.config, flat)
    return JaxModelManager.get(run_dir), ModelManager.get(run_dir, device="cpu")


def _images(seed, n, size):
    return [np.random.default_rng(seed + i).integers(0, 256, (size, size, 3), dtype=np.uint8) for i in range(n)]


def _assert_instances_close(got, want, coord_tol: float):
    """Per image: the same detections (count, classes), scores within
    POST_TOL, boxes and keypoint coordinates within ``coord_tol`` (keypoint
    scores within POST_TOL)."""
    for g, w in zip(got, want):
        gi, wi = g["instances"], w["instances"]
        assert len(gi) == len(wi) > 0
        np.testing.assert_array_equal(np.asarray(gi.classes), np.asarray(wi.classes))
        np.testing.assert_allclose(gi.boxes.tensor, wi.boxes.tensor, rtol=0, atol=coord_tol)
        np.testing.assert_allclose(np.asarray(gi.scores), np.asarray(wi.scores), rtol=0, atol=POST_TOL)
        if wi.has("keypoints"):
            gk, wk = gi.keypoints, np.asarray(wi.keypoints)
            np.testing.assert_allclose(gk[..., :2], wk[..., :2], rtol=0, atol=coord_tol)
            np.testing.assert_allclose(gk[..., 2], wk[..., 2], rtol=0, atol=POST_TOL)


def _postprocessed(model, entries, batch=2):
    """eval_postprocess of a model's forwards, ``batch`` entries at a time (one compiled shape for JAX)."""
    out = []
    for i in range(0, len(entries), batch):
        part = entries[i:i + batch]
        out += model.processor.eval_postprocess(model.forward(np.stack([e.image for e in part])), part)
    return out


def test_detr_evaluate_dataset_matches_jax(detr_models):
    """eval_postprocess of both forwards agree per image; then both packages'
    evaluate_dataset at batch 2 over 4 images against pseudo-GT: JAX's own
    detections of rank 2-9 on each image (its top two are false positives),
    and an image without GT."""
    jm, pm = detr_models
    imgs = _images(30, 4, SIZE)
    want = _postprocessed(jm, [JaxDatasetEntry(image=im, height=SIZE, width=SIZE) for im in imgs])
    got = _postprocessed(pm, [DatasetEntry(image=im, height=SIZE, width=SIZE) for im in imgs])
    _assert_instances_close(got, want, POST_TOL)

    gt = []
    for i, w in enumerate(want):
        inst = w["instances"]
        order = np.argsort(-np.asarray(inst.scores), kind="stable")[2:10] if i != 3 else np.zeros(0, np.int64)
        gt.append((inst.boxes.tensor[order], np.asarray(inst.classes)[order]))
    ref = jax_evaluate_dataset(jm, [_entry(True, im, SIZE, SIZE, b, c) for im, (b, c) in zip(imgs, gt)], batch_size=2)
    res = evaluate_dataset(pm, [_entry(False, im, SIZE, SIZE, b, c) for im, (b, c) in zip(imgs, gt)], batch_size=2)
    _assert_results_equal(res, ref, AP_TOL)
    assert 0 < res["bbox"]["AP"] < 100


def test_rtmo_evaluate_dataset_matches_jax(rtmo_models):
    """The keypoint path: rtmo-s's eval_postprocess per image, then
    evaluate_dataset against pseudo-GT from JAX's detections (all but each
    image's top one; keypoints visible where JAX's keypoint score > 0.5)."""
    jm, pm = rtmo_models
    imgs = _images(40, 4, RTMO_SIZE)
    want = _postprocessed(jm, [JaxDatasetEntry(image=im, height=RTMO_SIZE, width=RTMO_SIZE) for im in imgs])
    got = _postprocessed(pm, [DatasetEntry(image=im, height=RTMO_SIZE, width=RTMO_SIZE) for im in imgs])
    # rtmo's pixel coordinates as tests/test_torch_rtmo.py holds them: 1e-4 x max|ref|
    _assert_instances_close(got, want, POST_TOL * max(float(np.abs(w["instances"].boxes.tensor).max()) for w in want))

    gt = []
    for w in want:
        inst = w["instances"]
        order = np.argsort(-np.asarray(inst.scores), kind="stable")[1:]
        # boxes clipped to a sliver have ~0 area, and OKS over a 0 area is 1 for exactly equal
        # keypoints and 0 otherwise: such people are left out of the ground truth
        b = inst.boxes.tensor[order]
        order = order[(b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]) >= 64]
        kp = np.asarray(inst.keypoints)[order]
        gt.append((inst.boxes.tensor[order], np.zeros(len(order), np.int64),
                   np.concatenate([kp[..., :2], 2.0 * (kp[..., 2:] > 0.5)], -1)))
    assert sum(len(b) for b, _, _ in gt) >= 8
    assert any((k[..., 2] == 0).any() for _, _, k in gt) and any((k[..., 2] > 0).any() for _, _, k in gt)
    ref = jax_evaluate_dataset(jm, [_entry(True, im, RTMO_SIZE, RTMO_SIZE, b, c, None, k)
                                    for im, (b, c, k) in zip(imgs, gt)], batch_size=2)
    res = evaluate_dataset(pm, [_entry(False, im, RTMO_SIZE, RTMO_SIZE, b, c, None, k)
                                for im, (b, c, k) in zip(imgs, gt)], batch_size=2)
    _assert_results_equal(res, ref, AP_TOL)
    assert 0 < res["keypoints"]["AP"] < 100


# --------------------------------------------------------------------------- FocoosModel.eval, training with validation
def _train_entries(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 6))
        boxes = _random_boxes(rng, k, SIZE, SIZE) * 0.5
        out.append(_entry(False, rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8), SIZE, SIZE, boxes,
                          rng.integers(0, NUM_CLASSES, k)))
    return out


def test_focoos_model_eval_matches_evaluate_dataset(detr_models):
    _, pm = detr_models
    val = _train_entries(3, 7)
    res = pm.eval(TrainerArgs(run_name="e", batch_size=2), val)
    assert res == evaluate_dataset(pm, val, batch_size=2) and set(res) == {"bbox"}


def test_trainer_validates_during_training(tmp_path):
    """FocoosModel.train with a val_dataset: bbox/AP logged at each eval
    period and at the end, model_best saved, the final (EMA) weights' metrics
    returned and written into model_info.json; the module trains again after
    each validation (no inference tensor reaches autograd) and leaves no cast
    copy of its weights behind."""
    model = ModelManager.get(  # 64-wide encoder and decoder: each checkpoint ~0.2 GB
        "fai-detr-l-coco", device="cpu", image_size=SIZE, num_queries=20, transformer_predictor_dec_layers=2,
        num_classes=NUM_CLASSES, pixel_decoder_feat_dim=64, pixel_decoder_out_dim=64, pixel_decoder_dim_feedforward=128,
        transformer_predictor_hidden_dim=64, transformer_predictor_out_dim=64, transformer_predictor_dim_feedforward=128,
        head_out_dim=64, backbone_config={"model_type": "resnet", "depth": 18, "variant": "d", "freeze_norm": False},
    )
    args = TrainerArgs(run_name="v", output_dir=str(tmp_path), batch_size=2, max_iters=2, eval_period=1, log_period=1,
                       workers_timeout=120,
                       checkpointer_period=10, samples=1, ema_enabled=True, max_instances_per_image=5)
    trainer = FocoosTrainer(model, args, _train_entries(2, 0), _train_entries(3, 1))
    res = trainer.train()
    assert res["iterations"] == 2 and "AP" in res["metrics"]["bbox"]
    assert [i for _, i in trainer.loop.storage.history("bbox/AP").values()] == [0, 1]  # after step 0 and at the end
    with open(os.path.join(res["run_dir"], "metrics.json")) as f:
        assert "bbox/AP" in [json.loads(line) for line in f][-1]
    with open(os.path.join(res["run_dir"], "model_info.json")) as f:
        info = json.load(f)
    assert info["status"] == "TRAINING_COMPLETED" and info["val_metrics"]["bbox/AP"] == res["metrics"]["bbox"]["AP"]
    ckpt = os.path.join(res["run_dir"], "ckpt")
    assert {"model_best", "model_final", "last_checkpoint"} <= set(os.listdir(ckpt))
    assert not any("_cast_cache" in m.__dict__ for m in model.module.modules())
    assert evaluate_dataset(model, _train_entries(3, 1), batch_size=1) == res["metrics"]  # the final weights


# --------------------------------------------------------------------------- a resized record's two frames
def _write_640x480_record(root: str, keypoints: bool) -> str:
    """One 640x480 (width x height, COCO's most common size) Roboflow-COCO val
    record: two boxes, or two people with 17 keypoints."""
    import cv2

    d = os.path.join(root, "valid")
    os.makedirs(d)
    cv2.imwrite(os.path.join(d, "img.jpg"), np.full((480, 640, 3), 90, np.uint8))
    rng = np.random.default_rng(0)
    anns = []
    for i, (x, y, w, h) in enumerate([(60, 50, 200, 300), (380, 120, 180, 240)]):
        ann = dict(id=i + 1, image_id=0, category_id=1 if keypoints else i + 1, bbox=[x, y, w, h], area=w * h, iscrowd=0)
        if keypoints:
            ann["keypoints"] = [v for _ in range(17) for v in (int(rng.integers(x, x + w)), int(rng.integers(y, y + h)), 2)]
            ann["num_keypoints"] = 17
        anns.append(ann)
    cats = ([dict(id=0, name="people", supercategory="none"), dict(id=1, name="person", supercategory="people",
                                                                    keypoints=[f"kp{j}" for j in range(17)])]
            if keypoints else [dict(id=0, name="shapes", supercategory="none")]
            + [dict(id=c, name=f"c{c}", supercategory="shapes") for c in (1, 2)])
    with open(os.path.join(d, "_annotations.coco.json"), "w") as f:
        json.dump(dict(images=[dict(id=0, file_name="img.jpg", height=480, width=640)], annotations=anns,
                       categories=cats), f)
    return root


@pytest.mark.parametrize("task", ["detection", "keypoint"])
def test_resized_record_is_scored_across_two_frames(task, tmp_path):
    """ROADMAP Queue 3, pinned: the preset's val augmentation at 640 resizes a
    640x480 record (detection: squashed to 640x640; keypoints: 853x640), the
    evaluators take the mapped entry's ground truth in that frame, and
    ``eval_postprocess`` scales predictions to the record's original frame
    (JAX evaluators.py:72-95, port evaluators.py:57). A model that predicts
    the ground truth exactly therefore scores the AP pinned here in both
    packages, not 100; the same predictions in the mapped frame score 100."""
    from focoos_tpu.data.auto_dataset import AutoDataset as JaxAutoDataset
    from focoos_tpu.data.default_aug import get_default_by_task as jax_get_default_by_task
    from focoos_tpu.ports import DatasetSplitType as JaxSplit
    from focoos_tpu.ports import Task as JaxTask
    from focoos_tpu_torch.data.auto_dataset import AutoDataset
    from focoos_tpu_torch.data.default_aug import get_default_by_task
    from focoos_tpu_torch.ports import DatasetSplitType
    from focoos_tpu_torch.ports import Task as PortTask

    root = _write_640x480_record(str(tmp_path), task == "keypoint")
    pinned = {"detection": (("bbox", 30.0),), "keypoint": (("keypoints", 0.0),)}[task]
    mapped_hw = {"detection": (640, 640), "keypoint": (640, 853)}[task]
    results = {}
    for pkg in ("jax", "port"):
        jax_package = pkg == "jax"
        if jax_package:
            augs = jax_get_default_by_task(JaxTask(task), 640)[1]
            entry = JaxAutoDataset(root, task=task).get_split(augs, split=JaxSplit.VAL)[0]
            ev = JaxKeypointEvaluator(["person"]) if task == "keypoint" else JaxDetectionEvaluator(["c1", "c2"], 2)
        else:
            augs = get_default_by_task(PortTask(task), 640)[1]
            entry = AutoDataset(root, task=task).get_split(augs, split=DatasetSplitType.VAL)[0]
            ev = KeypointEvaluator(["person"]) if task == "keypoint" else DetectionEvaluator(["c1", "c2"], 2)
        # the two frames: the mapped image and its ground truth, against the record's size
        assert entry.image.shape[:2] == mapped_hw and (entry.height, entry.width) == (480, 640)
        gt = entry.instances
        sy, sx = mapped_hw[0] / 480, mapped_hw[1] / 640
        np.testing.assert_allclose(gt.boxes.tensor[0], [60 * sx, 50 * sy, 260 * sx, 350 * sy], rtol=1e-5)
        kpts = np.asarray(gt.keypoints.tensor) if task == "keypoint" else None
        original = np.asarray(gt.boxes.tensor) / np.array([sx, sy, sx, sy], np.float32)
        for frame, boxes, scale in (("original", original, (sx, sy)), ("mapped", np.asarray(gt.boxes.tensor), (1, 1))):
            det = [boxes, np.array([0.9, 0.8]), np.asarray(gt.classes)]
            if kpts is not None:
                det.append(np.concatenate([kpts[..., :2] / np.array(scale), np.ones_like(kpts[..., :1])], -1))
            results[(pkg, frame)] = _run(ev, [entry], _outputs_of(jax_package, [det], (480, 640), task == "keypoint"))
    for metric, ap in pinned:
        for pkg in ("jax", "port"):
            assert results[(pkg, "original")][metric]["AP"] == pytest.approx(ap, abs=1e-9), (pkg, results[(pkg, "original")])
            assert results[(pkg, "mapped")][metric]["AP"] == pytest.approx(100.0)
