"""Port parity for the rtmo keypoint serving slice: the port (focoos_tpu_torch)
and the JAX package run the same numpy weights and inputs on the CPU, in fp32.

Weights cross over through ``focoos_tpu_torch.utils.weights.from_jax_variables``.
What random init leaves degenerate is perturbed first: BatchNorm statistics and
norm scales are random, biases nudged, the classifier bias is 0 (scores spread
over (0, 1), not all at 0.01) and the box-size bias is log(6) (boxes six
strides wide, so neighbouring anchors overlap and NMS suppresses). DCC's GAU
output projection is scaled by 0.05 and its bin projections by 0.01: at init
its bin logits reach ~4e3 and the heatmap softmax is one-hot, so a keypoint
jumps a whole bin on a one-ulp logit difference, which compares nothing.

Tolerances, fp32 both sides: 1e-4 absolute on raw head outputs and features
(× max|ref| for the backbone's deep features), 1e-5 on sigmoid scores, 1e-4 ×
max|ref| on absolute-pixel boxes and keypoints.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_checkpoint import few_threads_module  # noqa: F401 (an autouse fixture: two threads throughout)

from focoos_tpu.model_manager import BackboneManager as JaxBackboneManager
from focoos_tpu.model_manager import ConfigManager as JaxConfigManager
from focoos_tpu.models.rtmo.modelling import RTMO as JaxRTMO
from focoos_tpu.models.rtmo.modelling import DCC as JaxDCC
from focoos_tpu.models.rtmo.modelling import RTMOHeadModule as JaxHead
from focoos_tpu.models.rtmo.modelling import RTMOHybridEncoder as JaxNeck
from focoos_tpu.models.rtmo.ports import RTMOModelOutput as JaxRTMOModelOutput
from focoos_tpu.models.rtmo.processor import RTMOProcessor as JaxRTMOProcessor
from focoos_tpu.nn.backbone.csp_darknet import CSPConfig as JaxCSPConfig
from focoos_tpu.nn.backbone.csp_darknet import CSPDarknet as JaxCSPDarknet
from focoos_tpu.nn.backbone.csp_darknet import ConvModule as JaxConvModule
from focoos_tpu.models.rtmo.modelling import ProjectionConv as JaxProjectionConv
from focoos_tpu.ports import ArtifactName
from focoos_tpu.utils.checkpoint import flatten_tree, save_variables_npz, unflatten_tree
from focoos_tpu.utils.torch_convert import convert_state_dict
from focoos_tpu_torch.model_manager import ModelManager
from focoos_tpu_torch.models.rtmo.modelling import DCC, RTMOHeadModule, RTMOHybridEncoder
from focoos_tpu_torch.models.rtmo.ports import RTMOModelOutput
from focoos_tpu_torch.models.rtmo.processor import RTMOProcessor
from focoos_tpu_torch.models.rtmo.modelling import ProjectionConv
from focoos_tpu_torch.nn.backbone.csp_darknet import CSPConfig, CSPDarknet, ConvModule
from focoos_tpu_torch.ops.nms import topk_nms
from focoos_tpu_torch.utils.weights import from_jax_variables

SIZE = 128
TINY = dict(transformer_encoder_layers=1, nms_pre_topk=50, max_detections=10)  # tests/test_model_families.py:19
AUX_TOL = 1e-4
SCORE_TOL = 1e-5
COORD_TOL = 1e-4  # × max|ref|


def _flat(variables):
    out = {}
    for collection, tree in variables.items():
        out.update(flatten_tree(tree, prefix=f"{collection}/"))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _perturb(flat, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        if k.endswith("/var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith("/mean"):
            v = rng.normal(0.0, 0.1, v.shape)
        elif k.endswith("/scale"):
            v = rng.uniform(0.8, 1.2, v.shape)
        elif "/out_cls_" in k and k.endswith("/bias"):
            v = np.zeros(v.shape)
        elif "/out_bbox_" in k and k.endswith("/bias"):
            v = np.array([0.0, 0.0, np.log(6.0), np.log(6.0)]) + rng.normal(0.0, 0.05, v.shape)
        elif k.endswith("/bias"):
            v = v + rng.normal(0.0, 0.02, v.shape)
        elif k.endswith("dcc/gau/o/kernel"):
            v = v * 0.05
        elif k.endswith(("dcc/x_fc/kernel", "dcc/y_fc/kernel")):
            v = v * 0.01
        out[k] = np.asarray(v, np.float32)
    return out


def _load_sub(module, flat, jax_prefix, torch_prefix):
    """Load a sub-module's JAX variables (paths without the model's prefix)
    through the rtmo rules, then strip the model's torch prefix."""
    full = {f"{k.split('/', 1)[0]}/{jax_prefix}/{k.split('/', 1)[1]}": v for k, v in flat.items()}
    sd = {k[len(torch_prefix):]: v for k, v in from_jax_variables(full, "rtmo").items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def tiny_rtmo():
    """rtmo-s-coco at 128² (the tests/test_model_families.py tiny config): the
    port model from its seeded init, carried into the JAX tree by
    ``torch_convert`` and perturbed there; the JAX module and its outputs on
    two images; the port model loaded back with the perturbed weights."""
    pm = ModelManager.get("rtmo-s-coco", device="cpu", image_size=SIZE, **TINY)
    jcfg = JaxConfigManager.from_dict("rtmo", pm.model_info.config)
    jmodule = JaxRTMO(config=jcfg, backbone=JaxBackboneManager.from_config(jcfg.backbone_config))
    tree, unmatched = convert_state_dict({k: v.numpy() for k, v in pm.module.state_dict().items()}, "rtmo", verbose=False)
    assert unmatched == []
    flat = _perturb(_flat(tree), seed=0)
    pm.module.load_state_dict(from_jax_variables(flat, "rtmo"), strict=True)
    x = np.random.default_rng(1).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    jout, jaux = jax.jit(jmodule.apply)(unflatten_tree(flat), jnp.asarray(x))
    return jmodule, flat, pm, x, jout, jaux


def test_csp_darknet_small_features_match_jax():
    """res2–res5 on carried weights at 128²: the Focus space-to-depth concat +
    3x3 conv against the JAX package's folded 6x6 stride-2 conv."""
    jmodel = JaxCSPDarknet(config=JaxCSPConfig(size="small"))
    x = np.random.default_rng(2).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    flat = _perturb(_flat(jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(x[:1]))), seed=3)
    ref = jax.jit(jmodel.apply)(unflatten_tree(flat), jnp.asarray(x))
    port = CSPDarknet(CSPConfig(size="small"))
    port.load_state_dict(from_jax_variables(flat, "csp_darknet"), strict=True)
    with torch.inference_mode():
        got = port.eval()(_nchw(x))
    assert sorted(got) == sorted(ref) == ["res2", "res3", "res4", "res5"]
    for k in ref:
        r = np.asarray(ref[k])
        g = _nhwc(got[k])
        assert g.shape == r.shape, k
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=k)


def test_csp_layer_with_channel_attention_matches_jax():
    """No registry config turns channel_attention on; the layer is ported
    whole all the same (GAP → 1x1 conv → hard-sigmoid gate)."""
    from focoos_tpu.nn.backbone.csp_darknet import CSPLayer as JaxCSPLayer
    from focoos_tpu_torch.nn.backbone.csp_darknet import CSPLayer

    x = np.random.default_rng(7).standard_normal((2, 12, 10, 32)).astype(np.float32)
    jmodel = JaxCSPLayer(48, num_blocks=2, channel_attention=True)
    flat = _perturb(_flat(jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.asarray(x))), seed=8)
    ref = jax.jit(jmodel.apply)(unflatten_tree(flat), jnp.asarray(x))
    full = {f"{k.split('/', 1)[0]}/stage1_csp/{k.split('/', 1)[1]}": v for k, v in flat.items()}
    port = CSPLayer(32, 48, num_blocks=2, channel_attention=True)
    port.load_state_dict({k[len("stage1.1."):]: v for k, v in from_jax_variables(full, "csp_darknet").items()}, strict=True)
    with torch.inference_mode():
        got = port.eval()(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=0, atol=AUX_TOL)


def test_neck_matches_jax(tiny_rtmo):
    jmodule, flat, pm, _, _, _ = tiny_rtmo
    cfg = jmodule.config
    rng = np.random.default_rng(4)
    feats = {k: rng.standard_normal((2, SIZE // s, SIZE // s, c)).astype(np.float32)
             for k, s, c in (("res3", 8, 128), ("res4", 16, 256), ("res5", 32, 512))}
    sub = {k.replace("/neck/", "/", 1): v for k, v in flat.items() if k.split("/")[1] == "neck"}
    ref = jax.jit(JaxNeck(cfg).apply)(unflatten_tree(sub), {k: jnp.asarray(v) for k, v in feats.items()})
    port = _load_sub(RTMOHybridEncoder(pm.config, [128, 256, 512]), sub, "neck", "neck.")
    with torch.inference_mode():
        got = port({k: _nchw(v) for k, v in feats.items()})
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), rtol=0, atol=AUX_TOL)


def test_head_matches_jax(tiny_rtmo):
    jmodule, flat, pm, _, _, _ = tiny_rtmo
    cfg = jmodule.config
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((2, SIZE // s, SIZE // s, cfg.output_dim)).astype(np.float32) for s in (16, 32)]
    sub = {k.replace("/head_module/", "/", 1): v for k, v in flat.items() if k.split("/")[1] == "head_module"}
    ref = jax.jit(JaxHead(cfg).apply)(unflatten_tree(sub), [jnp.asarray(x) for x in xs])
    port = _load_sub(RTMOHeadModule(pm.config, cfg.output_dim, 2), sub, "head_module", "head.head_module.")
    with torch.inference_mode():
        got = port([_nchw(x) for x in xs])
    for name, g_lv, r_lv in zip(("cls", "bbox", "kpt_reg", "kpt_vis", "pose"), got, ref):
        for g, r in zip(g_lv, r_lv):
            np.testing.assert_allclose(_nhwc(g), np.asarray(r), rtol=0, atol=AUX_TOL, err_msg=name)


def test_dcc_matches_jax(tiny_rtmo):
    jmodule, flat, pm, _, _, _ = tiny_rtmo
    cfg = jmodule.config
    rng = np.random.default_rng(6)
    b, d = 2, 7
    pose = rng.standard_normal((b, d, cfg.pose_vec_channels)).astype(np.float32)
    grids = rng.uniform(0, SIZE, (b, d, 2)).astype(np.float32)
    cs = np.concatenate([grids + rng.normal(0, 4, (b, d, 2)), rng.uniform(10, 60, (b, d, 2))], -1).astype(np.float32)
    sub = {k.replace("/dcc/", "/", 1): v for k, v in flat.items() if k.split("/")[1] == "dcc"}
    kp_r, (px_r, py_r), sig_r = jax.jit(JaxDCC(cfg).apply)(unflatten_tree(sub), *(jnp.asarray(a) for a in (pose, cs, grids)))
    port = _load_sub(DCC(pm.config, cfg.pose_vec_channels), sub, "dcc", "head.dcc.")
    with torch.inference_mode():
        kp, (px, py), sig = port(*(torch.from_numpy(a) for a in (pose, cs, grids)))
    np.testing.assert_allclose(kp.numpy(), np.asarray(kp_r), rtol=0, atol=COORD_TOL * np.abs(np.asarray(kp_r)).max())
    np.testing.assert_allclose(px.numpy(), np.asarray(px_r), rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(py.numpy(), np.asarray(py_r), rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(sig.numpy(), np.asarray(sig_r), rtol=0, atol=SCORE_TOL)


def _anchor_of(cand_boxes, sel_boxes):
    """Anchor index of each selected box: the candidate it equals [B, D]."""
    dist = np.abs(sel_boxes[:, :, None, :] - cand_boxes[:, None, :, :]).max(-1)  # [B, D, A]
    return dist.argmin(-1), dist.min(-1)


def test_rtmo_forward_matches_jax(tiny_rtmo):
    _, _, pm, x, jout, jaux = tiny_rtmo
    model = pm.module
    with torch.inference_mode():
        pout, paux = model(torch.from_numpy(x))
        cand, scores, _ = model.candidates(paux)
        cfg = model.config
        port_idx, port_valid, _ = topk_nms(cand, scores, cfg.nms_pre_topk, cfg.nms_thr, cfg.max_detections, cfg.score_thr)

    for field in ("cls_scores", "bbox_preds", "kpt_offsets", "kpt_vis", "pose_feats", "priors", "strides"):
        r, g = np.asarray(getattr(jaux, field)), getattr(paux, field).numpy()
        assert g.shape == r.shape, field
        np.testing.assert_allclose(g, r, rtol=0, atol=AUX_TOL, err_msg=field)

    # the same anchors selected, slot by slot (scores are distinct)
    valid = np.asarray(jout.scores) > 0
    np.testing.assert_array_equal(port_valid.numpy(), valid)
    np.testing.assert_array_equal(pout.scores.numpy() > 0, valid)
    assert valid.sum(1).min() > 0, "an image kept no detection: the case tests nothing"
    jax_idx, miss = _anchor_of(cand.numpy(), np.asarray(jout.boxes))
    assert miss[valid].max() < COORD_TOL * np.abs(cand.numpy()).max(), "a JAX detection matches no port anchor"
    np.testing.assert_array_equal(port_idx.numpy()[valid], jax_idx[valid])

    np.testing.assert_allclose(pout.scores.numpy(), np.asarray(jout.scores), rtol=0, atol=SCORE_TOL)
    for field in ("boxes", "keypoints"):
        r, g = np.asarray(getattr(jout, field))[valid], getattr(pout, field).numpy()[valid]
        np.testing.assert_allclose(g, r, rtol=0, atol=COORD_TOL * np.abs(r).max(), err_msg=field)
    for field in ("keypoints_scores", "boxes_scores"):
        r, g = np.asarray(getattr(jout, field))[valid], getattr(pout, field).numpy()[valid]
        np.testing.assert_allclose(g, r, rtol=0, atol=SCORE_TOL, err_msg=field)
    np.testing.assert_array_equal(pout.labels.numpy()[valid], np.asarray(jout.labels)[valid])


def test_nms_suppresses_in_the_tiny_forward(tiny_rtmo):
    """The perturbed boxes overlap: NMS keeps fewer candidates than are valid."""
    _, _, pm, x, _, _ = tiny_rtmo
    from focoos_tpu_torch.ops.nms import nms_keep, pre_topk

    cfg = pm.config
    with torch.inference_mode():
        _, paux = pm.module(torch.from_numpy(x))
        boxes, scores, _ = pm.module.candidates(paux)
        top_boxes, top_scores, _ = pre_topk(boxes, scores, cfg.nms_pre_topk, cfg.score_thr)
        keep = nms_keep(top_boxes, top_scores, cfg.nms_thr)
    assert (keep.sum(1) < (top_scores > 0).sum(1)).all()


def test_weights_roundtrip_through_torch_convert(tiny_rtmo):
    """torch_convert maps the port's state_dict onto exactly the JAX
    module's variable tree (every leaf, every shape, no key unmatched), and
    from_jax_variables maps it back, value for value."""
    jmodule, flat, pm, _, _, _ = tiny_rtmo
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    want = {k: v.shape for k, v in _flat(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)).items()}
    sd = {k: v.numpy() for k, v in pm.module.state_dict().items()}
    tree, unmatched = convert_state_dict(sd, "rtmo", verbose=False)
    assert unmatched == []
    back = _flat(tree)
    assert {k: v.shape for k, v in back.items()} == want
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    again = from_jax_variables(back, "rtmo")
    assert sorted(again) == sorted(pm.module.state_dict())
    for k, v in pm.module.state_dict().items():
        assert torch.equal(again[k], v), k


def test_model_manager_detections_match_jax(tiny_rtmo, tmp_path):
    """ModelManager.get(run_dir, device="cpu") on the JAX model_final.npz →
    model(images) gives the detections the JAX processor makes from the JAX
    forward: boxes and 17 keypoints as truncated ints, the same scores."""
    jmodule, flat, model, x, jout, _ = tiny_rtmo
    model.model_info.dump_json(str(tmp_path))
    save_variables_npz(os.path.join(tmp_path, ArtifactName.WEIGHTS.value), unflatten_tree(flat))
    pm = ModelManager.get(str(tmp_path), device="cpu")
    imgs = [x[0], x[1]]
    want = JaxRTMOProcessor(jmodule.config, SIZE).postprocess(jout, imgs, class_names=model.classes, threshold=0.0)
    got = pm(imgs, threshold=0.0)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert 0 < len(g) == len(w)
        for dg, dw in zip(g.detections, w.detections):
            assert dg.cls_id == dw.cls_id and dg.label == dw.label
            assert dg.conf == pytest.approx(dw.conf, abs=SCORE_TOL)
            assert len(dg.keypoints) == len(dw.keypoints) == 17
            # truncated to whole pixels: allow a truncation flip
            np.testing.assert_allclose(dg.bbox, dw.bbox, atol=1)
            np.testing.assert_allclose([k[:2] for k in dg.keypoints], [k[:2] for k in dw.keypoints], atol=1)
            np.testing.assert_allclose([k[2] for k in dg.keypoints], [k[2] for k in dw.keypoints], atol=SCORE_TOL)


def _outputs(rng, b, d, k):
    scores = np.where(rng.random((b, d)) < 0.6, rng.uniform(0.05, 1.0, (b, d)), 0.0).astype(np.float32)
    boxes = np.sort(rng.uniform(-20, 300, (b, d, 2, 2)), axis=2).reshape(b, d, 4)[..., [0, 2, 1, 3]].astype(np.float32)
    arrays = dict(
        scores=scores, labels=rng.integers(0, 2, (b, d)), boxes=boxes, boxes_scores=scores,
        keypoints=rng.uniform(-30, 320, (b, d, k, 2)).astype(np.float32),
        keypoints_scores=rng.random((b, d, k)).astype(np.float32),
        keypoints_visible=rng.random((b, d, k)).astype(np.float32),
    )
    jout = JaxRTMOModelOutput(**{n: jnp.asarray(a) for n, a in arrays.items()})
    pout = RTMOModelOutput(**{n: torch.from_numpy(a) for n, a in arrays.items()})
    return jout, pout


@pytest.mark.parametrize("image_size", [None, 256], ids=["padded", "resized"])
def test_processor_postprocess_matches_jax(image_size):
    """The same model arrays → the same detections: a mixed-size padded batch
    (no target size: coordinates stay in each image's frame, as
    tests/test_processors.py:57 checks for JAX) and a squash-resized one."""
    from focoos_tpu.models.rtmo.config import RTMOConfig as JaxRTMOConfig
    from focoos_tpu_torch.models.rtmo.config import RTMOConfig

    k = 3
    jcfg = JaxRTMOConfig(num_classes=2, num_keypoints=k, backbone_config=JaxCSPConfig())
    pcfg = RTMOConfig(num_classes=2, num_keypoints=k, backbone_config=CSPConfig())
    jout, pout = _outputs(np.random.default_rng(9), 2, 6, k)
    imgs = [np.zeros((128, 96, 3), np.uint8), np.zeros((64, 256, 3), np.uint8)]
    want = JaxRTMOProcessor(jcfg, image_size).postprocess(jout, imgs, class_names=["a", "b"], threshold=0.1)
    got = RTMOProcessor(pcfg, image_size).postprocess(pout, imgs, class_names=["a", "b"], threshold=0.1)
    assert [len(r) for r in got] == [len(r) for r in want]
    assert sum(len(r) for r in got) > 0
    for g, w in zip(got, want):
        for dg, dw in zip(g.detections, w.detections):
            assert (dg.bbox, dg.conf, dg.cls_id, dg.label, dg.keypoints) == (dw.bbox, dw.conf, dw.cls_id, dw.label, dw.keypoints)


def test_preprocess_pads_to_32_without_target_size():
    from focoos_tpu_torch.models.rtmo.config import RTMOConfig

    p = RTMOProcessor(RTMOConfig(num_classes=1, backbone_config=CSPConfig()), None)
    batch, _ = p.preprocess([np.ones((70, 90, 3), np.uint8), np.ones((50, 100, 3), np.uint8)])
    assert batch.shape == (2, 96, 128, 3) and batch.dtype == np.uint8
    assert batch[0, 70:].sum() == 0 and batch[1, :, 100:].sum() == 0 and batch[0, :70, :90].all()


@pytest.mark.parametrize(
    "jax_cls,port_cls", [(JaxConvModule, ConvModule), (JaxProjectionConv, ProjectionConv)],
    ids=["csp_darknet-ConvModule-eps1e-3-momentum0.97", "rtmo-ProjectionConv-eps1e-5-momentum0.9"],
)
def test_batchnorm_train_step_matches_flax(jax_cls, port_cls):
    """One train-mode step of a conv + BatchNorm block: the output and the
    running statistics move as flax's do (toward the biased batch variance,
    at each block's own momentum and eps), as
    tests/test_torch_train.py::test_batchnorm_train_step_matches_flax holds
    fai-detr's BatchNorm. Random statistics are perturbed off their init."""
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((2, 5, 6, 3)) * 2 + 0.5).astype(np.float32)
    jmod = jax_cls(out_channels=4, kernel_size=3, padding=1)
    flat = _perturb(_flat(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)), seed=22)
    y, new = jmod.apply(unflatten_tree(flat), jnp.asarray(x), train=True, mutable=["batch_stats"])
    port = port_cls(3, 4, kernel_size=3, padding=1)
    with torch.no_grad():
        port.conv.weight.copy_(torch.tensor(flat["params/conv/kernel"]).permute(3, 2, 0, 1))
        for name, key in (("weight", "params/bn/scale"), ("bias", "params/bn/bias"),
                          ("running_mean", "batch_stats/bn/mean"), ("running_var", "batch_stats/bn/var")):
            getattr(port.bn, name).copy_(torch.tensor(flat[key]))
    got = port.train()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(y), rtol=0, atol=1e-5 * np.abs(np.asarray(y)).max())
    stats = new["batch_stats"]["bn"]
    np.testing.assert_allclose(port.bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6)
