"""Port parity for the fai-detr serving slice: the port (focoos_tpu_torch) and
the JAX package run the same numpy weights and inputs on the CPU, in fp32.

Weights cross over through ``focoos_tpu_torch.utils.weights.from_jax_variables``
(the inverse of ``focoos_tpu.utils.torch_convert``). The zero-initialised MSDA
kernels, unit BatchNorm statistics and unit norm scales are perturbed first, so
that the deformable sampling and the folded BatchNorms do real work.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_checkpoint import few_threads_module  # noqa: F401 (an autouse fixture: two threads throughout)

from focoos_tpu.model_manager import ModelManager as JaxModelManager
from focoos_tpu.models.fai_detr.config import DETRConfig as JaxDETRConfig
from focoos_tpu.models.fai_detr.modelling import FAIDetr as JaxFAIDetr
from focoos_tpu.models.fai_detr.modelling import MSDeformableAttention as JaxMSDA
from focoos_tpu.models.fai_detr.processor import _decode_topk as jax_decode_topk
from focoos_tpu.nn.backbone.resnet import ResNet as JaxResNet
from focoos_tpu.nn.backbone.resnet import ResnetConfig as JaxResnetConfig
from focoos_tpu.ports import ArtifactName, ModelFamily, ModelInfo, Task
from focoos_tpu.processor.base_processor import Processor as JaxProcessor
from focoos_tpu.utils.checkpoint import flatten_tree, save_variables_npz, unflatten_tree
from focoos_tpu.utils.torch_convert import convert_state_dict
from focoos_tpu_torch.model_manager import ModelManager
from focoos_tpu_torch.models.fai_detr.config import DETRConfig
from focoos_tpu_torch.models.fai_detr.modelling import FAIDetr, MSDeformableAttention, _anchor_tensors
from focoos_tpu_torch.models.fai_detr.processor import _decode_topk
from focoos_tpu_torch.nn.backbone.resnet import ResNet, ResnetConfig
from focoos_tpu_torch.processor.base_processor import Processor
from focoos_tpu_torch.utils.weights import from_jax_variables

AUX_TOL = 1e-4  # every DETRAuxOutputs field, absolute, fp32 both sides
SIZE = 96
NUM_CLASSES = 11


def _flat(variables):
    out = {}
    for collection, tree in variables.items():
        out.update(flatten_tree(tree, prefix=f"{collection}/"))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _perturb(flat, seed):
    """Make every initial identity or zero do work: BN statistics and norm
    scales random, biases nudged, MSDA offset/attention kernels non-zero."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        if k.endswith("/var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith("/mean"):
            v = rng.normal(0.0, 0.1, v.shape)
        elif k.endswith("/scale"):
            v = rng.uniform(0.8, 1.2, v.shape)
        elif k.endswith(("sampling_offsets/kernel", "attention_weights/kernel")):
            v = rng.normal(0.0, 0.02, v.shape)
        elif k.endswith("/bias"):
            v = v + rng.normal(0.0, 0.02, v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def _to_port(module, flat, family):
    module.load_state_dict(from_jax_variables(flat, family), strict=True)
    return module.eval()


def _tiny_configs():
    jb = JaxResnetConfig(depth=18, variant="d", freeze_norm=False, use_pretrained=False)
    pb = ResnetConfig(depth=18, variant="d", freeze_norm=False, use_pretrained=False)
    kw = dict(num_classes=NUM_CLASSES, num_queries=20, transformer_predictor_dec_layers=2)
    return JaxDETRConfig(backbone_config=jb, **kw), DETRConfig(backbone_config=pb, **kw)


@pytest.fixture(scope="module")
def tiny_detr():
    """The tests/test_fai_detr.py tiny config at 96²: JAX module + perturbed
    weights, and the port module carrying the same weights."""
    jcfg, pcfg = _tiny_configs()
    jmodel = JaxFAIDetr(config=jcfg, backbone=JaxResNet(config=jcfg.backbone_config))
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    flat = _perturb(_flat(variables), seed=0)
    pmodel = _to_port(FAIDetr(pcfg, ResNet(pcfg.backbone_config)), flat, "fai_detr")
    return jmodel, flat, pmodel, jcfg


def _images(seed, b=2, size=SIZE):
    return np.random.default_rng(seed).integers(0, 256, (b, size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize("depth", [18, 50])
def test_resnet_features_match_jax(depth):
    """res2–res5 on carried weights at an odd size (67x75: the avg-pool
    shortcuts see odd edges); the port's eval stem is the fused op."""
    jcfg = JaxResnetConfig(depth=depth, variant="d", freeze_norm=False, use_pretrained=False)
    jmodel = JaxResNet(config=jcfg)
    x = np.random.default_rng(depth).standard_normal((2, 67, 75, 3)).astype(np.float32)
    flat = _perturb(_flat(jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(x[:1]))), seed=depth)
    ref = jax.jit(jmodel.apply)(unflatten_tree(flat), jnp.asarray(x))
    port = _to_port(ResNet(ResnetConfig(depth=depth, variant="d", freeze_norm=False)), flat, "resnet")
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert sorted(got) == sorted(ref) == ["res2", "res3", "res4", "res5"]
    for k in ref:
        r = np.asarray(ref[k])
        g = got[k].permute(0, 2, 3, 1).numpy()
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max(), err_msg=k)


def test_msdeformable_attention_module_matches_jax():
    b, lq, embed, heads, ss = 2, 10, 32, 4, ((6, 5), (3, 3), (2, 2))
    s = sum(h * w for h, w in ss)
    rng = np.random.default_rng(5)
    query = rng.standard_normal((b, lq, embed)).astype(np.float32)
    value = rng.standard_normal((b, s, embed)).astype(np.float32)
    ref_pts = np.concatenate(
        [rng.uniform(0.1, 0.9, (b, lq, 1, 2)), rng.uniform(0.05, 0.5, (b, lq, 1, 2))], -1
    ).astype(np.float32)
    jmod = JaxMSDA(embed, heads, len(ss), 4)
    args = (jnp.asarray(query), jnp.asarray(ref_pts), jnp.asarray(value), ss)
    params = {"params": jax.jit(jmod.init, static_argnums=4)(jax.random.PRNGKey(2), *args)["params"]}
    # the sampling kernels are zeros at init: perturb them (and the biases)
    flat = _perturb(_flat(params), seed=6)
    ref = np.asarray(jmod.apply(unflatten_tree(flat), *args))
    port = MSDeformableAttention(embed, heads, len(ss), 4)
    sd = {
        k.replace("params/", "").replace("/kernel", ".weight").replace("/bias", ".bias"): torch.from_numpy(
            np.ascontiguousarray(v.T)
        )
        for k, v in flat.items()
    }
    port.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(query), torch.from_numpy(ref_pts), torch.from_numpy(value), ss).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def _port_candidate_boxes(pmodel, x):
    """The port's sigmoid boxes for every anchor position [B, S, 4] — used
    to identify which anchors JAX's top-k picked from its enc_boxes."""
    pred = pmodel.predictor
    memory, ss = pred.flatten_levels(pmodel.encode(x))
    anchors, valid = _anchor_tensors(tuple(ss), memory.device)
    coord = pred.enc_bbox_classifier(pred.enc_output(memory * valid.to(memory.dtype))) + anchors
    return torch.sigmoid(coord), pred.select_queries(memory, ss)[0]


def test_fai_detr_forward_matches_jax(tiny_detr):
    jmodel, flat, pmodel, _ = tiny_detr
    x = _images(0)
    jout, jaux = jax.jit(jmodel.apply)(unflatten_tree(flat), jnp.asarray(x))
    with torch.inference_mode():
        pout, paux = pmodel(torch.from_numpy(x))
        cand, port_idx = _port_candidate_boxes(pmodel, torch.from_numpy(x))

    # top-k query selection first: a near-tie flip shows up here, not as
    # a value mismatch further down
    jax_boxes = np.asarray(jaux.enc_boxes)
    dist = np.abs(jax_boxes[:, :, None, :] - cand.numpy()[:, None, :, :]).max(-1)  # [B, Q, S]
    jax_idx = dist.argmin(-1)
    assert dist.min(-1).max() < AUX_TOL, "a JAX-selected query has no matching anchor in the port"
    flips = np.argwhere(jax_idx != port_idx.numpy())
    assert len(flips) == 0, f"top-k selection differs at (batch, rank) {flips.tolist()}: a near-tie flip"

    for field in ("dec_logits", "dec_boxes", "enc_logits", "enc_boxes"):
        r, g = np.asarray(getattr(jaux, field)), getattr(paux, field).numpy()
        assert g.shape == r.shape, field
        np.testing.assert_allclose(g, r, rtol=0, atol=AUX_TOL, err_msg=field)
    np.testing.assert_allclose(pout.boxes.numpy(), np.asarray(jout.boxes), rtol=0, atol=AUX_TOL)
    np.testing.assert_allclose(pout.logits.numpy(), np.asarray(jout.logits), rtol=0, atol=AUX_TOL)


def test_weights_roundtrip_through_torch_convert(tiny_detr):
    """from_jax_variables loaded strictly; torch_convert maps the port's
    state_dict back onto exactly the JAX tree, with no key unmatched."""
    _, flat, pmodel, _ = tiny_detr
    sd = {k: v.numpy() for k, v in pmodel.state_dict().items()}
    tree, unmatched = convert_state_dict(sd, "fai_detr", verbose=False)
    assert unmatched == []
    back = _flat(tree)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


def _run_dir(tmp_path, jcfg, flat):
    info = ModelInfo(
        name="tiny-detr", model_family=ModelFamily.DETR, classes=[f"c{i}" for i in range(NUM_CLASSES)],
        im_size=SIZE, task=Task.DETECTION, config=jcfg.to_dict(),
    )
    info.dump_json(str(tmp_path))
    tree = unflatten_tree(flat)
    save_variables_npz(os.path.join(tmp_path, ArtifactName.WEIGHTS.value), tree)
    return str(tmp_path)


def test_model_manager_detections_match_jax(tiny_detr, tmp_path):
    """ModelManager.get(run_dir, device="cpu") → model([img]) gives the JAX
    package's FocoosDetections on the same model_final.npz."""
    _, flat, _, jcfg = tiny_detr
    run_dir = _run_dir(tmp_path, jcfg, flat)
    with open(os.path.join(run_dir, ArtifactName.INFO.value)) as f:
        assert json.load(f)["model_family"] == "fai_detr"
    jm = JaxModelManager.get(run_dir)
    pm = ModelManager.get(run_dir, device="cpu")
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8), rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)]
    jres = jm(imgs, threshold=0.0, top_k=50)
    pres = pm(imgs, threshold=0.0, top_k=50)
    assert len(jres) == len(pres) == 2
    for jr, pr in zip(jres, pres):
        assert len(pr) == len(jr) == 50
        assert [d.cls_id for d in pr.detections] == [d.cls_id for d in jr.detections]
        assert [d.label for d in pr.detections] == [d.label for d in jr.detections]
        np.testing.assert_allclose([d.conf for d in pr.detections], [d.conf for d in jr.detections], atol=AUX_TOL)
        # boxes are rounded to whole pixels: allow a rounding flip
        np.testing.assert_allclose([d.bbox for d in pr.detections], [d.bbox for d in jr.detections], atol=1)
        assert pr.latency is not None and pr.latency.inference > 0


def test_processor_resize_matches_jax():
    """The port resizes with F.interpolate (bilinear, half-pixel, no
    antialias) where the JAX package uses cv2 in float32."""
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (70, 90, 3), dtype=np.uint8), rng.integers(0, 256, (130, 97, 3), dtype=np.uint8)]
    cfg = _tiny_configs()[1]
    got = Processor(cfg, SIZE).get_batch(imgs, (SIZE, SIZE))
    ref = JaxProcessor(cfg, SIZE).get_batch(imgs, (SIZE, SIZE))
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape == (2, SIZE, SIZE, 3)
    # cv2 interpolates float32 with coefficients of its own precision: 2e-5 of the 0-255 range
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-3)
    same = [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)] * 2  # already at size: uint8 passthrough
    np.testing.assert_array_equal(Processor(cfg, SIZE).get_batch(same, (SIZE, SIZE)), np.stack(same))


def test_decode_topk_matches_jax():
    rng = np.random.default_rng(8)
    logits = rng.permutation(2 * 20 * NUM_CLASSES).reshape(2, 20, NUM_CLASSES).astype(np.float32) / 500.0
    boxes = rng.random((2, 20, 4), np.float32)
    ref = [np.asarray(a) for a in jax_decode_topk(jnp.asarray(logits), jnp.asarray(boxes), 30)]
    got = _decode_topk(torch.from_numpy(logits), torch.from_numpy(boxes), 30)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
