"""Port parity for the bisenetformer family on the CPU: the three registry
cards at full width, the weights through ``torch_convert``, the eval forward,
the bf16 dtypes, the semantic decodes, the stride-8 training targets, one
train step and the solver's groups, against the JAX package; then
FocoosModel.train through the port's trainer.

The tiny model is ``bisenetformer-l-ade`` cut to STDC base 16 with layers
2/2/2, a 32-wide pixel decoder, 10 queries, 2 masked decoder layers (3
prediction sets), 11 classes and 100 loss points, at 96² (mask features
12²). Weights, draws and tolerances are those of tests/test_torch_mf_train.py:
forward outputs 1e-4 x max|ref| (fp32 sums in another order), decoded
scores 1e-5, label maps and PNG masks equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_checkpoint import few_threads  # noqa: F401 (a fixture)
from test_torch_fai_detr import _flat
from test_torch_mf_train import (
    _train_entries,
    assert_grads_match,
    assert_step_matches,
    jax_train_step,
    mask_targets,
    port_train_step,
    recorded_jax_draws,
    seeded_flat,
    tiny_configs,
)

from focoos_tpu.model_manager import BackboneManager as JaxBackboneManager
from focoos_tpu.model_manager import ConfigManager as JaxConfigManager
from focoos_tpu.models.bisenetformer.modelling import BisenetFormer as JaxBisenetFormer
from focoos_tpu.models.bisenetformer.processor import BisenetFormerProcessor as JaxBisenetProcessor
from focoos_tpu.models.fai_mf.ports import MaskFormerModelOutput as JaxMFOutput
from focoos_tpu.ports import DatasetEntry as JaxDatasetEntry
from focoos_tpu.trainer.solver import leaf_hyperparams
from focoos_tpu.utils.checkpoint import unflatten_tree
from focoos_tpu.utils.torch_convert import convert_state_dict
from focoos_tpu_torch import ModelManager
from focoos_tpu_torch.model_manager import BackboneManager
from focoos_tpu_torch.models.bisenetformer.modelling import BisenetFormer
from focoos_tpu_torch.models.bisenetformer.processor import BisenetFormerProcessor
from focoos_tpu_torch.models.fai_mf.ports import MaskFormerModelOutput
from focoos_tpu_torch.nn.layers.common import set_compute_dtype
from focoos_tpu_torch.ports import DatasetEntry, TrainerArgs
from focoos_tpu_torch.trainer.solver import param_hyperparams
from focoos_tpu_torch.utils.vision import base64_png_to_mask
from focoos_tpu_torch.utils.weights import from_jax_variables, to_jax_variables

NUM_CLASSES = 11
SIZE = 96
POINTS = 100
TOL = 1e-4  # x max|ref|
SCORE_TOL = 1e-5
STDC_TINY = {"model_type": "stdc", "base": 16, "layers": [2, 2, 2], "block_num": 4, "block_type": "cat",
             "use_conv_last": False, "use_pretrained": False}
TINY = dict(num_classes=NUM_CLASSES, num_queries=10, transformer_predictor_dec_layers=2, pixel_decoder_feat_dim=32,
            pixel_decoder_out_dim=32, transformer_predictor_out_dim=32, transformer_predictor_hidden_dim=64,
            transformer_predictor_dim_feedforward=128, criterion_num_points=POINTS, backbone_config=STDC_TINY)


def _jax_model(jcfg, dtype=None):
    return JaxBisenetFormer(config=jcfg, backbone=JaxBackboneManager.from_config(jcfg.backbone_config), dtype=dtype)


def _port_model(pcfg, flat):
    m = BisenetFormer(pcfg, BackboneManager.from_config(pcfg.backbone_config))
    m.load_state_dict(from_jax_variables(flat, "bisenetformer"), strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def tiny():
    """The JAX module and config, the perturbed weights, images, targets and
    matcher points; JAX's train step in fp32 and in fp64."""
    jcfg, pcfg = tiny_configs("bisenetformer", "bisenetformer-l-ade", **TINY)
    jmodel = _jax_model(jcfg)
    flat = seeded_flat(BisenetFormer(pcfg, BackboneManager.from_config(pcfg.backbone_config)), "bisenetformer", jmodel)
    images = np.random.default_rng(1).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    targets = mask_targets(2, hm=SIZE // 8, wm=SIZE // 8)
    match_pts = np.random.default_rng(4).random((3, 2, 1, POINTS, 2)).astype(np.float32)
    ref32 = jax_train_step(jmodel, jcfg, flat, images, targets, match_pts)
    with jax.enable_x64(True):
        ref64 = jax_train_step(_jax_model(jcfg, jnp.float64), jcfg, flat, images, targets, match_pts, x64=True)
    return dict(jcfg=jcfg, pcfg=pcfg, jmodel=jmodel, flat=flat, images=images, targets=targets,
                match_pts=match_pts, ref32=ref32, ref64=ref64)


def _close(got: torch.Tensor, ref, what: str) -> None:
    r = np.asarray(ref, np.float32)
    g = got.float().numpy()
    assert g.shape == r.shape, (what, g.shape, r.shape)
    np.testing.assert_allclose(g, r, rtol=0, atol=TOL * max(np.abs(r).max(), 1e-12), err_msg=what)


# --------------------------------------------------------------------------- cards and weights
@pytest.mark.parametrize("card", ["bisenetformer-s-ade", "bisenetformer-m-ade", "bisenetformer-l-ade"])
def test_cards_build_at_full_width_with_jax_parameter_counts(card):
    """Each registry card, uncut: the JAX tree's parameter count (by tracing
    alone) equals the port module's; STDC backbone, two decoder scales,
    stride-8 mask features."""
    model = ModelManager.get(card, device="cpu", init_weights=False)
    d = model.model_info.config
    jcfg = JaxConfigManager.from_dict("bisenetformer", d)
    abstract = jax.eval_shape(_jax_model(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    jax_count = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(abstract["params"]))
    module = model.module
    assert sum(p.numel() for p in module.parameters()) == jax_count
    assert len(module.predictor.input_proj) == 2 and module.config.num_classes == 150
    assert module.predictor.dec_layers == model.config.transformer_predictor_dec_layers
    assert isinstance(model.processor, BisenetFormerProcessor)
    with torch.inference_mode():
        out, aux = module(torch.zeros((1, 64, 96, 3), dtype=torch.uint8))
    assert aux.masks.shape[-2:] == (8, 12) and out.masks.shape == (1, 100, 64, 96)


def test_weights_roundtrip_through_torch_convert(tiny):
    """torch_convert's bisenetformer rules map the port's state_dict onto
    exactly the JAX tree, no key unmatched (its ``arm8``/``conv_head8``
    rules match nothing: BiseNet has neither), and to_jax_variables writes
    the same flat arrays."""
    pm = _port_model(tiny["pcfg"], tiny["flat"])
    sd = {k: v.numpy() for k, v in pm.state_dict().items()}
    tree, unmatched = convert_state_dict(sd, "bisenetformer", verbose=False)
    assert unmatched == [] and any(k.startswith("pixel_decoder.cp.arm32.bn_atten") for k in sd)
    for back in (_flat(tree), to_jax_variables(sd, "bisenetformer")):
        assert sorted(back) == sorted(tiny["flat"])
        for k, v in tiny["flat"].items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)


# --------------------------------------------------------------------------- forward
def _jax_eval(jmodel, flat, x):
    """JAX's eval forward → (output, aux, the cross-attention masks used)."""
    with recorded_jax_draws(np.zeros(0)) as rec:
        def run(v, x):
            out, aux = jmodel.apply(v, x)
            return out, aux, list(rec["allowed"])

        return jax.jit(run)(unflatten_tree(flat), jnp.asarray(x))


@pytest.mark.parametrize("hw", [(96, 96), (100, 76)], ids=["96", "100x76"])
def test_eval_forward_matches_jax(tiny, hw):
    """Every decoder layer's class logits and masks and the eval outputs
    (class probabilities, masks upsampled to the input) on JAX's attention
    masks; 100x76 gives odd levels (res5 4x3 upsampled to res4 7x5)."""
    x = np.random.default_rng(5).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    jout, jaux, used = _jax_eval(tiny["jmodel"], tiny["flat"], x)
    with torch.inference_mode():
        pout, paux = _port_model(tiny["pcfg"], tiny["flat"])(
            torch.from_numpy(x), allowed=[torch.tensor(np.asarray(u)) for u in used])
    _close(paux.logits, jaux.logits, "aux.logits")
    _close(paux.masks, jaux.masks, "aux.masks")
    _close(pout.logits, jout.logits, "logits")
    _close(pout.masks, jout.masks, "masks")
    assert pout.masks.shape[-2:] == hw and paux.masks.shape[-2:] == (-(-hw[0] // 8), -(-hw[1] // 8))


def test_bf16_dtype_map_matches_flax(tiny):
    """The dtypes at named points of a bf16 model, port against flax's
    capture_intermediates: STDC's res5, an ARM's attention BatchNorm, the
    FFM, the mask features, the decoder's cross-attention block and its
    heads' LayerNorm, and the outputs (class probabilities fp32, masks bf16)."""
    x = np.random.default_rng(6).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    j16 = _jax_model(tiny["jcfg"], jnp.bfloat16)
    fn = jax.jit(lambda v, x: j16.apply(v, x, capture_intermediates=True, mutable=["intermediates"]))
    (jout, _), state = fn(unflatten_tree(tiny["flat"]), jnp.asarray(x))
    inter = state["intermediates"]
    pd, pr = inter["pixel_decoder"], inter["predictor"]
    want = {
        "res5": inter["backbone"]["features_6"]["__call__"][0].dtype,
        "bn_atten": pd["cp_arm32"]["bn_atten"]["__call__"][0].dtype,
        "ffm": pd["ffm"]["__call__"][0].dtype,
        "conv_out": pd["conv_out"]["__call__"][0].dtype,
        "cross_block": pr["transformer_cross_attention_layers_0"]["__call__"][0].dtype,
        "decoder_norm": pr["forward_prediction_heads"]["decoder_norm"]["__call__"][0].dtype,
    }
    pm = _port_model(tiny["pcfg"], tiny["flat"])
    set_compute_dtype(pm, torch.bfloat16)
    pdm = pm.pixel_decoder
    points = {"res5": pdm.backbone.features[6], "bn_atten": pdm.cp.arm32.bn_atten, "ffm": pdm.ffm,
              "conv_out": pdm.conv_out, "cross_block": pm.predictor.transformer_cross_attention_layers[0],
              "decoder_norm": pm.predictor.forward_prediction_heads.decoder_norm}
    got = {}
    hooks = [m.register_forward_hook(lambda m, a, o, n=n: got.setdefault(n, o.dtype) and None)
             for n, m in points.items()]
    try:
        with torch.inference_mode():
            out, _ = pm(torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()
    to_torch = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}
    assert got == {k: to_torch[jnp.dtype(v)] for k, v in want.items()}
    assert want["res5"] == want["ffm"] == want["conv_out"] == jnp.bfloat16 and want["decoder_norm"] == jnp.float32
    assert jout.masks.dtype == jnp.bfloat16 and out.masks.dtype == torch.bfloat16
    assert jout.logits.dtype == jnp.float32 and out.logits.dtype == torch.float32


# --------------------------------------------------------------------------- decodes
def _processors(**over):
    jcfg, pcfg = tiny_configs("bisenetformer", "bisenetformer-l-ade", **dict(TINY, **over))
    return JaxBisenetProcessor(jcfg), BisenetFormerProcessor(pcfg)


def _probs(seed, b=2, q=10, hw=(40, 36)):
    rng = np.random.default_rng(seed)
    logits = rng.dirichlet(np.ones(NUM_CLASSES + 1), (b, q))[..., :NUM_CLASSES].astype(np.float32)
    masks = rng.random((b, q, *hw)).astype(np.float32)
    return logits, np.where(np.abs(masks - 0.5) < 1e-3, 0.9, masks).astype(np.float32)


@pytest.mark.parametrize("over", [dict(threshold=0.1), dict(predict_all_pixels=False, threshold=0.2)],
                         ids=["all-pixels", "thresholded"])
def test_postprocess_matches_jax(over):
    """Serving detections (the card's semantic decode, predict_all_pixels by
    default) for a batch padded to the larger image: boxes, class ids and PNG
    masks equal, confidences within 1e-5."""
    logits, masks = _probs(2)
    inputs = [np.zeros((40, 36, 3), np.uint8), np.zeros((31, 23, 3), np.uint8)]
    jp, pp = _processors(**over)
    ref = jp.postprocess(JaxMFOutput(masks=jnp.asarray(masks), logits=jnp.asarray(logits)), inputs, class_names=[])
    got = pp.postprocess(MaskFormerModelOutput(masks=torch.from_numpy(masks), logits=torch.from_numpy(logits)),
                         inputs, class_names=[])
    assert sum(len(r.detections) for r in ref) > 0
    for r, g in zip(ref, got):
        assert len(g.detections) == len(r.detections)
        for dr, dg in zip(r.detections, g.detections):
            assert dg.bbox == dr.bbox and dg.cls_id == dr.cls_id
            assert abs(dg.conf - dr.conf) <= SCORE_TOL * max(abs(dr.conf), 1.0)
            np.testing.assert_array_equal(base64_png_to_mask(dg.mask), base64_png_to_mask(dr.mask))


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_semantic_eval_postprocess_matches_jax(host, monkeypatch):
    """The label map cropped to each image (device path), or the class scores
    at the original size (host path)."""
    logits, masks = _probs(4, hw=(32, 32))
    if host:
        monkeypatch.setenv("FOCOOS_SEMSEG_EVAL_HOST", "1")
    else:
        monkeypatch.delenv("FOCOOS_SEMSEG_EVAL_HOST", raising=False)
    jp, pp = _processors()
    sizes = [(48, 40), (24, 20)]
    ref = jp.eval_postprocess(JaxMFOutput(masks=jnp.asarray(masks), logits=jnp.asarray(logits)),
                              [JaxDatasetEntry(image=np.zeros((24, 20, 3), np.uint8), height=h, width=w) for h, w in sizes])
    got = pp.eval_postprocess(MaskFormerModelOutput(masks=torch.from_numpy(masks), logits=torch.from_numpy(logits)),
                              [DatasetEntry(image=np.zeros((24, 20, 3), np.uint8), height=h, width=w) for h, w in sizes])
    for r, g in zip(ref, got):
        if host:
            np.testing.assert_allclose(g["sem_seg"], np.asarray(r["sem_seg"]), rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(g["sem_seg"], np.asarray(r["sem_seg"]))


def test_training_targets_are_stride_8_as_jax():
    """The processor's default mask stride is 8, as JAX's: targets at
    ceil(h/8) x ceil(w/8), equal to the JAX processor's; its exported outputs
    are JAX's, in JAX's order (logits, then masks: the reverse of fai_mf's)."""
    from test_torch_mf_train import _instance_entries

    jp, pp = _processors()
    sizes, counts = ((97, 75), (90, 81)), (3, 5)
    _, jt = jp.train(True).preprocess_entries(_instance_entries(True, sizes, counts, 12))
    _, pt = pp.train(True).preprocess_entries(_instance_entries(False, sizes, counts, 12))
    assert pt.masks.shape == (2, 100, 13, 11)
    np.testing.assert_array_equal(pt.labels.numpy(), np.asarray(jt.labels))
    np.testing.assert_array_equal(pt.valid.numpy(), np.asarray(jt.valid))
    np.testing.assert_allclose(pt.masks.numpy(), np.asarray(jt.masks), rtol=0, atol=1e-6)
    assert pp.get_output_names() == jp.get_output_names() == ["logits", "masks"]


# --------------------------------------------------------------------------- training
def _port_module(tiny):
    m = BisenetFormer(tiny["pcfg"], BackboneManager.from_config(tiny["pcfg"].backbone_config))
    m.load_state_dict(from_jax_variables(tiny["flat"], "bisenetformer"), strict=True)
    return m


@pytest.mark.usefixtures("few_threads")
def test_train_step_matches_jax(tiny):
    """One fp32 train step on JAX's attention masks and points: losses 1e-4
    rel (STDC's chain of train-mode BatchNorms grows fp32 rounding past
    1e-5 on this model, as fai-detr-m's CPU step drifts; the fp64 step
    below holds 1e-5), the assignment equal, the moved BatchNorm statistics
    1e-5 (the ARMs' attention BatchNorms over B 1x1 values included)."""
    got = port_train_step(_port_module(tiny), tiny["pcfg"], tiny["images"], tiny["targets"], tiny["ref32"],
                          tiny["match_pts"], "bisenetformer")
    assert_step_matches(got, tiny["ref32"], tiny["targets"], "fp32", loss_rtol=1e-4)


@pytest.mark.usefixtures("few_threads")
def test_train_step_gradients_match_jax_in_fp64(tiny):
    """Both packages in fp64: losses 1e-5 rel, every gradient 1e-4 x its max |ref| + 1e-7."""
    got = port_train_step(_port_module(tiny), tiny["pcfg"], tiny["images"], tiny["targets"], tiny["ref64"],
                          tiny["match_pts"], "bisenetformer", dtype=torch.float64)
    assert_step_matches(got, tiny["ref64"], tiny["targets"], "fp64")
    assert_grads_match(got["grads"], tiny["ref64"]["grads"])


@pytest.mark.parametrize("freeze_bn", [False, True], ids=["groups", "freeze_bn"])
def test_solver_groups_match_jax_on_stdc_names(tiny, freeze_bn):
    """lr multiplier and weight decay of every parameter against
    leaf_hyperparams: the context path's ``conv_head*`` take the head's
    multiplier in both (a substring match on "head"); freeze_bn spares the
    ARMs' ``bn_atten`` and STDC's avd/skip BatchNorms, whose JAX paths are
    not under ``/bn/``."""
    module = _port_module(tiny)
    names = [n for n, _ in module.named_parameters()]
    ids = {n: np.full(tuple(p.shape), i, np.float32) for i, (n, p) in enumerate(module.named_parameters())}
    source = {k: names[int(v.flat[0])] for k, v in
              _flat({"params": convert_state_dict(ids, "bisenetformer", verbose=False)[0]["params"]}).items()}
    kw = dict(base_wd=0.02, wd_norm=0.01, wd_embed=0.03, backbone_multiplier=0.1, decoder_multiplier=0.5,
              head_multiplier=2.0, freeze_bn=freeze_bn)
    lr_tree, wd_tree = leaf_hyperparams(unflatten_tree(tiny["flat"])["params"], **kw)
    hp = param_hyperparams(module, **kw)
    assert sorted(source) == sorted(_flat({"params": lr_tree}))
    for i, ref_tree in enumerate((lr_tree, wd_tree)):
        for k, ref in _flat({"params": ref_tree}).items():
            assert hp[source[k]][i] == pytest.approx(float(ref), rel=1e-6), (k, source[k], i)
    assert hp["pixel_decoder.cp.conv_head32.conv.weight"] == pytest.approx((1.0, 0.02))
    if freeze_bn:
        assert hp["pixel_decoder.cp.arm32.bn_atten.weight"][0] > 0 and hp["pixel_decoder.conv_out.bn.weight"] == (0, 0)


@pytest.mark.usefixtures("few_threads")
def test_focoos_model_trains_bisenetformer_on_the_cpu(tmp_path):
    """ModelManager.get("bisenetformer-l-ade") at a tiny config trains through
    FocoosModel.train from semantic records (2 loader workers, validation
    with sem_seg/mIoU) and evaluates."""
    model = ModelManager.get("bisenetformer-l-ade", device="cpu", num_classes=3, **{
        k: v for k, v in TINY.items() if k != "num_classes"})
    args = TrainerArgs(run_name="bisenet", output_dir=str(tmp_path), batch_size=2, max_iters=2, eval_period=2,
                       checkpointer_period=2, log_period=1, workers=2, workers_timeout=120, samples=0)
    res = model.train(args, _train_entries(4, 64, 0, semantic=True), _train_entries(2, 64, 1, semantic=True))
    assert res["iterations"] == 2 and 0.0 <= res["metrics"]["sem_seg"]["mIoU"] <= 100.0
    assert os.path.isfile(os.path.join(res["run_dir"], "model_final.npz"))
    again = model.eval(TrainerArgs(run_name="e", batch_size=2), _train_entries(2, 64, 1, semantic=True))
    assert again["sem_seg"]["mIoU"] == res["metrics"]["sem_seg"]["mIoU"]
