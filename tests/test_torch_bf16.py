"""Port parity in bf16 compute: ``ModelManager.get(..., dtype="bfloat16")`` and
the JAX package's ``dtype=jnp.bfloat16`` on the same numpy weights and inputs,
on the CPU, at the tiny configs of tests/test_torch_fai_detr.py (ResNet-18-D,
96², 20 queries, 2 decoder layers) and tests/test_torch_rtmo.py (rtmo-s,
128²). Parameters stay fp32 on both sides; the dtypes at named points are
held to flax's.

bf16 rounds at other places in the two frameworks (convolutions and matmuls
accumulate in another order, XLA fuses elementwise chains), so a bf16 output
of the port and one of JAX differ by a few bf16 steps (2^-8 relative) of the
values they pass through. Two comparisons follow from that:

- **against fp32, on both sides:** each output moves from fp32 to bf16 about
  as far in the port as in JAX: ``max|port_bf16 - port_fp32| <= 2 *
  max|jax_bf16 - jax_fp32| + 1e-3``.
- **directly:** ``max|port_bf16 - jax_bf16| <= BF16_TOL * max|jax_bf16|``
  per output, BF16_TOL = 2^-4 (16 bf16 steps of the largest value; measured
  up to 2^-5 here, on rtmo's raw class logits), rtmo's keypoints
  KEYPOINT_BF16_TOL.

rtmo's detections are at most 10 rows an image, so their bf16-vs-fp32
criterion takes one bf16 step of the output's scale (2^-8 × max|ref|) for its
floor instead of 1e-3.

Query and detection selection: bf16 scores tie and near-tie, and a near-tie
resolves differently in the two frameworks' roundings, so the port's top-k
may pick other anchors than JAX's. fai-detr: the JAX package's own selected
indices (read from its ``jax.lax.top_k`` through a callback) are run through
the port's decoder (``select_queries(topk_idx=)``), and outputs of the bf16
and fp32 runs are compared row by row on the anchors both selected. rtmo:
per-anchor head outputs compare directly; detections are matched by anchor
index over the anchors both runs kept.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fai_detr import SIZE, _flat, _images, _perturb, _tiny_configs, _to_port
from test_torch_rtmo import SIZE as RTMO_SIZE
from test_torch_rtmo import TINY as RTMO_TINY
from test_torch_rtmo import _perturb as _perturb_rtmo
from test_torch_train import _jax_targets, _port_targets, _targets, _trainer_args

from focoos_tpu.model_manager import BackboneManager as JaxBackboneManager
from focoos_tpu.model_manager import ConfigManager as JaxConfigManager
from focoos_tpu.models.fai_detr import modelling as jax_fai_detr_modelling
from focoos_tpu.models.fai_detr.loss import make_loss_fn as jax_make_loss_fn
from focoos_tpu.models.fai_detr.modelling import FAIDetr as JaxFAIDetr
from focoos_tpu.models.fai_detr.processor import _decode_topk as jax_decode_topk
from focoos_tpu.models.rtmo.modelling import RTMO as JaxRTMO
from focoos_tpu.nn.backbone.resnet import ResNet as JaxResNet
from focoos_tpu.ops.nms import topk_nms as jax_topk_nms
from focoos_tpu.utils.checkpoint import unflatten_tree
from focoos_tpu.utils.torch_convert import convert_state_dict
from focoos_tpu_torch import ModelManager
from focoos_tpu_torch.models.fai_detr import modelling as port_fai_detr_modelling
from focoos_tpu_torch.models.fai_detr.loss import make_loss_fn
from focoos_tpu_torch.models.fai_detr.modelling import FAIDetr, TransformerPredictor
from focoos_tpu_torch.models.fai_detr.processor import _decode_topk
from focoos_tpu_torch.nn.backbone.resnet import ResNet
from focoos_tpu_torch.nn.layers.common import set_compute_dtype
from focoos_tpu_torch.ops.deformable import ms_deform_attn_backward_reference
from focoos_tpu_torch.ops.msda import msda_backward
from focoos_tpu_torch.ops.nms import topk_nms
from focoos_tpu_torch.ops.topk import topk_lowest_index_first
from focoos_tpu_torch.trainer.solver import Solver, ema_decay_schedule
from focoos_tpu_torch.trainer.train_step import build_train_step, create_train_state
from focoos_tpu_torch.utils.weights import from_jax_variables

BF16_TOL = 2.0**-4  # × max|jax_bf16|, port bf16 vs JAX bf16 on one selection
# rtmo keypoints, × max|jax_bf16|: DCC's bin softmax turns a bf16 step of its
# logits into a shift of the expected bin; JAX's own bf16 keypoints lie up to
# 15 px (9% of their range) from its fp32 ones here
KEYPOINT_BF16_TOL = 2.0**-2
# one training step in bf16, port vs JAX on JAX's selection: each loss and the
# global gradient norm, relative. A train-mode BatchNorm over 18 values (res5
# at 96²) normalizes bf16 activations whose rounding differs between the
# frameworks, and the VFL loss's IoU targets follow bf16 boxes (measured up to
# 3.3e-2, loss_vfl; total_loss 5.4e-3).
TRAIN_BF16_RTOL = 5e-2


def _record_top_k(monkeypatch):
    """Patch ``jax.lax.top_k`` to hand every index array it returns, as numpy,
    to the list returned (a host callback: works under jit and grad)."""
    seen, real = [], jax.lax.top_k

    def spy(x, k):
        values, indices = real(x, k)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), indices)
        return values, indices

    monkeypatch.setattr(jax.lax, "top_k", spy)
    return seen


def _carry_selection(predictor, topk_idx: np.ndarray):
    """Make ``predictor`` take ``topk_idx`` instead of its own top-k."""
    real = type(predictor).select_queries
    idx = torch.from_numpy(np.array(topk_idx))
    predictor.select_queries = lambda memory, ss: real(predictor, memory, ss, idx.to(memory.device))


def _rows_close(port16, port32, jax16, jax32, sel16, sel32, what):
    """Per image, on the anchors both selections hold: the bf16-vs-fp32
    distance of the port within twice JAX's (+1e-3). [..., B, Q, F] arrays;
    sel [B, Q] anchor indices."""
    for b in range(sel16.shape[0]):
        common = sorted(set(sel16[b].tolist()) & set(sel32[b].tolist()))
        assert len(common) >= sel16.shape[1] // 2, f"image {b}: only {len(common)} anchors selected in bf16 and fp32"
        r16 = [sel16[b].tolist().index(a) for a in common]
        r32 = [sel32[b].tolist().index(a) for a in common]
        d_port = np.abs(port16[..., b, r16, :] - port32[..., b, r32, :]).max()
        d_jax = np.abs(jax16[..., b, r16, :] - jax32[..., b, r32, :]).max()
        assert d_port <= 2 * d_jax + 1e-3, f"{what} image {b}: port moved {d_port:.3e} from fp32, JAX {d_jax:.3e}"


# --------------------------------------------------------------------------- fai-detr
@pytest.fixture(scope="module")
def detr():
    """Tiny fai-detr: JAX in fp32 and bf16 with its selected indices, the port in
    fp32 and bf16 on the same perturbed weights, two 96² images."""
    jcfg, pcfg = _tiny_configs()
    mp = pytest.MonkeyPatch()
    seen = _record_top_k(mp)
    out = {"x": _images(0)}
    try:
        j32 = JaxFAIDetr(config=jcfg, backbone=JaxResNet(config=jcfg.backbone_config))
        flat = _perturb(_flat(jax.jit(j32.init)(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))), 0)
        for name, dtype in (("32", None), ("16", jnp.bfloat16)):
            jm = JaxFAIDetr(config=jcfg, backbone=JaxResNet(config=jcfg.backbone_config), dtype=dtype)
            seen.clear()
            o, a = jax.jit(jm.apply)(unflatten_tree(flat), jnp.asarray(out["x"]))
            jax.effects_barrier()
            out[f"jax{name}"] = (o, a, seen[-1])
            out[f"jmodel{name}"] = jm
    finally:
        mp.undo()
    for name, dtype in (("32", torch.float32), ("16", torch.bfloat16)):
        pm = _to_port(FAIDetr(pcfg, ResNet(pcfg.backbone_config)), flat, "fai_detr")
        set_compute_dtype(pm, dtype)
        out[f"port{name}"] = pm
    out.update(flat=flat, jcfg=jcfg, pcfg=pcfg)
    return out


def test_fai_detr_bf16_serving_agrees_with_jax(detr):
    x = torch.from_numpy(detr["x"])
    jo32, ja32, jsel32 = detr["jax32"]
    jo16, ja16, jsel16 = detr["jax16"]
    with torch.inference_mode():
        po32, pa32 = detr["port32"](x)
        sel32 = detr["port32"].predictor.select_queries(
            *detr["port32"].predictor.flatten_levels(detr["port32"].encode(x)))[0].numpy()
    np.testing.assert_array_equal(sel32, jsel32)  # fp32: the same selection without carrying it
    p16 = detr["port16"]
    _carry_selection(p16.predictor, jsel16)
    try:
        with torch.inference_mode():
            po16, pa16 = p16(x)
    finally:
        del p16.predictor.select_queries
    for field in ("dec_logits", "dec_boxes", "enc_logits", "enc_boxes"):
        g16, g32 = getattr(pa16, field), getattr(pa32, field)
        assert g16.dtype == g32.dtype == torch.float32, field
        r16, r32 = np.asarray(getattr(ja16, field)), np.asarray(getattr(ja32, field))
        np.testing.assert_allclose(g16.numpy(), r16, rtol=0, atol=BF16_TOL * np.abs(r16).max(), err_msg=field)
        _rows_close(g16.numpy(), g32.numpy(), r16, r32, jsel16, jsel32, field)
    for field in ("boxes", "logits"):
        g16, r16 = getattr(po16, field), np.asarray(getattr(jo16, field))
        assert g16.dtype == torch.float32, field
        np.testing.assert_allclose(g16.numpy(), r16, rtol=0, atol=BF16_TOL * np.abs(r16).max(), err_msg=field)
        _rows_close(g16.numpy(), getattr(po32, field).numpy(), r16, np.asarray(getattr(jo32, field)),
                    jsel16, jsel32, field)


def _apply_capturing(jmodel, flat, x):
    """flax apply with every module's output captured (``intermediates``)."""
    fn = jax.jit(lambda v, x: jmodel.apply(v, x, capture_intermediates=True, mutable=["intermediates"]))
    return fn(unflatten_tree(flat), jnp.asarray(x))


def _port_dtypes(model, x, points, msda_module):
    """{point: dtype} of the port's outputs at the named submodules (a point
    whose name starts with "<" takes the submodule's input), and the MSDA
    value/loc/aw dtypes of the first decoder layer."""
    got, hooks = {}, []

    def record(name, t):
        got.setdefault(name, t.dtype)  # a hook that returns None leaves the call as it was

    for name, mod in points.items():
        if name.startswith("<"):
            hooks.append(mod.register_forward_pre_hook(lambda m, a, n=name: record(n, a[0])))
        else:
            hooks.append(mod.register_forward_hook(lambda m, a, o, n=name: record(n, o)))
    real = getattr(msda_module, "msda_forward", None)
    if real is not None:
        def spy(v, ss, loc, aw):
            got.setdefault("msda", (v.dtype, loc.dtype, aw.dtype))
            return real(v, ss, loc, aw)
        msda_module.msda_forward = spy
    try:
        with torch.inference_mode():
            out, _ = model(x)
    finally:
        for h in hooks:
            h.remove()
        if real is not None:
            msda_module.msda_forward = real
    return got, out


def test_fai_detr_bf16_dtype_map_matches_flax(detr, monkeypatch):
    """The dtypes of the stem, a ConvNorm, an AIFI LayerNorm, a decoder
    LayerNorm, the MSDA inputs and the outputs, port against flax's
    ``capture_intermediates`` (and the MSDA entry point's arguments)."""
    seen = {}
    real = jax_fai_detr_modelling.ms_deform_attn_levels

    def spy(v_levels, ss, loc, aw):
        seen.setdefault("msda", (v_levels[0].dtype, loc.dtype, aw.dtype))
        return real(v_levels, ss, loc, aw)

    monkeypatch.setattr(jax_fai_detr_modelling, "ms_deform_attn_levels", spy)
    (jout, _), state = _apply_capturing(detr["jmodel16"], detr["flat"], detr["x"])
    inter = state["intermediates"]
    want = {
        "stem": inter["backbone"]["conv1_3"]["__call__"][0].dtype,
        "convnorm": inter["pixel_decoder"]["lateral_convs_0"]["__call__"][0].dtype,
        "aifi_ln": inter["pixel_decoder"]["encoder_0_layers_0"]["norm2"]["__call__"][0].dtype,
        "decoder_ln": inter["predictor"]["decoder_layers_0"]["norm3"]["__call__"][0].dtype,
    }
    pm = detr["port16"]
    points = {
        "<stem": pm.pixel_decoder.backbone.res_layers[0],  # the fused stem kernel's output (conv1_3, pooled)
        "convnorm": pm.pixel_decoder.lateral_convs[0],
        "aifi_ln": pm.pixel_decoder.encoder[0]["layers"][0].norm2,
        "decoder_ln": pm.predictor.decoder["layers"][0].norm3,
    }
    got, out = _port_dtypes(pm, torch.from_numpy(detr["x"]), points, port_fai_detr_modelling)
    to_torch = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}
    assert {k.lstrip("<"): v for k, v in got.items() if k != "msda"} == {k: to_torch[jnp.dtype(v)] for k, v in want.items()}
    assert want["stem"] == want["convnorm"] == jnp.bfloat16 and want["aifi_ln"] == want["decoder_ln"] == jnp.float32
    assert got["msda"] == tuple(to_torch[jnp.dtype(d)] for d in seen["msda"]) == (torch.bfloat16, torch.float32,
                                                                                 torch.float32)
    for field in ("boxes", "logits"):
        assert getattr(jout, field).dtype == jnp.float32 and getattr(out, field).dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    assert all(b.dtype == torch.float32 for b in pm.buffers() if b.is_floating_point())


def test_fai_detr_bf16_train_step_matches_jax(detr, monkeypatch):
    """One bf16 training step, both sides on JAX's train-mode selection: every
    loss key and the global gradient norm; then the port's step keeps the
    parameters, gradients, AdamW moments and EMA in fp32."""
    jcfg, flat = detr["jcfg"], detr["flat"]
    labels, boxes, valid = _targets(2)
    jvars = unflatten_tree(flat)
    loss_fn = jax_make_loss_fn(detr["jmodel16"], jcfg)
    batch = (jnp.asarray(detr["x"]), _jax_targets(labels, boxes, valid))
    seen = _record_top_k(monkeypatch)

    def total_fn(params):
        return loss_fn({"params": params, "batch_stats": jvars["batch_stats"]}, batch, jax.random.PRNGKey(0))

    (total, (losses, _)), grads = jax.jit(jax.value_and_grad(total_fn, has_aux=True))(jvars["params"])
    jax.effects_barrier()
    jsel = seen[-1]
    monkeypatch.undo()
    ref = {k: float(v) for k, v in losses.items()}
    ref["total_loss"] = float(total)
    ref["grad_norm"] = float(np.sqrt(sum(float(jnp.sum(jnp.square(g.astype(jnp.float32))))
                                         for g in jax.tree_util.tree_leaves(grads))))

    module = FAIDetr(detr["pcfg"], ResNet(detr["pcfg"].backbone_config))
    module.load_state_dict(from_jax_variables(flat, "fai_detr"), strict=True)
    set_compute_dtype(module, torch.bfloat16)
    _carry_selection(module.predictor, jsel)
    args = _trainer_args()
    state = create_train_state(module, Solver(module, args), ema_enabled=True)
    step = build_train_step(make_loss_fn(module, detr["pcfg"]), ema_decay_schedule(args.ema_decay, args.ema_warmup))
    keys, packed = step(state, torch.from_numpy(detr["x"]), _port_targets(labels, boxes, valid))
    got = dict(zip(keys, packed.tolist()))
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=TRAIN_BF16_RTOL, err_msg=k)
    assert packed.dtype == torch.float32
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in module.parameters())
    moments = [t for s in state.solver.optimizer.state.values() for t in s.values() if t.is_floating_point()]
    assert moments and all(t.dtype == torch.float32 for t in moments)
    assert all(e.dtype == torch.float32 for e in state.ema_params)
    assert all(b.dtype == torch.float32 for b in module.buffers() if b.is_floating_point())


def test_resnet_bf16_stem_and_stages_match_jax():
    """ResNet-18-D in eval on a bf16 image (the JAX backbone computes in its
    input's dtype): the port's stem (``resnet_stem_reference``, the fused
    kernel's plain version, in bf16) against flax's ConvNorms and max pool,
    and res2–res5, each at BF16_TOL × max|ref|."""
    jcfg, pcfg = _tiny_configs()
    jmodel = JaxResNet(config=jcfg.backbone_config)
    x = np.random.default_rng(18).standard_normal((2, 67, 75, 3)).astype(np.float32)
    flat = _perturb(_flat(jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(x[:1]))), seed=18)
    xb = jnp.asarray(x, jnp.bfloat16)
    (ref, state) = jax.jit(lambda v, x: jmodel.apply(v, x, capture_intermediates=True, mutable=["intermediates"]))(
        unflatten_tree(flat), xb)
    stem_ref = np.asarray(jax.lax.reduce_window(
        state["intermediates"]["conv1_3"]["__call__"][0].astype(jnp.float32), -jnp.inf, jax.lax.max,
        (1, 3, 3, 1), (1, 2, 2, 1), ((0, 0), (1, 1), (1, 1), (0, 0))))
    port = _to_port(ResNet(pcfg.backbone_config), flat, "resnet")
    set_compute_dtype(port, torch.bfloat16)
    stem = []
    hook = port.res_layers[0].register_forward_pre_hook(lambda m, a: stem.append(a[0]))
    with torch.inference_mode():
        got = port(torch.from_numpy(x).bfloat16().permute(0, 3, 1, 2))
    hook.remove()
    assert stem[0].dtype == torch.bfloat16
    np.testing.assert_allclose(stem[0].float().permute(0, 2, 3, 1).numpy(), stem_ref, rtol=0,
                               atol=BF16_TOL * np.abs(stem_ref).max(), err_msg="stem")
    for k in ("res2", "res3", "res4", "res5"):
        r = np.asarray(ref[k], np.float32)
        assert got[k].dtype == torch.bfloat16 and ref[k].dtype == jnp.bfloat16, k
        np.testing.assert_allclose(got[k].float().permute(0, 2, 3, 1).numpy(), r, rtol=0,
                                   atol=BF16_TOL * np.abs(r).max(), err_msg=k)


# --------------------------------------------------------------------------- rtmo
@pytest.fixture(scope="module")
def rtmo():
    """Tiny rtmo-s: the port's seeded init carried into the JAX tree and
    perturbed (as tests/test_torch_rtmo.py), JAX in fp32 and bf16, the port in
    fp32 and bf16 (ModelManager.get(dtype=)), two 128² images."""
    pm32 = ModelManager.get("rtmo-s-coco", device="cpu", image_size=RTMO_SIZE, **RTMO_TINY)
    pm16 = ModelManager.get("rtmo-s-coco", device="cpu", image_size=RTMO_SIZE, dtype="bfloat16", **RTMO_TINY)
    tree, _ = convert_state_dict({k: v.numpy() for k, v in pm32.module.state_dict().items()}, "rtmo", verbose=False)
    flat = _perturb_rtmo(_flat(tree), seed=0)
    for pm in (pm32, pm16):
        pm.module.load_state_dict(from_jax_variables(flat, "rtmo"), strict=True)
    jcfg = JaxConfigManager.from_dict("rtmo", pm32.model_info.config)
    x = np.random.default_rng(1).integers(0, 256, (2, RTMO_SIZE, RTMO_SIZE, 3), dtype=np.uint8)
    out = {"x": x, "port32": pm32, "port16": pm16, "flat": flat}
    for name, dtype in (("32", None), ("16", jnp.bfloat16)):
        jm = JaxRTMO(config=jcfg, backbone=JaxBackboneManager.from_config(jcfg.backbone_config), dtype=dtype)
        out[f"jmodel{name}"] = jm
        out[f"jax{name}"] = jax.jit(jm.apply)(unflatten_tree(flat), jnp.asarray(x))
    return out


def _anchor_rows(idx, valid):
    return {int(a): r for r, a in enumerate(idx) if valid[r]}


def test_rtmo_bf16_serving_agrees_with_jax(rtmo):
    x = torch.from_numpy(rtmo["x"])
    with torch.inference_mode():
        po32, pa32 = rtmo["port32"].module(x)
        po16, pa16 = rtmo["port16"].module(x)
    jo32, ja32 = rtmo["jax32"]
    jo16, ja16 = rtmo["jax16"]
    for field in ("cls_scores", "bbox_preds", "kpt_offsets", "kpt_vis", "pose_feats"):
        g16, g32 = getattr(pa16, field).float().numpy(), getattr(pa32, field).numpy()
        r16, r32 = np.asarray(getattr(ja16, field), np.float32), np.asarray(getattr(ja32, field))
        np.testing.assert_allclose(g16, r16, rtol=0, atol=BF16_TOL * np.abs(r16).max(), err_msg=field)
        d_port, d_jax = np.abs(g16 - g32).max(), np.abs(r16 - r32).max()
        assert d_port <= 2 * d_jax + 1e-3, f"{field}: port moved {d_port:.3e} from fp32, JAX {d_jax:.3e}"

    # detections: NMS on bf16 candidates may keep other anchors; compare the
    # anchors both runs keep, found by the boxes each kept slot holds
    with torch.inference_mode():
        runs = {}
        for name, pm in (("16", rtmo["port16"]), ("32", rtmo["port32"])):
            aux = pm.module.raw_outputs(x)
            cand, scores, _ = pm.module.candidates(aux)
            cfg = pm.config
            idx, valid, _ = topk_nms(cand, scores, cfg.nms_pre_topk, cfg.nms_thr, cfg.max_detections, cfg.score_thr)
            runs[name] = (cand.numpy(), idx.numpy(), valid.numpy())
    for b in range(x.shape[0]):
        per = {}
        for name, jo, po in (("16", jo16, po16), ("32", jo32, po32)):
            cand, idx, valid = runs[name]
            jvalid = np.asarray(jo.scores)[b] > 0
            dist = np.abs(np.asarray(jo.boxes)[b][:, None, :] - cand[b][None]).max(-1)
            jidx = dist.argmin(-1)
            per[name] = (_anchor_rows(idx[b], valid[b]), _anchor_rows(jidx, jvalid), po, jo)
        common = set(per["16"][0]) & set(per["16"][1]) & set(per["32"][0]) & set(per["32"][1])
        assert len(common) >= 1, f"image {b}: no detection kept in both dtypes by both packages"
        for field in ("scores", "boxes", "keypoints", "keypoints_scores"):
            vals = {}
            for name in ("16", "32"):
                prow, jrow, po, jo = per[name]
                vals[name] = (np.stack([getattr(po, field).float().numpy()[b][prow[a]] for a in sorted(common)]),
                              np.stack([np.asarray(getattr(jo, field))[b][jrow[a]] for a in sorted(common)]))
                assert getattr(po, field).dtype == torch.float32, field
            (p16, j16), (p32, j32) = vals["16"], vals["32"]
            scale = np.abs(j16).max() if field in ("boxes", "keypoints") else 1.0
            tol = KEYPOINT_BF16_TOL if field == "keypoints" else BF16_TOL
            np.testing.assert_allclose(p16, j16, rtol=0, atol=tol * scale, err_msg=f"image {b} {field}")
            d_port, d_jax = np.abs(p16 - p32).max(), np.abs(j16 - j32).max()
            assert d_port <= 2 * d_jax + 2.0**-8 * scale, f"image {b} {field}: port {d_port:.3e}, JAX {d_jax:.3e}"


def test_rtmo_bf16_dtype_map_matches_flax(rtmo):
    """The dtypes of the Focus stem, a ConvModule, an AIFI LayerNorm, the
    head's raw level output, DCC's GAU and the outputs, port against flax."""
    (jout, _), state = _apply_capturing(rtmo["jmodel16"], rtmo["flat"], rtmo["x"])
    inter = state["intermediates"]
    want = {
        "stem": inter["backbone"]["stem"]["__call__"][0].dtype,
        "convmodule": inter["neck"]["lateral_convs_0"]["__call__"][0].dtype,
        "aifi_ln": inter["neck"]["encoder_0_layers_0"]["norm2"]["__call__"][0].dtype,
        "gau": inter["dcc"]["gau"]["__call__"][0].dtype,
    }
    pm = rtmo["port16"].module
    points = {
        "stem": pm.backbone.stem,
        "convmodule": pm.neck.lateral_convs[0],
        "aifi_ln": pm.neck.encoder[0]["layers"][0].norms[1],
        "gau": pm.head["dcc"].gau,
    }
    got, out = _port_dtypes(pm, torch.from_numpy(rtmo["x"]), points, object())
    to_torch = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}
    assert got == {k: to_torch[jnp.dtype(v)] for k, v in want.items()}
    assert want["stem"] == want["convmodule"] == want["gau"] == jnp.bfloat16 and want["aifi_ln"] == jnp.float32
    for field in ("scores", "boxes", "keypoints", "keypoints_scores"):
        assert getattr(jout, field).dtype == jnp.float32 and getattr(out, field).dtype == torch.float32, field
    assert all(p.dtype == torch.float32 for p in pm.parameters())


@pytest.mark.parametrize("name", ["fai-detr-l-coco", "rtmo-s-coco", "rtmo-m-coco", "rtmo-l-coco"])
def test_model_manager_bf16_builds_each_registry_model(name):
    """``ModelManager.get(name, dtype="bfloat16")`` at full width (64² images):
    fp32 parameters and statistics, every compute-dtype layer in bf16, and a
    forward whose outputs are fp32 and finite."""
    from focoos_tpu_torch.nn.layers.common import ComputeDtype

    model = ModelManager.get(name, device="cpu", image_size=64, dtype="bfloat16")
    assert model.dtype == torch.bfloat16 and model.compute_dtype == "bfloat16"
    assert all(t.dtype == torch.float32 for t in model.module.state_dict().values() if t.is_floating_point())
    layers = [m for m in model.module.modules() if isinstance(m, ComputeDtype)]
    assert layers and all(m.compute_dtype == torch.bfloat16 for m in layers)
    x = np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    out = model.forward(x)
    floats = {k: v for k, v in vars(out).items() if isinstance(v, torch.Tensor) and v.is_floating_point()}
    assert floats and all(v.dtype == torch.float32 and bool(torch.isfinite(v).all()) for v in floats.values())
    with pytest.raises(ValueError):
        ModelManager.get(name, device="cpu", image_size=64, dtype="float16")


# --------------------------------------------------------------------------- MSDA backward, top-k
def test_plain_msda_backward_bf16_returns_value_dtype():
    """The plain backward (and the wrapper on the CPU) in bf16: d value in
    value's dtype, d loc and d aw fp32, within bf16 rounding of the fp32
    reference: 2^-6 × max|ref| (the plain version samples, weights and sums
    in bf16, rounding at each step where the card kernel rounds once)."""
    rng = np.random.default_rng(3)
    ss = ((6, 5), (3, 4))
    b, lq, hh, d, p = 2, 9, 2, 8, 3
    v = torch.from_numpy(rng.uniform(-0.5, 0.5, (b, sum(h * w for h, w in ss), hh, d)).astype(np.float32))
    loc = torch.from_numpy(rng.uniform(-0.2, 1.2, (b, lq, hh, len(ss), p, 2)).astype(np.float32))
    aw = torch.softmax(torch.from_numpy(rng.standard_normal((b, lq, hh, len(ss) * p)).astype(np.float32)), -1)
    aw = aw.reshape(b, lq, hh, len(ss), p)
    grad = torch.from_numpy(rng.standard_normal((b, lq, hh * d)).astype(np.float32))
    ref = ms_deform_attn_backward_reference(v, ss, loc, aw, grad)
    for got in (ms_deform_attn_backward_reference(v.bfloat16(), ss, loc, aw, grad.bfloat16()),
                msda_backward(v.bfloat16(), ss, loc, aw, grad.bfloat16())):
        assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.float32]
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.float().numpy(), r.numpy(), rtol=0, atol=2.0**-6 * float(r.abs().max()))


def test_topk_helper_matches_jax_on_ties():
    """``jax.lax.top_k`` returns equal values lower index first; torch.topk
    did not on [1, 3, 3, 2, 3] (it gave [2, 4, 1] on the CPU)."""
    x = np.array([1, 3, 3, 2, 3], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(x), 3)[1])
    assert want.tolist() == [1, 2, 4]
    assert torch.topk(torch.from_numpy(x), 3).indices.tolist() != want.tolist()  # the fault fixed
    assert topk_lowest_index_first(torch.from_numpy(x), 3)[1].tolist() == want.tolist()
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(rng.integers(0, 6, (4, 300)).astype(np.float32)).to(dtype)  # many ties
        vals, idx = topk_lowest_index_first(t, 50, dim=1)
        jv, ji = jax.lax.top_k(jnp.asarray(t.float().numpy()), 50)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.float().numpy(), np.asarray(jv))


def test_topk_sites_break_ties_as_jax():
    """select_queries, _decode_topk and topk_nms on inputs full of exact ties."""
    torch.manual_seed(0)
    pred = TransformerPredictor(num_classes=3, in_channels=[8, 8, 8], hidden_dim=8, num_queries=6, nhead=2,
                                dec_layers=1, dim_feedforward=16).eval()
    with torch.no_grad():  # every anchor scores the bias: all tied
        pred.enc_score_classifier.weight.zero_()
        pred.enc_score_classifier.bias.fill_(0.5)
        memory = torch.randn(2, 4 * 4 + 2 * 2 + 1, 8)
        idx = pred.select_queries(memory, [(1, 1), (2, 2), (4, 4)])[0]
    scores = jnp.full((2, 21), 0.5, jnp.float32)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jax.lax.top_k(scores, 6)[1]))

    rng = np.random.default_rng(1)
    logits = (rng.integers(0, 4, (2, 7, 5)) / 4).astype(np.float32)
    boxes = rng.random((2, 7, 4), np.float32)
    for g, r in zip(_decode_topk(torch.from_numpy(logits), torch.from_numpy(boxes), 12),
                    jax_decode_topk(jnp.asarray(logits), jnp.asarray(boxes), 12)):
        np.testing.assert_array_equal(g, np.asarray(r))

    xy = rng.uniform(0, 100, (2, 40, 2))
    nboxes = np.concatenate([xy, xy + rng.uniform(5, 30, (2, 40, 2))], -1).astype(np.float32)
    nscores = (rng.integers(0, 5, (2, 40)) / 5).astype(np.float32)  # ties and zeros
    got = topk_nms(torch.from_numpy(nboxes), torch.from_numpy(nscores), 25, 0.5, 10, 0.1)
    ref = jax.vmap(lambda bx, sc: jax_topk_nms(bx, sc, 25, 0.5, 10, 0.1))(jnp.asarray(nboxes), jnp.asarray(nscores))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
