"""Port parity for fai-detr-m's STDC backbone and the fai-detr-m model: the
port (focoos_tpu_torch) and the JAX package run the same numpy weights and
inputs on the CPU, in fp32 unless named.

The model is a tiny fai-detr-m: the registry card's shape (STDC backbone, no
AIFI encoder layer, an encoder narrower than the decoder) cut to a narrow
STDC (base 16, layers 2/2/2), a 32-wide encoder, a 64-wide decoder of 2
layers, 20 queries, at 96². Weights: the port's seeded init carried into
the JAX tree by ``torch_convert`` and perturbed as in
tests/test_torch_fai_detr.py, then loaded back strictly.

Tolerances: features 1e-4 × max|ref| (fp32 convolutions summed in another
order through ~20 layers); running statistics 1e-5 × max|ref| of each tensor
(a batch mean or variance sums B·H·W values: measured up to 3.9e-6, and a
mean near 0 misses any relative bound); the forward's outputs ``AUX_TOL``.

Gradients. The backbone and the hybrid encoder under a fixed cotangent:
1e-4 × max|ref| of each tensor (measured 4.3e-5), the JAX side's BatchNorm
statistics taken with the two-pass variance as the port takes them (flax's
default E[x²] - E[x]² cancels in fp32: with it the last res5 block's kernel
gradient differs by 6.6e-2 of its max, at every thread count). One whole
train step: losses rtol 1e-5 (measured 2.3e-6 on the two threads the test
runs on) and the gradient norm rtol 1e-4; each gradient tensor 5e-4 × its
max|ref|. The step's fp32 differences are chaotic, not a formula's: on 1, 2,
4 and 8 threads the port's own results move by as much as they differ from
JAX, the worst tensor measuring 1.7e-4, 1.1e-4, 1.3e-4 and 2.4e-4 and the
gradient norm 2.1e-5, 8.9e-6, 3.1e-5 and 5.9e-5 (the train-mode BatchNorms
over 18 values at res5 and the decoder's refinements amplify them; flax's
two-pass variance does not shrink them). The tensors whose gradient
vanishes in exact arithmetic (a key bias under a softmax, a BatchNorm bias
before a train-mode BatchNorm: ``VANISHING``) take 1e-7 × the largest
gradient of the model instead (measured 6e-9).
"""

import re

import flax.linen.normalization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_checkpoint import few_threads  # noqa: F401 (a fixture)
from test_torch_fai_detr import AUX_TOL, NUM_CLASSES, SIZE, _flat, _images, _perturb
from test_torch_train import _jax_targets, _port_targets, _targets

from focoos_tpu.models.fai_detr.config import DETRConfig as JaxDETRConfig
from focoos_tpu.models.fai_detr.loss import make_loss_fn as jax_make_loss_fn
from focoos_tpu.models.fai_detr.modelling import FAIDetr as JaxFAIDetr
from focoos_tpu.models.fai_detr.modelling import HybridEncoder as JaxHybridEncoder
from focoos_tpu.nn.backbone.stdc import STDC as JaxSTDC
from focoos_tpu.nn.backbone.stdc import STDCConfig as JaxSTDCConfig
from focoos_tpu.trainer.solver import leaf_hyperparams
from focoos_tpu.utils.checkpoint import unflatten_tree
from focoos_tpu.utils.torch_convert import convert_state_dict
from focoos_tpu_torch import ModelManager
from focoos_tpu_torch.models.fai_detr.config import DETRConfig
from focoos_tpu_torch.models.fai_detr.loss import make_loss_fn
from focoos_tpu_torch.models.fai_detr.modelling import FAIDetr
from focoos_tpu_torch.nn.backbone.stdc import STDC, STDCConfig
from focoos_tpu_torch.nn.layers.common import BatchNorm, set_compute_dtype
from focoos_tpu_torch.ports import TrainerArgs
from focoos_tpu_torch.trainer import trainer as trainer_mod
from focoos_tpu_torch.trainer.solver import param_hyperparams
from focoos_tpu_torch.utils.weights import from_jax_variables, to_jax_variables

FEATURE_TOL = 1e-4  # × max|ref|
STATS_TOL = 1e-5  # × max|ref| of each statistics tensor
LOSS_RTOL = 1e-5
ENCODER_GRAD_TOL = 1e-4  # × max|ref| of each gradient tensor of the backbone and encoder
GRAD_TOL = 5e-4  # × max|ref| of each gradient tensor of one train step
GRAD_NORM_RTOL = 1e-4
GRAD_FLOOR = 1e-7  # × the largest gradient of the model, for the VANISHING tensors
VANISHING = re.compile(r"/(pixel_decoder/input_proj_\d+_bn/bias|self_attn/k_proj/bias)$")
STDC_TINY = dict(base=16, layers=[2, 2, 2], block_num=4, use_pretrained=False)
M_TINY = dict(num_classes=NUM_CLASSES, num_queries=20, transformer_predictor_dec_layers=2,
              pixel_decoder_num_encoder_layers=0, pixel_decoder_feat_dim=32, pixel_decoder_out_dim=32,
              head_out_dim=32, transformer_predictor_hidden_dim=64, transformer_predictor_out_dim=64,
              pixel_decoder_dim_feedforward=64, transformer_predictor_dim_feedforward=128)


def _to_port(module, flat, family):
    module.load_state_dict(from_jax_variables(flat, family), strict=True)
    return module


# --------------------------------------------------------------------------- STDC
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("block_type", ["cat", "add"])
def test_stdc_features_match_jax(block_type, train):
    """res2-res5 at an odd size (67x75: every stride-2 conv and the avg-pool
    see odd edges); in train mode (batch statistics) also every running
    statistic the step moved."""
    kw = dict(STDC_TINY, block_type=block_type)
    jmodel = JaxSTDC(config=JaxSTDCConfig(**kw))
    x = np.random.default_rng(3).standard_normal((2, 67, 75, 3)).astype(np.float32)
    flat = _perturb(_flat(jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(x[:1]))), seed=4)
    port = _to_port(STDC(STDCConfig(**kw)), flat, "stdc").train(train)
    if train:
        ref, new = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))(
            unflatten_tree(flat), jnp.asarray(x))
    else:
        ref = jax.jit(jmodel.apply)(unflatten_tree(flat), jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert sorted(got) == sorted(ref) == ["res2", "res3", "res4", "res5"]
    assert {k: s.channels for k, s in port.output_shape().items()} == {k: v.shape[-1] for k, v in ref.items()}
    for k in ref:
        r = np.asarray(ref[k])
        g = got[k].permute(0, 2, 3, 1).numpy()
        assert g.shape == r.shape, k
        np.testing.assert_allclose(g, r, rtol=0, atol=FEATURE_TOL * np.abs(r).max(), err_msg=k)
    if train:
        want = from_jax_variables(_flat({"batch_stats": new["batch_stats"]}), "stdc")
        sd = port.state_dict()
        moved = [k for k in want if k.endswith(("running_mean", "running_var"))]
        assert len(moved) == 2 * sum(isinstance(m, BatchNorm) for m in port.modules())
        for k in moved:
            r = want[k].numpy()
            np.testing.assert_allclose(sd[k].numpy(), r, rtol=0, atol=STATS_TOL * np.abs(r).max(), err_msg=k)


# --------------------------------------------------------------------------- fai-detr-m
def _configs():
    jcfg = JaxDETRConfig(backbone_config=JaxSTDCConfig(**STDC_TINY), **M_TINY)
    pcfg = DETRConfig(backbone_config=STDCConfig(**STDC_TINY), **M_TINY)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def tiny_m():
    """The JAX module, the perturbed flat weights (in the JAX tree's exact
    keys and shapes) and the port module loaded from them strictly."""
    jcfg, pcfg = _configs()
    jmodel = JaxFAIDetr(config=jcfg, backbone=JaxSTDC(config=jcfg.backbone_config))
    abstract = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    shapes = {"/".join(str(k.key) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_leaves_with_path(abstract)}
    port = FAIDetr(pcfg, STDC(pcfg.backbone_config))
    port.init_weights(torch.Generator().manual_seed(0))
    tree, unmatched = convert_state_dict({k: v.numpy() for k, v in port.state_dict().items()}, "fai_detr",
                                         verbose=False)
    assert unmatched == []
    flat = _perturb(_flat(tree), seed=0)
    assert {k: v.shape for k, v in flat.items()} == shapes
    pmodel = _to_port(FAIDetr(pcfg, STDC(pcfg.backbone_config)), flat, "fai_detr").eval()
    return dict(jmodel=jmodel, jcfg=jcfg, pcfg=pcfg, flat=flat, pmodel=pmodel)


def test_fai_detr_m_has_no_aifi_and_the_cards_widths():
    """The registry card at full width: STDC-large, no AIFI layer, a
    128-wide encoder feeding a 256-wide decoder of 3 layers."""
    model = ModelManager.get("fai-detr-m-coco", device="cpu", init_weights=False)
    m = model.module
    assert isinstance(m.pixel_decoder.backbone, STDC) and len(m.pixel_decoder.encoder) == 0
    assert [p[0].in_channels for p in m.pixel_decoder.input_proj] == [256, 512, 1024]
    assert m.pixel_decoder.feat_dim == 128 and len(m.predictor.decoder["layers"]) == 3
    assert [p.conv.in_channels for p in m.predictor.input_proj] == [128] * 3
    assert m.predictor.input_proj[0].conv.out_channels == 256
    assert trainer_mod._freeze_prefixes(model) == ()  # STDC has no freeze_at


def test_fai_detr_m_forward_matches_jax(tiny_m):
    x = _images(1)
    jout, jaux = jax.jit(tiny_m["jmodel"].apply)(unflatten_tree(tiny_m["flat"]), jnp.asarray(x))
    with torch.inference_mode():
        pout, paux = tiny_m["pmodel"](torch.from_numpy(x))
    for field in ("dec_logits", "dec_boxes", "enc_logits", "enc_boxes"):
        r, g = np.asarray(getattr(jaux, field)), getattr(paux, field).numpy()
        assert g.shape == r.shape, field
        np.testing.assert_allclose(g, r, rtol=0, atol=AUX_TOL, err_msg=field)
    np.testing.assert_allclose(pout.boxes.numpy(), np.asarray(jout.boxes), rtol=0, atol=AUX_TOL)
    np.testing.assert_allclose(pout.logits.numpy(), np.asarray(jout.logits), rtol=0, atol=AUX_TOL)


def test_fai_detr_m_weights_roundtrip_through_torch_convert(tiny_m):
    """torch_convert maps the port's state_dict onto exactly the JAX tree with
    no key unmatched, and to_jax_variables writes the same flat arrays."""
    sd = {k: v.numpy() for k, v in tiny_m["pmodel"].state_dict().items()}
    tree, unmatched = convert_state_dict(sd, "fai_detr", verbose=False)
    assert unmatched == []
    flat = tiny_m["flat"]
    for back in (_flat(tree), to_jax_variables(sd, "fai_detr")):
        assert sorted(back) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


@pytest.mark.usefixtures("few_threads")
def test_fai_detr_m_train_step_matches_jax(tiny_m):
    """One train-mode forward, criterion and backward: every loss key and
    every gradient, and the running statistics the step moved."""
    images, tgt = _images(2), _targets(3)
    jvars = unflatten_tree(tiny_m["flat"])
    loss_fn = jax_make_loss_fn(tiny_m["jmodel"], tiny_m["jcfg"])
    batch = (jnp.asarray(images), _jax_targets(*tgt))

    def total_fn(params):
        return loss_fn({"params": params, "batch_stats": jvars["batch_stats"]}, batch, jax.random.PRNGKey(0))

    (total, (losses, state)), grads = jax.jit(jax.value_and_grad(total_fn, has_aux=True))(jvars["params"])
    module = _to_port(FAIDetr(tiny_m["pcfg"], STDC(tiny_m["pcfg"].backbone_config)), tiny_m["flat"], "fai_detr")
    module.train()
    ptotal, plosses = make_loss_fn(module, tiny_m["pcfg"])(torch.from_numpy(images), _port_targets(*tgt))
    ptotal.backward()
    assert sorted(plosses) == sorted(losses)
    for k in losses:
        np.testing.assert_allclose(float(plosses[k].detach()), float(losses[k]), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(ptotal.detach()), float(total), rtol=LOSS_RTOL)
    got = to_jax_variables({n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
                            for n, p in module.named_parameters()}, "fai_detr")
    ref = _flat({"params": grads})
    assert sorted(got) == sorted(ref)
    norm = lambda g: np.sqrt(sum(float(np.sum(np.square(v, dtype=np.float64))) for v in g.values()))  # noqa: E731
    np.testing.assert_allclose(norm(got), norm(ref), rtol=GRAD_NORM_RTOL, err_msg="grad_norm")
    floor = GRAD_FLOOR * max(np.abs(r).max() for r in ref.values())
    assert len([k for k in ref if VANISHING.search(k)]) == 3 + 2  # the input projections', a key bias a layer
    for k, r in ref.items():
        tol = floor if VANISHING.search(k) else GRAD_TOL * np.abs(r).max()
        np.testing.assert_allclose(got[k], r, rtol=0, atol=tol, err_msg=f"grad {k}")
    stats = to_jax_variables({k: v.detach().numpy() for k, v in module.state_dict().items()}, "fai_detr")
    for k, r in _flat({"batch_stats": state["batch_stats"]}).items():
        np.testing.assert_allclose(stats[k], r, rtol=0, atol=STATS_TOL * np.abs(r).max(), err_msg=k)


@pytest.mark.usefixtures("few_threads")
def test_fai_detr_m_encoder_gradients_match_jax(tiny_m, monkeypatch):
    """The backbone and the hybrid encoder in train mode, the gradient of
    every parameter under a fixed random cotangent on [p5, p4, p3], against
    JAX's VJP of its ``HybridEncoder`` over the same STDC. JAX's BatchNorms
    take the two-pass variance here (see the module docstring)."""
    real = flax.linen.normalization._compute_stats
    monkeypatch.setattr(flax.linen.normalization, "_compute_stats",
                        lambda *a, **k: real(*a, **dict(k, use_fast_variance=False)))
    cfg, tree = tiny_m["jcfg"], unflatten_tree(tiny_m["flat"])
    enc = JaxHybridEncoder(backbone=JaxSTDC(config=cfg.backbone_config), feat_dim=cfg.pixel_decoder_feat_dim,
                           out_dim=cfg.pixel_decoder_out_dim, nhead=cfg.pixel_decoder_nhead,
                           dim_feedforward=cfg.pixel_decoder_dim_feedforward,
                           num_encoder_layers=cfg.pixel_decoder_num_encoder_layers,
                           expansion=cfg.pixel_decoder_expansion)
    params = dict(tree["params"]["pixel_decoder"], backbone=tree["params"]["backbone"])
    stats = dict(tree["batch_stats"]["pixel_decoder"], backbone=tree["batch_stats"]["backbone"])
    x = np.random.default_rng(3).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)

    def feats(p):
        return enc.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), True, mutable=["batch_stats"])[0][1]

    ref_feats, vjp = jax.vjp(feats, params)
    rng = np.random.default_rng(5)
    cts = [rng.standard_normal(np.shape(f)).astype(np.float32) for f in ref_feats]
    (grads,) = jax.jit(vjp)([jnp.asarray(c) for c in cts])
    module = _to_port(FAIDetr(tiny_m["pcfg"], STDC(tiny_m["pcfg"].backbone_config)), tiny_m["flat"], "fai_detr")
    out = module.train().pixel_decoder(torch.from_numpy(x).permute(0, 3, 1, 2))
    for o, r in zip(out, ref_feats):
        r = np.asarray(r)
        np.testing.assert_allclose(o.detach().permute(0, 2, 3, 1).numpy(), r, rtol=0, atol=FEATURE_TOL * np.abs(r).max())
    torch.autograd.backward(out, [torch.from_numpy(c).permute(0, 3, 1, 2) for c in cts])
    got = to_jax_variables({n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
                            for n, p in module.named_parameters()}, "fai_detr")
    ref = _flat({"params": {"pixel_decoder": {k: v for k, v in grads.items() if k != "backbone"},
                            "backbone": grads["backbone"]}})
    assert sorted(k for k in got if not k.startswith("params/predictor/")) == sorted(ref)
    floor = GRAD_FLOOR * max(np.abs(r).max() for r in ref.values())
    for k, r in ref.items():
        tol = floor if VANISHING.search(k) else ENCODER_GRAD_TOL * np.abs(r).max()
        np.testing.assert_allclose(got[k], r, rtol=0, atol=tol, err_msg=f"grad {k}")


def test_fai_detr_m_bf16_dtype_map_matches_flax(tiny_m):
    """The dtypes of the STDC stem, a Cat bottleneck and its avd BatchNorm,
    res5, an encoder ConvNorm, a decoder LayerNorm, the MSDA inputs and the
    outputs, port (compute dtype bf16) against flax's capture_intermediates."""
    jcfg = tiny_m["jcfg"]
    j16 = JaxFAIDetr(config=jcfg, backbone=JaxSTDC(config=jcfg.backbone_config), dtype=jnp.bfloat16)
    fn = jax.jit(lambda v, x: j16.apply(v, x, capture_intermediates=True, mutable=["intermediates"]))
    (jout, _), state = fn(unflatten_tree(tiny_m["flat"]), jnp.asarray(_images(1)))
    inter = state["intermediates"]
    bb = inter["backbone"]
    want = {
        "stem": bb["features_0"]["__call__"][0].dtype,
        "cat": bb["features_2"]["__call__"][0].dtype,
        "avd_bn": bb["features_2"]["avd_bn"]["__call__"][0].dtype,
        "res5": bb["features_7"]["__call__"][0].dtype,
        "convnorm": inter["pixel_decoder"]["lateral_convs_0"]["__call__"][0].dtype,
        "decoder_ln": inter["predictor"]["decoder_layers_0"]["norm3"]["__call__"][0].dtype,
    }
    pm = _to_port(FAIDetr(tiny_m["pcfg"], STDC(tiny_m["pcfg"].backbone_config)), tiny_m["flat"], "fai_detr").eval()
    set_compute_dtype(pm, torch.bfloat16)
    feats = pm.pixel_decoder.backbone.features
    points = {"stem": feats[0], "cat": feats[2], "avd_bn": feats[2].avd_layer[1], "res5": feats[7],
              "convnorm": pm.pixel_decoder.lateral_convs[0], "decoder_ln": pm.predictor.decoder["layers"][0].norm3}
    got = {}
    hooks = [m.register_forward_hook(lambda m, a, o, n=n: got.setdefault(n, o.dtype) and None)  # None: output kept
             for n, m in points.items()]
    try:
        with torch.inference_mode():
            out, _ = pm(torch.from_numpy(_images(1)))
    finally:
        for h in hooks:
            h.remove()
    to_torch = {jnp.dtype(jnp.bfloat16): torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}
    assert got == {k: to_torch[jnp.dtype(v)] for k, v in want.items()}
    assert want["stem"] == want["res5"] == want["avd_bn"] == jnp.bfloat16 and want["decoder_ln"] == jnp.float32
    for field in ("boxes", "logits"):
        assert getattr(jout, field).dtype == jnp.float32 and getattr(out, field).dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in pm.parameters())


def test_freeze_bn_policy_matches_jax_on_stdc(tiny_m):
    """lr multiplier and weight decay of every parameter with freeze_bn,
    against leaf_hyperparams(freeze_bn=True): JAX freezes the BatchNorms under
    ``/bn/`` (every ConvX's) and spares STDC's avd_bn and skip BatchNorms and
    the input projections' (ROADMAP Queue 3)."""
    module = tiny_m["pmodel"]
    names = [n for n, _ in module.named_parameters()]
    ids = {n: np.full(tuple(p.shape), i, np.float32) for i, (n, p) in enumerate(module.named_parameters())}
    source = {k: names[int(v.flat[0])] for k, v in
              _flat({"params": convert_state_dict(ids, "fai_detr", verbose=False)[0]["params"]}).items()}
    lr_tree, wd_tree = leaf_hyperparams(unflatten_tree(tiny_m["flat"])["params"], base_wd=0.02, freeze_bn=True)
    hp = param_hyperparams(module, 0.02, freeze_bn=True)
    for i, ref_tree in enumerate((lr_tree, wd_tree)):
        for k, ref in _flat({"params": ref_tree}).items():
            assert hp[source[k]][i] == pytest.approx(float(ref), rel=1e-6), (k, source[k], i)
    spared = [n for n in names if ".avd_layer.1." in n]
    assert spared and all(hp[n][0] > 0 for n in spared)
    assert any(isinstance(m, BatchNorm) for m in module.modules())


def test_trainer_passes_workers_to_the_loader(tmp_path, monkeypatch):
    """FocoosTrainer hands TrainerArgs.workers to build_train_loader."""
    seen = {}

    class Stop(Exception):
        pass

    def fake(dataset, processor, batch_size, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(trainer_mod, "build_train_loader", fake)
    model = ModelManager.get("fai-detr-m-coco", device="cpu", image_size=SIZE, init_weights=False,
                             backbone_config=dict(model_type="stdc", **STDC_TINY), **M_TINY)
    args = TrainerArgs(run_name="w", output_dir=str(tmp_path), batch_size=2, max_iters=1, workers=3,
                       workers_timeout=60)
    with pytest.raises(Stop):
        model.train(args, [])
    assert seen["num_workers"] == 3 and seen["timeout"] == 60 and seen["pin_memory"] is False
