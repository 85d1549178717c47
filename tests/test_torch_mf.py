"""Port parity for the fai_mf (MaskFormer) serving and evaluation slice: the
port (focoos_tpu_torch) and the JAX package run the same numpy weights and
inputs on the CPU, in fp32 unless named.

Two tiny models cut from the registry cards: ``fai-mf-s-coco-ins``
(ResNet-50-D, a 128-wide pixel decoder with three pre-norm res5 layers) with
10 queries, 2 masked decoder layers and 11 classes, at 96² and at an odd
100x76; and ``fai-mf-m-ade`` (STDC) with one res5 layer, the same decoder cut
and 11 classes, at 96². Weights: the port's seeded init carried into the JAX
tree by ``torch_convert`` (no key unmatched, every shape the JAX tree's) and
perturbed as in tests/test_torch_fai_detr.py, then loaded back strictly.

The masked cross-attention's masks are a sign test on predicted masks; where
a prediction is near 0 the two packages may block different keys, so the
forward comparisons carry JAX's masks into the port (``allowed=``), as the
fai-detr tests carry JAX's query selection. Tolerances: every output 1e-4 ×
max|ref| (fp32 summed in another order through ~60 layers); decoded scores
1e-5; labels, boxes, packed bits and label maps equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fai_detr import _flat, _perturb
from test_torch_checkpoint import few_threads_module  # noqa: F401 (an autouse fixture: two threads throughout)

import focoos_tpu.models.fai_mf.modelling as jax_mf_modelling
from focoos_tpu.model_manager import BackboneManager as JaxBackboneManager
from focoos_tpu.model_manager import ConfigManager as JaxConfigManager
from focoos_tpu.models.fai_mf.modelling import FAIMaskFormer as JaxFAIMaskFormer
from focoos_tpu.models.fai_mf.modelling import MultiScaleMaskedTransformerDecoder as JaxDecoder
from focoos_tpu.models.fai_mf.ports import MaskFormerModelOutput as JaxMFOutput
from focoos_tpu.models.fai_mf.processor import MaskFormerProcessor as JaxMFProcessor
from focoos_tpu.models.fai_mf.processor import _device_instance_decode as jax_instance_decode
from focoos_tpu.models.fai_mf.processor import _device_semantic_argmax as jax_semantic_argmax
from focoos_tpu.nn.layers import common as jax_common
from focoos_tpu.ports import DatasetEntry as JaxDatasetEntry
from focoos_tpu.utils.checkpoint import unflatten_tree
from focoos_tpu.utils.torch_convert import convert_state_dict
from focoos_tpu_torch import ModelManager
from focoos_tpu_torch.model_manager import BackboneManager, ConfigManager
from focoos_tpu_torch.models.fai_mf.modelling import FAIMaskFormer, MultiScaleMaskedTransformerDecoder
from focoos_tpu_torch.models.fai_mf.modelling import _attn_allowed_from_masks
from focoos_tpu_torch.models.fai_mf.ports import MaskFormerModelOutput
from focoos_tpu_torch.models.fai_mf.processor import (
    InstanceDecode,
    MaskFormerProcessor,
    SemanticDecode,
    _device_instance_decode,
    _device_semantic_argmax,
    packbits,
)
from focoos_tpu_torch.nn.layers import common
from focoos_tpu_torch.nn.layers.common import set_compute_dtype
from focoos_tpu_torch.ports import DatasetEntry
from focoos_tpu_torch.utils.vision import base64_png_to_mask
from focoos_tpu_torch.utils.weights import from_jax_variables, to_jax_variables

TOL = 1e-4  # × max|ref|
SCORE_TOL = 1e-5
NUM_CLASSES = 11
CARDS = os.path.join(os.path.dirname(__file__), "..", "focoos_tpu_torch", "model_registry")
TINY = {
    "ins": ("fai-mf-s-coco-ins", dict(num_classes=NUM_CLASSES, num_queries=10, transformer_predictor_dec_layers=2)),
    "sem": ("fai-mf-m-ade", dict(num_classes=NUM_CLASSES, num_queries=10, transformer_predictor_dec_layers=2,
                                 pixel_decoder_transformer_layers=1)),
}


def _configs(kind: str):
    card, over = TINY[kind]
    with open(os.path.join(CARDS, f"{card}.json")) as f:
        d = json.load(f)["config"]
    return JaxConfigManager.from_dict("fai_mf", d, **over), ConfigManager.from_dict("fai_mf", d, **over)


def _jax_model(jcfg, dtype=None):
    return JaxFAIMaskFormer(config=jcfg, backbone=JaxBackboneManager.from_config(jcfg.backbone_config), dtype=dtype)


def _port_model(pcfg, flat):
    m = FAIMaskFormer(pcfg, BackboneManager.from_config(pcfg.backbone_config))
    m.load_state_dict(from_jax_variables(flat, "fai_mf"), strict=True)
    return m.eval()


@pytest.fixture(scope="module", params=["ins", "sem"])
def tiny(request):
    """The JAX module, the perturbed flat weights (the JAX tree's exact keys
    and shapes) and the port module loaded from them strictly."""
    jcfg, pcfg = _configs(request.param)
    jmodel = _jax_model(jcfg)
    abstract = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 96, 96, 3), jnp.float32))
    shapes = {"/".join(str(k.key) for k in path): leaf.shape
              for path, leaf in jax.tree_util.tree_leaves_with_path(abstract)}
    port = FAIMaskFormer(pcfg, BackboneManager.from_config(pcfg.backbone_config))
    port.init_weights(torch.Generator().manual_seed(0))
    tree, unmatched = convert_state_dict({k: v.numpy() for k, v in port.state_dict().items()}, "fai_mf",
                                         verbose=False)
    assert unmatched == []
    flat = _perturb(_flat(tree), seed=3)
    assert {k: v.shape for k, v in flat.items()} == shapes
    return dict(kind=request.param, jmodel=jmodel, jcfg=jcfg, pcfg=pcfg, flat=flat, pmodel=_port_model(pcfg, flat))


def _images(seed, hw=(96, 96), b=2):
    return np.random.default_rng(seed).integers(0, 256, (b, *hw, 3), dtype=np.uint8)


def _jax_run(jmodel, flat, x, monkeypatch):
    """JAX's eval forward → (output, aux, pixel decoder's outputs, the
    cross-attention masks each decoder layer used)."""
    real = jax_mf_modelling._attn_allowed_from_masks

    def run(v, x):
        used = []

        def spy(m, hw):
            used.append(real(m, hw))
            return used[-1]

        monkeypatch.setattr(jax_mf_modelling, "_attn_allowed_from_masks", spy)
        (out, aux), state = jmodel.apply(v, x, capture_intermediates=True, mutable=["intermediates"])
        return out, aux, state["intermediates"]["pixel_decoder"]["__call__"][0], used

    try:
        return jax.jit(run)(unflatten_tree(flat), jnp.asarray(x))
    finally:
        monkeypatch.setattr(jax_mf_modelling, "_attn_allowed_from_masks", real)


def _port_run(pmodel, x, allowed):
    seen = {}
    hook = pmodel.pixel_decoder.register_forward_hook(lambda m, a, o: seen.setdefault("fpn", o) and None)
    try:
        with torch.inference_mode():
            out, aux = pmodel(torch.from_numpy(x), allowed=[torch.tensor(np.asarray(a)) for a in allowed])
    finally:
        hook.remove()
    return out, aux, seen["fpn"]


def _close(got: torch.Tensor, ref, what: str) -> None:
    r = np.asarray(ref, np.float32)
    g = got.float().numpy()
    assert g.shape == r.shape, (what, g.shape, r.shape)
    np.testing.assert_allclose(g, r, rtol=0, atol=TOL * max(np.abs(r).max(), 1e-12), err_msg=what)


# --------------------------------------------------------------------------- layers
def test_nearest_resize_and_normalized_position_embedding_match_jax():
    """torch's floor-mapping nearest at odd and integer scales, and the
    normalized sine embedding, against the JAX functions."""
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 5)).astype(np.float32)
    for size in ((7, 9), (8, 10), (3, 13)):
        ref = jax_common.nearest_resize_torch(jnp.asarray(x.transpose(0, 2, 3, 1)), size)
        got = common.nearest_resize_torch(torch.from_numpy(x), size)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref))
    for h, w, f in ((3, 5, 16), (7, 4, 64)):
        ref = jax_common.sine_position_embedding_2d_normalized(h, w, f)
        np.testing.assert_allclose(common.sine_position_embedding_2d_normalized(h, w, f).numpy(), np.asarray(ref),
                                   rtol=0, atol=1e-6)


def _block_params(jmod, *args, seed=0, **kw):
    variables = jax.jit(lambda k: jmod.init(k, *args, **kw))(jax.random.PRNGKey(seed))
    return {k.removeprefix("params/"): v for k, v in _perturb(_flat(variables), seed).items()}


def _load_block(port, flat):
    """A JAX block's flat params → the port block (q/k/v merged, kernels transposed)."""
    sd = {}
    for k, v in from_jax_variables({f"params/predictor/transformer_ffn_layers_0/{k}": v for k, v in flat.items()},
                                   "fai_mf").items():
        sd[k.removeprefix("head.predictor.transformer_ffn_layers.0.")] = v
    port.load_state_dict(sd, strict=True)
    return port.eval()


@pytest.mark.parametrize("pre_norm", [True, False], ids=["pre", "post"])
def test_attention_blocks_match_jax(pre_norm):
    """MultiHeadAttention with a boolean mask (one query blocked everywhere
    but one key), the encoder layer, and the self-attention, cross-attention
    and FFN blocks, pre-norm and post-norm."""
    rng = np.random.default_rng(1)
    b, q, k, d, h = 2, 5, 7, 32, 4
    tgt = rng.standard_normal((b, q, d)).astype(np.float32)
    mem = rng.standard_normal((b, k, d)).astype(np.float32)
    pos = rng.standard_normal((1, k, d)).astype(np.float32)
    qpos = rng.standard_normal((b, q, d)).astype(np.float32)
    mask = rng.random((b, 1, q, k)) > 0.4
    mask[:, :, 0] = False
    mask[:, :, 0, 3] = True
    t = torch.from_numpy
    cases = [
        (jax_common.TransformerEncoderLayer(d, h, 64, normalize_before=pre_norm),
         common.TransformerEncoderLayer(d, h, 64, normalize_before=pre_norm), (tgt,), dict(pos_embed=qpos)),
        (jax_common.SelfAttentionBlock(d, h, normalize_before=pre_norm),
         common.SelfAttentionBlock(d, h, normalize_before=pre_norm), (tgt,),
         dict(query_pos=qpos, attn_mask=mask[..., :q])),
        (jax_common.CrossAttentionBlock(d, h, normalize_before=pre_norm),
         common.CrossAttentionBlock(d, h, normalize_before=pre_norm), (tgt, mem),
         dict(pos=pos, query_pos=qpos, attn_mask=mask)),
        (jax_common.FFNBlock(d, 64, normalize_before=pre_norm),
         common.FFNBlock(d, 64, normalize_before=pre_norm), (tgt,), {}),
    ]
    for jmod, pmod, args, kw in cases:
        flat = _block_params(jmod, *map(jnp.asarray, args), **{k_: jnp.asarray(v) for k_, v in kw.items()})
        ref = jmod.apply(unflatten_tree({f"params/{k_}": v for k_, v in flat.items()}), *map(jnp.asarray, args),
                         **{k_: jnp.asarray(v) for k_, v in kw.items()})
        with torch.inference_mode():
            got = _load_block(pmod, flat)(*map(t, args), **{k_: t(np.asarray(v)) for k_, v in kw.items()})
        _close(got, ref, type(pmod).__name__)


def test_attn_allowed_from_masks_matches_jax():
    """Bilinear downsample, the sign test and "all blocked → allow all", on
    masks with whole queries negative and none near 0."""
    rng = np.random.default_rng(2)
    m = rng.standard_normal((2, 6, 24, 20)).astype(np.float32)
    m = np.where(np.abs(m) < 0.05, 0.5, m)
    m[0, 1] = -np.abs(m[0, 1]) - 0.1  # blocks everything
    m[1, 4] = np.abs(m[1, 4]) + 0.1  # blocks nothing
    for hw in ((6, 5), (12, 10), (5, 7)):
        ref = np.asarray(jax_mf_modelling._attn_allowed_from_masks(jnp.asarray(m), hw))
        got = _attn_allowed_from_masks(torch.from_numpy(m), hw).numpy()
        np.testing.assert_array_equal(got, ref)
        assert got[0, 0, 1].all() and got[1, 0, 4].all()


# --------------------------------------------------------------------------- model
def test_cards_build_at_full_width():
    """fai-mf-l-coco-ins and fai-mf-l-ade from the registry: ResNet-101-D,
    the cards' decoder widths and depths (built on the meta device: no
    memory, no init); CUDA unless the CPU is named."""
    ins = ModelManager.get("fai-mf-l-coco-ins", device="meta").module
    assert ins.pixel_decoder.backbone.config.depth == 101 and ins.pixel_decoder.transformer_layers == 6
    assert all(layer.normalize_before for layer in ins.pixel_decoder.transformer.encoder.layers)
    assert ins.predictor.dec_layers == 9 and ins.predictor.num_queries == 100
    assert ins.predictor.forward_prediction_heads.classifier.out_features == 81
    assert ins.pixel_decoder.mask_features.out_channels == 256
    ade = ModelManager.get("fai-mf-l-ade", device="meta").module
    assert ade.pixel_decoder.transformer_layers == 0 and not hasattr(ade.pixel_decoder, "transformer")
    assert ade.predictor.dec_layers == 6 and ade.pixel_decoder.mask_features.out_channels == 128
    assert ade.predictor.forward_prediction_heads.classifier.out_features == 151
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ModelManager.get("fai-mf-l-coco-ins")


def test_weights_roundtrip_through_torch_convert(tiny):
    """torch_convert maps the port's state_dict onto exactly the JAX tree
    with no key unmatched, and to_jax_variables writes the same flat arrays."""
    sd = {k: v.numpy() for k, v in tiny["pmodel"].state_dict().items()}
    tree, unmatched = convert_state_dict(sd, "fai_mf", verbose=False)
    assert unmatched == []
    flat = tiny["flat"]
    for back in (_flat(tree), to_jax_variables(sd, "fai_mf")):
        assert sorted(back) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


@pytest.mark.parametrize("hw", [(96, 96), (100, 76)], ids=["96", "100x76"])
def test_eval_forward_matches_jax(tiny, hw, monkeypatch):
    """The pixel decoder's mask features and three levels, every decoder
    layer's class logits and masks, and the eval outputs (class
    probabilities; masks upsampled to the input), with JAX's attention masks
    carried in. 100x76 gives odd levels (res5 4x3 → res4 7x5): the FPN's
    floor-mapping nearest."""
    x = _images(5, hw)
    jout, jaux, (jmf, jms), used = _jax_run(tiny["jmodel"], tiny["flat"], x, monkeypatch)
    pout, paux, (pmf, pms) = _port_run(tiny["pmodel"], x, used)
    _close(pmf.permute(0, 2, 3, 1), jmf, "mask_features")
    for i, (g, r) in enumerate(zip(pms, jms)):
        _close(g.permute(0, 2, 3, 1), r, f"multi_scale[{i}]")
    _close(paux.logits, jaux.logits, "aux.logits")
    _close(paux.masks, jaux.masks, "aux.masks")
    _close(pout.logits, jout.logits, "logits")
    _close(pout.masks, jout.masks, "masks")
    assert pout.masks.shape[-2:] == hw
    # the port's masks carried in are the ones it used
    assert all(torch.equal(a, torch.tensor(np.asarray(u))) for a, u in zip(paux.allowed, used))


def test_masked_decoder_with_a_fully_blocked_query_matches_jax(monkeypatch):
    """The decoder alone on positive mask features with the mask head's bias
    shifted so that about half of the queries' first masks are negative
    everywhere (those attend everywhere) and the others are not; JAX's masks
    carried in."""
    rng = np.random.default_rng(4)
    hidden, q, nc = 32, 8, 5
    xs = [rng.standard_normal((2, s, s, hidden)).astype(np.float32) for s in (3, 6, 12)]
    mf = (np.abs(rng.standard_normal((2, 24, 24, hidden))) + 0.5).astype(np.float32)
    jdec = JaxDecoder(num_classes=nc, hidden_dim=hidden, mask_dim=hidden, num_queries=q, nheads=4, dec_layers=3,
                      dim_feedforward=64)
    args = ([jnp.asarray(a) for a in xs], jnp.asarray(mf))
    base = _perturb(_flat(jax.jit(jdec.init)(jax.random.PRNGKey(7), *args)), seed=7)
    bias_key = "params/forward_prediction_heads/mask_classifier/layers_2/bias"
    # a shift s of every mask-embedding bias lowers a query's mask at p by s·Σ_c mf_c(p): a
    # query is negative everywhere once s > max_p mask(p) / Σ_c mf_c(p); split the queries there
    m0 = np.asarray(jdec.apply(unflatten_tree(base), *args).masks[0])  # [B, Q, 24, 24]
    t = np.sort((m0 / mf.sum(-1)[:, None]).reshape(2 * q, -1).max(-1))
    shift = (t[q - 1] + t[q]) / 2
    flat = dict(base, **{bias_key: base[bias_key] - shift})
    real = jax_mf_modelling._attn_allowed_from_masks
    used = []

    def spy(m, hw):
        used.append(real(m, hw))
        return used[-1]

    monkeypatch.setattr(jax_mf_modelling, "_attn_allowed_from_masks", spy)
    aux = jdec.apply(unflatten_tree(flat), *args)
    monkeypatch.setattr(jax_mf_modelling, "_attn_allowed_from_masks", real)
    all_neg = (np.asarray(aux.masks[0]).reshape(2, q, -1) < 0).all(-1)
    assert all_neg.any() and not all_neg.all()
    assert np.asarray(used[0])[:, 0][all_neg].all()  # a fully blocked query attends everywhere
    pdec = MultiScaleMaskedTransformerDecoder(hidden, nc, hidden, hidden, q, 4, 3, 64)
    sd = from_jax_variables({k.replace("params/", "params/predictor/", 1): v for k, v in flat.items()}, "fai_mf")
    pdec.load_state_dict({k.removeprefix("head.predictor."): v for k, v in sd.items()}, strict=True)
    with torch.inference_mode():
        paux = pdec.eval()([torch.from_numpy(a).permute(0, 3, 1, 2) for a in xs],
                           torch.from_numpy(mf).permute(0, 3, 1, 2),
                           allowed=[torch.tensor(np.asarray(u)) for u in used])
    _close(paux.logits, aux.logits, "logits")
    _close(paux.masks, aux.masks, "masks")


def test_bf16_dtype_map_matches_flax(tiny):
    """The dtypes at named points of a bf16 model, port (compute dtype bf16)
    against flax's capture_intermediates: the backbone's res5, an FPN
    BatchNorm, the mask features, a pre-norm encoder LayerNorm, the decoder's
    cross-attention and its block, the heads' LayerNorm and classifier, and
    the outputs (class probabilities fp32, masks bf16)."""
    x = _images(6)
    j16 = _jax_model(tiny["jcfg"], jnp.bfloat16)
    fn = jax.jit(lambda v, x: j16.apply(v, x, capture_intermediates=True, mutable=["intermediates"]))
    (jout, _), state = fn(unflatten_tree(tiny["flat"]), jnp.asarray(x))
    inter = state["intermediates"]
    pd, pr = inter["pixel_decoder"], inter["predictor"]
    want = {
        "fpn_bn": pd["layer_1_norm"]["__call__"][0].dtype,
        "mask_features": pd["mask_features"]["__call__"][0].dtype,
        "encoder_ln": pd["transformer_layers_0"]["norm1"]["__call__"][0].dtype,
        "transformer_norm": pd["transformer_norm"]["__call__"][0].dtype,
        "cross_attn": pr["transformer_cross_attention_layers_0"]["multihead_attn"]["__call__"][0].dtype,
        "cross_block": pr["transformer_cross_attention_layers_0"]["__call__"][0].dtype,
        "ffn_block": pr["transformer_ffn_layers_1"]["__call__"][0].dtype,
        "decoder_norm": pr["forward_prediction_heads"]["decoder_norm"]["__call__"][0].dtype,
        "classifier": pr["forward_prediction_heads"]["classifier"]["__call__"][0].dtype,
    }
    pm = _port_model(tiny["pcfg"], tiny["flat"])
    set_compute_dtype(pm, torch.bfloat16)
    pdm, prm = pm.pixel_decoder, pm.predictor
    points = {
        "fpn_bn": pdm.layer_1.norm, "mask_features": pdm.mask_features,
        "encoder_ln": pdm.transformer.encoder.layers[0].norm1, "transformer_norm": pdm.transformer.encoder.norm,
        "cross_attn": prm.transformer_cross_attention_layers[0].multihead_attn,
        "cross_block": prm.transformer_cross_attention_layers[0], "ffn_block": prm.transformer_ffn_layers[1],
        "decoder_norm": prm.forward_prediction_heads.decoder_norm,
        "classifier": prm.forward_prediction_heads.classifier,
    }
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
    assert want["mask_features"] == want["cross_block"] == jnp.bfloat16 and want["decoder_norm"] == jnp.float32
    assert jout.masks.dtype == jnp.bfloat16 and out.masks.dtype == torch.bfloat16
    assert jout.logits.dtype == jnp.float32 and out.logits.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in pm.parameters())


# --------------------------------------------------------------------------- decode
def _probs(seed, b=2, q=10, c=NUM_CLASSES, hw=(40, 36)):
    """Class probabilities and mask probabilities, well away from 0.5 and from ties."""
    rng = np.random.default_rng(seed)
    logits = rng.dirichlet(np.ones(c + 1), (b, q))[..., :c].astype(np.float32)
    masks = rng.random((b, q, *hw)).astype(np.float32)
    masks = np.where(np.abs(masks - 0.5) < 1e-3, 0.9, masks).astype(np.float32)
    return logits, masks


def test_packbits_matches_numpy():
    bits = np.random.default_rng(0).random((3, 4, 37)) > 0.5
    np.testing.assert_array_equal(packbits(torch.from_numpy(bits)).numpy(), np.packbits(bits, axis=-1))


@pytest.mark.parametrize("top_k", [7, 100])
def test_device_instance_decode_matches_jax(top_k):
    logits, masks = _probs(0)
    masks[0, 3] = 0.1  # an empty mask: box zeros
    ref = jax_instance_decode(jnp.asarray(logits), jnp.asarray(masks), top_k, 0.5)
    got = _device_instance_decode(torch.from_numpy(logits), torch.from_numpy(masks), top_k, 0.5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=SCORE_TOL, atol=0)
    for name, g, r in zip(("labels", "packed", "boxes"), got[1:], ref[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.uint8 and got[3].dtype == torch.float32


@pytest.mark.parametrize("c", [NUM_CLASSES, 300])
def test_device_semantic_argmax_matches_jax(c):
    logits, masks = _probs(1, c=c)
    ref = np.asarray(jax_semantic_argmax(jnp.asarray(logits), jnp.asarray(masks)))
    got = _device_semantic_argmax(torch.from_numpy(logits), torch.from_numpy(masks)).numpy()
    assert got.dtype == ref.dtype == (np.uint8 if c <= 255 else np.int32)
    np.testing.assert_array_equal(got, ref)


def _processors(kind, **over):
    jcfg, pcfg = _configs(kind)
    for cfg in (jcfg, pcfg):
        for k, v in over.items():
            setattr(cfg, k, v)
    return JaxMFProcessor(jcfg), MaskFormerProcessor(pcfg)


@pytest.mark.parametrize("kind,over", [
    ("ins", dict(threshold=0.2)),
    ("ins", dict(use_mask_score=False, threshold=0.25)),
    ("sem", dict(threshold=0.25)),
    ("sem", dict(predict_all_pixels=False, use_mask_score=True, threshold=0.2)),
], ids=["ins", "ins-no-mask-score", "sem-all-pixels", "sem-thresholded"])
def test_postprocess_detections_match_jax(kind, over):
    """Serving detections: boxes equal, confidences 1e-5, class ids equal and
    the decoded PNG masks equal, for a batch padded to the larger image (the
    smaller one's masks resized bilinearly, > 0 is foreground)."""
    logits, masks = _probs(2, hw=(40, 36))
    inputs = [np.zeros((40, 36, 3), np.uint8), np.zeros((31, 23, 3), np.uint8)]
    jp, pp = _processors(kind, **over)
    ref = jp.postprocess(JaxMFOutput(masks=jnp.asarray(masks), logits=jnp.asarray(logits)), inputs, class_names=[])
    ref_all = jp.postprocess(JaxMFOutput(masks=jnp.asarray(masks), logits=jnp.asarray(logits)), inputs,
                             class_names=[], threshold=0.0)
    got = pp.postprocess(MaskFormerModelOutput(masks=torch.from_numpy(masks), logits=torch.from_numpy(logits)),
                         inputs, class_names=[])
    assert 0 < sum(len(r.detections) for r in ref) < sum(len(r.detections) for r in ref_all)
    for r, g in zip(ref, got):
        assert len(g.detections) == len(r.detections)
        for dr, dg in zip(r.detections, g.detections):
            assert dg.bbox == dr.bbox and dg.cls_id == dr.cls_id
            assert abs(dg.conf - dr.conf) <= SCORE_TOL * max(abs(dr.conf), 1.0)
            np.testing.assert_array_equal(base64_png_to_mask(dg.mask), base64_png_to_mask(dr.mask))


def test_postprocess_encodes_a_mask_one_column_wide(monkeypatch):
    """A detection whose mask spans one column: its exclusive crop is empty,
    which PIL cannot encode (JAX's postprocess raises); the port keeps the
    column. Every other detection as JAX's."""
    logits, masks = _probs(6, q=3, hw=(20, 16))
    masks[0, 0] = 0.0
    masks[0, 0, 4:9, 7] = 0.9  # one column, rows 4-8
    jp, pp = _processors("ins", threshold=0.0, use_mask_score=False)
    got = pp.postprocess(MaskFormerModelOutput(masks=torch.from_numpy(masks[:1]), logits=torch.from_numpy(logits[:1])),
                         [np.zeros((20, 16, 3), np.uint8)])[0]
    col = [d for d in got.detections if d.bbox == [7, 4, 7, 8]]
    assert col and all(base64_png_to_mask(d.mask).shape == (4, 1) and base64_png_to_mask(d.mask).all() for d in col)
    with pytest.raises(SystemError):
        jp.postprocess(JaxMFOutput(masks=jnp.asarray(masks[:1]), logits=jnp.asarray(logits[:1])),
                       [np.zeros((20, 16, 3), np.uint8)])


def _entries(image_hw, sizes, cls):
    return [cls(image=np.zeros((*image_hw, 3), np.uint8), height=h, width=w) for h, w in sizes]


@pytest.mark.parametrize("case", ["exact", "resize", "host"])
def test_instance_eval_postprocess_matches_jax(case, monkeypatch):
    """eval_postprocess's Instances against JAX's: the exact batch (packed
    masks kept for the evaluator, device boxes), a batch cropped and resized
    to the originals (nearest on the binary masks, boxes from the masks), and
    the host path (sets: np.argpartition leaves the top-k's order open)."""
    logits, masks = _probs(3, hw=(32, 32))
    image_hw, sizes = ((32, 32), [(32, 32)] * 2) if case != "resize" else ((24, 32), [(48, 64), (24, 32)])
    monkeypatch.delenv("FOCOOS_INSTSEG_EVAL_HOST", raising=False)
    monkeypatch.delenv("FOCOOS_INSTSEG_EVAL_FETCH", raising=False)
    if case == "host":
        monkeypatch.setenv("FOCOOS_INSTSEG_EVAL_HOST", "1")
    jp, pp = _processors("ins", top_k=12)
    ref = jp.eval_postprocess(JaxMFOutput(masks=jnp.asarray(masks), logits=jnp.asarray(logits)),
                              _entries(image_hw, sizes, JaxDatasetEntry))
    got = pp.eval_postprocess(MaskFormerModelOutput(masks=torch.from_numpy(masks), logits=torch.from_numpy(logits)),
                              _entries(image_hw, sizes, DatasetEntry))
    for r, g in zip(ref, got):
        ri, gi = r["instances"], g["instances"]
        assert gi.image_size == ri.image_size and len(gi) == len(ri)
        order_r = np.lexsort((np.asarray(ri.classes), -np.asarray(ri.scores))) if case == "host" else slice(None)
        order_g = np.lexsort((np.asarray(gi.classes), -np.asarray(gi.scores))) if case == "host" else slice(None)
        np.testing.assert_allclose(np.asarray(gi.scores)[order_g], np.asarray(ri.scores)[order_r], rtol=SCORE_TOL)
        np.testing.assert_array_equal(np.asarray(gi.classes)[order_g], np.asarray(ri.classes)[order_r])
        np.testing.assert_array_equal(gi.boxes.tensor[order_g], ri.boxes.tensor[order_r])
        if case == "exact":
            assert gi._masks_packed_hw == ri._masks_packed_hw
            np.testing.assert_array_equal(gi.masks_packed.numpy(), np.asarray(ri.masks_packed))
        else:
            np.testing.assert_array_equal(gi.masks.tensor[order_g], ri.masks.tensor[order_r])


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_semantic_eval_postprocess_matches_jax(host, monkeypatch):
    """The label map cropped to the image (device path), or the class scores
    at the original size (host path), against JAX's."""
    logits, masks = _probs(4, hw=(32, 32))
    if host:
        monkeypatch.setenv("FOCOOS_SEMSEG_EVAL_HOST", "1")
    else:
        monkeypatch.delenv("FOCOOS_SEMSEG_EVAL_HOST", raising=False)
    jp, pp = _processors("sem")
    sizes = [(48, 40), (24, 20)]
    ref = jp.eval_postprocess(JaxMFOutput(masks=jnp.asarray(masks), logits=jnp.asarray(logits)),
                              _entries((24, 20), sizes, JaxDatasetEntry))
    got = pp.eval_postprocess(MaskFormerModelOutput(masks=torch.from_numpy(masks), logits=torch.from_numpy(logits)),
                              _entries((24, 20), sizes, DatasetEntry))
    for r, g in zip(ref, got):
        if host:
            np.testing.assert_allclose(g["sem_seg"], np.asarray(r["sem_seg"]), rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(g["sem_seg"], np.asarray(r["sem_seg"]))


def test_eval_decode_keeps_packed_masks_only_when_exact(monkeypatch):
    """eval_decode's results: the label map for semantic; for instance the
    packed masks stay with the device (marked ``device``) unless a crop or a
    resize follows or FOCOOS_INSTSEG_EVAL_FETCH asks for them."""
    logits, masks = _probs(5, hw=(32, 32))
    out = MaskFormerModelOutput(masks=torch.from_numpy(masks), logits=torch.from_numpy(logits))
    monkeypatch.delenv("FOCOOS_INSTSEG_EVAL_FETCH", raising=False)
    _, ins = _processors("ins")
    dec = ins.eval_decode(out, _entries((32, 32), [(32, 32)] * 2, DatasetEntry))
    assert isinstance(dec, InstanceDecode) and dec.packed is None and dec.packed_on_device.shape == (2, 100, 128)
    assert ins.eval_decode(out, _entries((32, 32), [(64, 64)] * 2, DatasetEntry)).packed_on_device is None
    monkeypatch.setenv("FOCOOS_INSTSEG_EVAL_FETCH", "1")
    assert ins.eval_decode(out, _entries((32, 32), [(32, 32)] * 2, DatasetEntry)).packed is not None
    _, sem = _processors("sem")
    dec = sem.eval_decode(out, _entries((32, 32), [(32, 32)] * 2, DatasetEntry))
    assert isinstance(dec, SemanticDecode) and dec.sem_seg.shape == (2, 32, 32) and dec.sem_seg.dtype == torch.uint8
