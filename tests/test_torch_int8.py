"""Int8 parity of the port with the JAX package on the CPU: the QDQ layers
(``ConvNorm``, ``Int8Linear``) against JAX's ``ConvNorm`` / ``Int8Dense`` under
``int8_qdq_mode``, the int8 weight store bit for bit, the set of int8 layers
of every family against the keys of JAX's ``int8_calibration_mode``, and the
calibration's absmax; tests/test_torch_int8_serve.py serves the int8 forward
from one directory by both packages.

Tolerances: a QDQ layer in fp32, 1e-6 x max|ref| (both sides quantize the same
fp32 input with the same scale, so the int32 sums are equal; only the final
fp32 scale and cast remain); calibration absmax 1e-5 relative, in fp64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_checkpoint import few_threads  # noqa: F401 (a fixture)

from focoos_tpu.infer.quantizer import quantize_weights_int8 as jax_quantize_weights_int8
from focoos_tpu.model_manager import BackboneManager as JaxBackboneManager
from focoos_tpu.model_manager import ModelManager as JaxModelManager
from focoos_tpu.models.fai_detr.modelling import FAIDetr as JaxFAIDetr
from focoos_tpu.nn.layers import common as jax_common
from focoos_tpu_torch.infer.quantizer import quantize_weights_int8
from focoos_tpu_torch.model_manager import ModelManager
from focoos_tpu_torch.nn.layers.common import (
    ConvNorm,
    Int8Linear,
    calibration_absmax,
    int8_layers,
    set_compute_dtype,
    set_int8_mode,
)
from focoos_tpu_torch.ops.int8 import int8_conv2d
from focoos_tpu_torch.ports import RuntimeType
from focoos_tpu_torch.utils.weights import jax_module_paths

QDQ_TOL = 1e-6  # x max|ref|
CALIB_RTOL = 1e-5

R18 = {"model_type": "resnet", "depth": 18, "variant": "d", "freeze_norm": False}
STDC_TINY = {"model_type": "stdc", "base": 16, "layers": [2, 2, 2], "block_num": 4, "block_type": "cat",
             "use_conv_last": False, "use_pretrained": False}
DETR_TINY = dict(image_size=96, num_queries=20, transformer_predictor_dec_layers=2, pixel_decoder_feat_dim=64,
                 pixel_decoder_out_dim=64, pixel_decoder_dim_feedforward=128, transformer_predictor_hidden_dim=64,
                 transformer_predictor_out_dim=64, transformer_predictor_dim_feedforward=128, head_out_dim=64,
                 backbone_config=R18)
FAMILIES = {
    "fai_detr": ("fai-detr-l-coco", DETR_TINY),
    "rtmo": ("rtmo-s-coco", dict(image_size=128, transformer_encoder_layers=1, nms_pre_topk=50, max_detections=10)),
    "fai_mf": ("fai-mf-l-coco-ins", dict(image_size=96, num_queries=10, transformer_predictor_dec_layers=2,
                                         pixel_decoder_transformer_layers=1, backbone_config=R18)),
    "bisenetformer": ("bisenetformer-l-ade", dict(image_size=96, num_classes=5, num_queries=10,
                                                  transformer_predictor_dec_layers=2, pixel_decoder_feat_dim=32,
                                                  pixel_decoder_out_dim=32, transformer_predictor_out_dim=32,
                                                  transformer_predictor_hidden_dim=64,
                                                  transformer_predictor_dim_feedforward=128,
                                                  backbone_config=STDC_TINY)),
    "fai_cls": ("fai-cls-n-coco", dict(image_size=96, num_classes=3)),
}


pytestmark = pytest.mark.usefixtures("few_threads")


def _perturbed_bn(port: ConvNorm, g: torch.Generator) -> None:
    bn = port.norm
    c = bn.num_features
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(c, generator=g) * 0.1)
        bn.running_mean.copy_(torch.randn(c, generator=g) * 0.1)
        bn.running_var.copy_(torch.rand(c, generator=g) + 0.5)


def _jax_conv_norm_vars(port: ConvNorm) -> dict:
    bn = port.norm
    return {"params": {"conv": {"kernel": port.conv.weight.detach().permute(2, 3, 1, 0).numpy()},
                       "norm": {"bn": {"scale": bn.weight.detach().numpy(), "bias": bn.bias.detach().numpy()}}},
            "batch_stats": {"norm": {"bn": {"mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}}}}


@pytest.mark.parametrize("calibrated", [False, True], ids=["dynamic", "calibrated"])
@pytest.mark.parametrize("cin", [3, 16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_conv_norm_int8_matches_jax(k, stride, cin, calibrated):
    g = torch.Generator().manual_seed(k * 100 + stride * 10 + cin)
    port = ConvNorm(cin, 24, k, stride, act="relu")
    torch.nn.init.normal_(port.conv.weight, 0.0, 0.3, generator=g)
    _perturbed_bn(port, g)
    x = torch.randn(2, cin, 13, 11, generator=g) * 2.0
    scale = 0.9 * float(x.abs().max()) / 127.0  # a calibrated scale clips the largest inputs
    jm = jax_common.ConvNorm(24, k, stride, act="relu")
    jvars = _jax_conv_norm_vars(port)
    xj = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    with jax_common.int8_qdq_mode(act_scales={"conv": scale} if calibrated else None):
        # jitted, as the JAX package serves: XLA's division by 127 is a product with its reciprocal
        ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(jvars, xj))
        ref_train, _ = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(jvars, xj)
    assert set_int8_mode(port, True, act_scales={"conv": scale} if calibrated else None) == 1
    with torch.no_grad():
        got = port.eval()(x).permute(0, 2, 3, 1).numpy()
        got_train = port.train()(x).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=QDQ_TOL * np.abs(ref).max())
    # train mode stays float: JAX's ConvNorm takes nn.Conv with train=True
    np.testing.assert_allclose(got_train, np.asarray(ref_train), rtol=0, atol=1e-5 * np.abs(ref_train).max())


@pytest.mark.parametrize("k,stride,pad", [(3, 2, 1), (1, 2, 0), (3, 1, 1)])
def test_int8_conv_accumulators_equal_jax(k, stride, pad):
    """The s8 x s8 → s32 sums themselves, against lax.conv_general_dilated."""
    rng = np.random.default_rng(k + stride)
    xq = rng.integers(-127, 128, (2, 9, 12, 5), dtype=np.int8)
    wq = rng.integers(-127, 128, (7, 5, k, k), dtype=np.int8)
    ref = jax.lax.conv_general_dilated(jnp.asarray(xq), jnp.asarray(wq.transpose(2, 3, 1, 0)), (stride, stride),
                                       [(pad, pad), (pad, pad)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                       preferred_element_type=jnp.int32)
    got = int8_conv2d(torch.from_numpy(xq), torch.from_numpy(wq), stride, pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("calibrated", [False, True], ids=["dynamic", "calibrated"])
def test_int8_linear_matches_jax_int8_dense(calibrated):
    g = torch.Generator().manual_seed(7)
    port = Int8Linear(48, 40)
    torch.nn.init.normal_(port.weight, 0.0, 0.2, generator=g)
    torch.nn.init.normal_(port.bias, 0.0, 0.1, generator=g)
    x = torch.randn(2, 7, 48, generator=g)
    scale = 0.8 * float(x.abs().max()) / 127.0
    jm = jax_common.Int8Dense(40)
    jvars = {"params": {"kernel": port.weight.detach().T.numpy(), "bias": port.bias.detach().numpy()}}
    with jax_common.int8_qdq_mode(act_scales={"": scale} if calibrated else None):
        ref = np.asarray(jax.jit(jm.apply)(jvars, jnp.asarray(x.numpy())))
    set_int8_mode(port, True, act_scales={"": scale} if calibrated else None)
    with torch.no_grad():
        got = port.eval()(x).numpy()
        floating = port.train()(x).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=QDQ_TOL * np.abs(ref).max())
    np.testing.assert_allclose(floating, np.asarray(jm.apply(jvars, jnp.asarray(x.numpy()))), rtol=0, atol=1e-5)


def test_quantized_store_equals_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    tree = {"params": {"conv": {"kernel": rng.normal(0, 0.1, (3, 3, 16, 32)).astype(np.float32)},
                       "dense": {"kernel": rng.normal(0, 0.1, (64, 96)).astype(np.float32),
                                 "bias": rng.normal(0, 0.1, 96).astype(np.float32)},
                       "small": {"kernel": rng.normal(0, 0.1, (10, 10)).astype(np.float32)},
                       "zero": {"kernel": np.zeros((64, 64), np.float32)},
                       "norm": {"scale": rng.normal(1, 0.1, 4096).astype(np.float32)}},
            "batch_stats": {"bn": {"mean": rng.normal(0, 1, 32).astype(np.float32)}}}
    flat = {"params/conv/kernel": tree["params"]["conv"]["kernel"], "params/dense/kernel": tree["params"]["dense"]["kernel"],
            "params/dense/bias": tree["params"]["dense"]["bias"], "params/small/kernel": tree["params"]["small"]["kernel"],
            "params/zero/kernel": tree["params"]["zero"]["kernel"], "params/norm/scale": tree["params"]["norm"]["scale"],
            "batch_stats/bn/mean": tree["batch_stats"]["bn"]["mean"]}
    jstore, jsnr = jax_quantize_weights_int8(tree)
    store, snr = quantize_weights_int8(flat)
    assert sorted(store) == sorted(jstore)
    assert {k for k in store if k.endswith("@q")} == {"params/conv/kernel@q", "params/dense/kernel@q",
                                                       "params/zero/kernel@q"}
    for k in store:
        assert store[k].dtype == jstore[k].dtype and store[k].shape == jstore[k].shape, k
        np.testing.assert_array_equal(store[k], jstore[k], err_msg=k)
    assert snr == jsnr


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """family → (the port's tiny model (seeded init), a directory holding its
    weights, the JAX package's model loaded from that directory), built once."""
    built = {}

    def get(family: str):
        if family not in built:
            card, over = FAMILIES[family]
            pm = ModelManager.get(card, device="cpu", seed=1, **over)
            d = str(tmp_path_factory.mktemp(family))
            pm.export(RuntimeType.CPU, out_dir=d)
            built[family] = (pm, d, JaxModelManager.get(d))
        return built[family]

    return get


@pytest.mark.parametrize("family", [f for f in FAMILIES if f != "fai_detr"])
def test_int8_layers_are_jax_calibration_keys(family, tiny):
    """Every port int8 layer, named by its JAX module path, is a key of JAX's
    int8_calibration_mode apply, and every key is one of them (traced, not
    run; fai_detr's keys are compared in ``test_calibration_absmax_matches_jax``)."""
    pm, _, jm = tiny(family)
    h, w = pm.im_size
    with jax_common.int8_calibration_mode():
        _, mut = jax.eval_shape(lambda v, x: jm.module.apply(v, x, train=False, mutable=["int8_calib"]),
                                jm.variables, jnp.zeros((1, h, w, 3), jnp.uint8))
    jax_keys = {k[: -len("/absmax")] for k in _flat_keys(mut.get("int8_calib", {}))}
    paths = jax_module_paths(int8_layers(pm.module), family)
    assert set(paths.values()) == jax_keys
    assert len(paths) == len(jax_keys) and (family == "fai_mf") == bool(jax_keys)


def _flat_keys(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat_keys(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}"


def test_calibration_absmax_matches_jax(tiny):
    """Each int8 layer's calibration absmax, both packages computing in fp64
    around the int8 layers (which quantize in fp32 on both sides): in fp32 the
    two frameworks' sums round apart by ~1e-7, an input a hair from a rounding
    edge then lands one int8 step apart, and the step carries on through the
    later layers (the backbone's 24 layers agree to 7e-7 there, the FPN's
    later ones to ~1e-2)."""
    family = "fai_detr"
    _, d, jm = tiny(family)
    pm = ModelManager.get(d, device="cpu")  # a module of its own: this test casts it to fp64
    x = np.random.default_rng(5).integers(0, 256, (2, *pm.im_size, 3), dtype=np.uint8)
    with jax.enable_x64(True), jax_common.int8_calibration_mode():
        j64 = JaxFAIDetr(config=jm.config, backbone=JaxBackboneManager.from_config(jm.config.backbone_config),
                         dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jm.variables)
        _, mut = jax.jit(lambda v, x: j64.apply(v, x, train=False, mutable=["int8_calib"]))(v64, jnp.asarray(x))
        ref = {k[: -len("/absmax")]: float(np.asarray(v)) for k, v in _flat_items(mut["int8_calib"])}
    pm.module.double()
    set_compute_dtype(pm.module, torch.float64)
    set_int8_mode(pm.module, True, calibrate=True)
    with torch.inference_mode():
        pm.module(torch.from_numpy(x))
    got = calibration_absmax(pm.module)
    paths = jax_module_paths(got, family)
    assert set(got) == set(int8_layers(pm.module)) and len(got) == 68  # 59 ConvNorms and 9 dense layers
    assert {paths[n] for n in got} == set(ref)
    for n, v in got.items():
        assert abs(v - ref[paths[n]]) <= CALIB_RTOL * ref[paths[n]], (n, v, ref[paths[n]])


def _flat_items(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v
