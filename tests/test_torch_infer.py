"""The port's export and serving layer (``focoos_tpu_torch/infer``) on the CPU:
artifact directories that both packages serve, ``torch.export`` programs with
size buckets and fixed batches, ``export_postprocess`` of every family against
the JAX package's, the kernels' custom ops under ``torch.library.opcheck``,
and the runtime guards.

Tolerances: eager fp32 against JAX's XLA_CPU runtime, 1e-4 on detection scores
(fp32 sums in another order, as tests/test_torch_fai_detr.py); a loaded
program against the eager module, 1e-6 x max|ref| (the same aten ops, traced);
``export_postprocess`` on the same raw arrays, boxes, classes and masks equal,
scores 1e-5.
"""

import json
import os

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch
from test_torch_checkpoint import few_threads  # noqa: F401 (a fixture)

from focoos_tpu.infer.infer_model import InferModel as JaxInferModel
from focoos_tpu.model_manager import ConfigManager as JaxConfigManager
from focoos_tpu.model_manager import ModelManager as JaxModelManager
from focoos_tpu.ports import RuntimeType as JaxRuntimeType
from focoos_tpu.processor.processor_manager import ProcessorManager as JaxProcessorManager
from focoos_tpu_torch.infer import runtimes
from focoos_tpu_torch.infer.infer_model import InferModel
from focoos_tpu_torch.model_manager import ConfigManager, ModelManager
from focoos_tpu_torch.ops.msda import msda_forward_op
from focoos_tpu_torch.ops.nms import nms_keep_op
from focoos_tpu_torch.ops.stem import fused_resnet_stem_op
from focoos_tpu_torch.ports import ArtifactName, RuntimeType
from focoos_tpu_torch.processor.processor_manager import ProcessorManager
from focoos_tpu_torch.utils.vision import base64_png_to_mask

SCORE_TOL = 1e-5
XLA_TOL = 1e-4
PROGRAM_TOL = 1e-6  # x max|ref|
CARDS = os.path.join(os.path.dirname(__file__), "..", "focoos_tpu_torch", "model_registry")
R18 = {"model_type": "resnet", "depth": 18, "variant": "d", "freeze_norm": False}
DETR = dict(image_size=96, num_queries=20, transformer_predictor_dec_layers=2, pixel_decoder_feat_dim=64,
            pixel_decoder_out_dim=64, pixel_decoder_dim_feedforward=128, transformer_predictor_hidden_dim=64,
            transformer_predictor_out_dim=64, transformer_predictor_dim_feedforward=128, head_out_dim=64,
            backbone_config=R18)
RTMO = dict(image_size=128, transformer_encoder_layers=1, nms_pre_topk=50, max_detections=10)


pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(scope="module")
def detr(tmp_path_factory):
    """Tiny fai-detr-l (R18-D, 96², 2 decoder layers) on the CPU, its CPU
    export, and a TORCH_EXPORT directory: a 2-image program at 96² and a
    64² bucket."""
    model = ModelManager.get("fai-detr-l-coco", device="cpu", seed=3, **DETR)
    cpu_dir = str(tmp_path_factory.mktemp("detr_cpu"))
    served = model.export(RuntimeType.CPU, out_dir=cpu_dir)
    pt2_dir = str(tmp_path_factory.mktemp("detr_pt2"))
    program = model.export(RuntimeType.TORCH_EXPORT, out_dir=pt2_dir, batch_size=2, size_buckets=[96, 64])
    return dict(model=model, cpu_dir=cpu_dir, served=served, pt2_dir=pt2_dir, program=program)


def _images(seed, n, hw):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def _scores(res):
    return np.array([d.conf for d in res.detections])


def test_cpu_export_serves_in_jax_to_the_same_detections(detr):
    img = _images(0, 1, (80, 100))[0]
    got = detr["served"].infer(img, threshold=0.0)
    want = JaxInferModel(detr["cpu_dir"], JaxRuntimeType.XLA_CPU).infer(img, threshold=0.0)
    assert len(got.detections) == len(want.detections) == 300
    np.testing.assert_allclose(_scores(got), _scores(want), rtol=0, atol=XLA_TOL)
    assert [d.cls_id for d in got.detections[:20]] == [d.cls_id for d in want.detections[:20]]


def test_infer_model_equals_focoos_model_infer(detr):
    img = _images(1, 1, (90, 70))[0]
    got, want = detr["served"].infer(img, threshold=0.0), detr["model"].infer(img, threshold=0.0)
    assert [(d.bbox, d.conf, d.cls_id, d.label) for d in got.detections] == \
           [(d.bbox, d.conf, d.cls_id, d.label) for d in want.detections]
    lat = got.latency
    assert lat.preprocess >= 0 and lat.inference > 0 and lat.postprocess >= 0 and lat.imload >= 0


def test_port_serves_a_directory_exported_by_jax(detr, tmp_path):
    jm = JaxModelManager.get(detr["cpu_dir"])
    jm.export(JaxRuntimeType.XLA_CPU, out_dir=str(tmp_path), image_size=96)
    img = _images(2, 1, (96, 96))[0]
    got = InferModel(str(tmp_path), RuntimeType.CPU).infer(img, threshold=0.0)
    want = detr["model"].infer(img, threshold=0.0)
    assert [(d.bbox, d.conf, d.cls_id) for d in got.detections] == [(d.bbox, d.conf, d.cls_id) for d in want.detections]


def test_exported_program_loads_fresh_and_equals_eager(detr):
    fresh = detr["program"]  # export returns an InferModel that loaded the programs from disk
    assert isinstance(fresh.runtime, runtimes.ExportedProgramRuntime)
    assert fresh.runtime.sizes == [(64, 64), (96, 96)]
    x = _images(3, 2, (96, 96))
    got = fresh.runtime(x)
    with torch.inference_mode():
        out, _ = detr["model"].module(torch.from_numpy(x))
    for name, g in zip(["boxes", "logits"], got):
        ref = getattr(out, name)
        assert g.shape == ref.shape and g.dtype == ref.dtype
        assert float((g - ref).abs().max()) <= PROGRAM_TOL * float(ref.abs().max()), name


def test_size_buckets_and_fixed_batch(detr, monkeypatch):
    from focoos_tpu_torch.ops import stem

    rt = detr["program"].runtime
    # the processor's resized batch is a channel-planar numpy array; the
    # program (traced on a contiguous example) must still hand the stem op a
    # contiguous NHWC tensor, as its CUDA implementation requires
    real = stem.resnet_stem_reference
    monkeypatch.setattr(stem, "resnet_stem_reference", lambda x, *p: real(x, *p) if x.is_contiguous() else 1 / 0)
    batch, _ = detr["program"].processor.preprocess([_images(9, 1, (80, 100))[0]])
    assert not batch.flags["C_CONTIGUOUS"]
    assert len(detr["program"]([_images(9, 1, (80, 100))[0]], threshold=0.0)[0].detections) == 300
    assert rt.pick(96, 96) == ((96, 96), False)
    assert rt.pick(70, 70) == ((64, 64), True)  # closest bucket by area
    x70 = _images(4, 1, (70, 70))
    got = rt(x70)
    want = rt(runtimes.resize_uint8(x70, (64, 64)))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    five = _images(5, 5, (96, 96))
    out5 = rt(five)
    assert [o.shape[0] for o in out5] == [5, 5]
    single = rt(five[:1])  # one image, padded to the program's batch of 2
    assert all(torch.equal(a[:1], b) for a, b in zip(out5, single))
    assert all(torch.equal(a[4:5], b) for a, b in zip(out5, rt(five[4:5])))


@pytest.fixture(scope="module")
def rtmo(tmp_path_factory):
    model = ModelManager.get("rtmo-s-coco", device="cpu", seed=2, **RTMO)
    d = str(tmp_path_factory.mktemp("rtmo_pt2"))
    return model, d, model.export(RuntimeType.TORCH_EXPORT, out_dir=d)


def test_rtmo_program_equals_eager_and_refuses_resize(rtmo):
    model, d, served = rtmo
    x = _images(6, 1, (128, 128))
    got = served.runtime(x)
    with torch.inference_mode():
        out, _ = model.module(torch.from_numpy(x))
    names = model.processor.get_output_names()
    assert len(got) == len(names) == 7
    for name, g in zip(names, got):
        ref = getattr(out, name)
        assert g.dtype == ref.dtype and g.shape == ref.shape
        if ref.dtype.is_floating_point:
            assert float((g - ref).abs().max()) <= PROGRAM_TOL * max(float(ref.abs().max()), 1.0), name
        else:
            assert torch.equal(g, ref), name
    assert not served.processor.resize_dispatch_safe
    with pytest.raises(ValueError, match="resize dispatch unsafe"):
        served.runtime(_images(6, 1, (96, 128)))
    img = _images(7, 1, (128, 128))[0]
    a, b = served.infer(img, threshold=0.0), model.infer(img, threshold=0.0)
    assert [(x.bbox, x.conf, x.keypoints) for x in a.detections] == [(x.bbox, x.conf, x.keypoints) for x in b.detections]


def test_missing_artifacts_and_runtime_guards(detr, tmp_path):
    with pytest.raises(FileNotFoundError):
        InferModel(str(tmp_path), RuntimeType.CPU)
    detr["model"].model_info.dump_json(str(tmp_path))
    for rt in (RuntimeType.CPU, RuntimeType.CUDA_INT8, RuntimeType.TORCH_EXPORT):
        with pytest.raises(FileNotFoundError):
            InferModel(str(tmp_path), rt, device="cpu")
    # data_parallel on the CPU's one device is the plain runtime; an exported program takes none
    assert type(InferModel(detr["cpu_dir"], RuntimeType.CPU, data_parallel=True, device="cpu").runtime) is \
        runtimes.TorchRuntime
    with pytest.raises(ValueError, match="data_parallel"):
        runtimes.load_runtime(RuntimeType.TORCH_EXPORT, artifact_path="x.pt2", output_names=["boxes"],
                              data_parallel=True)
    with pytest.raises(ValueError):
        runtimes.load_runtime(RuntimeType.CPU, output_names=["boxes"])
    with pytest.raises(ValueError):
        runtimes.load_runtime(RuntimeType.TORCH_EXPORT, output_names=["boxes"])
    with pytest.raises(ValueError):
        runtimes.load_runtime("xla_tpu_bf16", output_names=["boxes"])
    with pytest.raises(ValueError, match="runs on the host"):
        InferModel(detr["cpu_dir"], RuntimeType.CPU, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        detr["served"].benchmark(iterations=1)


def test_exported_program_serves_on_its_own_device(detr):
    """A program serves on the device it was exported on: its buckets' files
    are named ``model_{H}x{W}.pt2``, and asking for another device raises."""
    assert sorted(f for f in os.listdir(detr["pt2_dir"]) if f.endswith(".pt2")) == ["model.pt2", "model_64x64.pt2"]
    assert detr["program"].device == torch.device("cpu")  # export served it with device="cpu"
    with pytest.raises(ValueError, match="exported on cpu"):
        InferModel(detr["pt2_dir"], RuntimeType.TORCH_EXPORT, device="cuda")


def test_infer_model_without_device_needs_cuda(detr, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for rt in (RuntimeType.CUDA_BF16, RuntimeType.CUDA_FP32):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            InferModel(detr["cpu_dir"], rt)


def test_overwrite_false_reuses_a_complete_directory(detr, monkeypatch):
    from focoos_tpu_torch.infer import export

    path = os.path.join(detr["cpu_dir"], ArtifactName.WEIGHTS.value)
    before = os.path.getmtime(path)
    again = detr["model"].export(RuntimeType.CPU, out_dir=detr["cpu_dir"])
    assert os.path.getmtime(path) == before and isinstance(again.runtime, runtimes.TorchRuntime)
    # a directory without the runtime's artifact is not complete: it is exported
    monkeypatch.setattr(export, "export_program", lambda model, hw, b, p: open(p, "wb").close())
    import focoos_tpu_torch.infer.infer_model as im

    monkeypatch.setattr(im, "InferModel", lambda *a, **k: "served")
    assert detr["model"].export(RuntimeType.TORCH_EXPORT, out_dir=detr["cpu_dir"]) == "served"
    assert os.path.isfile(os.path.join(detr["cpu_dir"], ArtifactName.EXPORTED_PROGRAM.value))


# --------------------------------------------------------------------------
# export_postprocess of every family, port against JAX, on the same raw arrays


def _config_pair(family, card, **over):
    with open(os.path.join(CARDS, f"{card}.json")) as f:
        d = json.load(f)["config"]
    return JaxConfigManager.from_dict(family, d, **over), ConfigManager.from_dict(family, d, **over)


def _raw(family, rng):
    b = 2
    if family == "fai_detr":
        xy = rng.uniform(0, 0.6, (b, 30, 2))
        return [np.concatenate([xy, xy + rng.uniform(0.05, 0.4, (b, 30, 2))], -1).astype(np.float32),
                rng.random((b, 30, 80)).astype(np.float32)]
    if family == "rtmo":
        scores = np.where(rng.random((b, 6)) < 0.6, rng.uniform(0.05, 1.0, (b, 6)), 0.0).astype(np.float32)
        boxes = np.sort(rng.uniform(-20, 300, (b, 6, 2, 2)), axis=2).reshape(b, 6, 4)[..., [0, 2, 1, 3]]
        return [scores, rng.integers(0, 1, (b, 6)), boxes.astype(np.float32), scores,
                rng.uniform(-30, 320, (b, 6, 17, 2)).astype(np.float32), rng.random((b, 6, 17)).astype(np.float32),
                rng.random((b, 6, 17)).astype(np.float32)]
    if family == "fai_cls":
        return [rng.normal(0, 2, (b, 80)).astype(np.float32)]
    logits = rng.dirichlet(np.ones(151), (b, 10))[..., :150].astype(np.float32) * 3
    masks = rng.random((b, 10, 40, 36)).astype(np.float32)
    masks = np.where(np.abs(masks - 0.5) < 1e-3, 0.9, masks).astype(np.float32)
    return [masks, logits] if family == "fai_mf" else [logits, masks]


@pytest.mark.parametrize("family,card", [("fai_detr", "fai-detr-l-coco"), ("rtmo", "rtmo-s-coco"),
                                         ("fai_mf", "fai-mf-l-ade"), ("bisenetformer", "bisenetformer-l-ade"),
                                         ("fai_cls", "fai-cls-m-coco")])
def test_export_postprocess_matches_jax(family, card):
    jcfg, pcfg = _config_pair(family, card)
    jp, pp = JaxProcessorManager.get_processor(family, jcfg, 96), ProcessorManager.get_processor(family, pcfg, 96)
    assert pp.get_output_names() == jp.get_output_names()
    assert pp.resize_dispatch_safe == jp.resize_dispatch_safe
    raw = _raw(family, np.random.default_rng(11))
    inputs = [np.zeros((40, 36, 3), np.uint8), np.zeros((31, 23, 3), np.uint8)]
    want = jp.export_postprocess(raw, inputs, class_names=[], threshold=0.1)
    got = pp.export_postprocess(raw, inputs, class_names=[], threshold=0.1)
    assert [len(r.detections) for r in got] == [len(r.detections) for r in want]
    assert sum(len(r.detections) for r in got) > 0
    for g, w in zip(got, want):
        for dg, dw in zip(g.detections, w.detections):
            assert (dg.bbox, dg.cls_id, dg.keypoints is None) == (dw.bbox, dw.cls_id, dw.keypoints is None)
            assert abs(dg.conf - dw.conf) <= SCORE_TOL * max(abs(dw.conf), 1.0)
            if dw.keypoints is not None:
                assert [k[:2] for k in dg.keypoints] == [k[:2] for k in dw.keypoints]
            if dw.mask is not None:
                np.testing.assert_array_equal(base64_png_to_mask(dg.mask), base64_png_to_mask(dw.mask))


# --------------------------------------------------------------------------
# the kernels' custom ops


def _stem_params(g):
    params = []
    for cin, cout in ((3, 32), (32, 32), (32, 64)):
        params += [torch.randn(3, 3, cin, cout, generator=g) * 0.2, torch.rand(cout, generator=g) + 0.5,
                   torch.randn(cout, generator=g) * 0.1]
    return params


@pytest.mark.parametrize("op", ["msda_forward", "fused_resnet_stem", "nms_keep"])
def test_custom_op_passes_opcheck(op):
    g = torch.Generator().manual_seed(0)
    if op == "msda_forward":
        v = torch.rand(2, 26, 2, 8, generator=g)
        args = (v, [4, 5, 2, 3], torch.rand(2, 7, 2, 2, 4, 2, generator=g), torch.rand(2, 7, 2, 2, 4, generator=g))
        fn, shape = msda_forward_op, (2, 7, 16)
    elif op == "fused_resnet_stem":
        args = (torch.randn(2, 13, 11, 3, generator=g), *_stem_params(g))
        fn, shape = fused_resnet_stem_op, (2, 4, 3, 64)
    else:
        boxes = torch.rand(2, 9, 4, generator=g)
        boxes[..., 2:] += boxes[..., :2]
        args = (boxes, torch.sort(torch.rand(2, 9, generator=g), descending=True).values, 0.5)
        fn, shape = nms_keep_op, (2, 9)
    result = torch.library.opcheck(fn, args)
    assert set(result.values()) == {"SUCCESS"}, result
    assert tuple(fn(*args).shape) == shape
