"""The int8 forward served by both packages from one directory (CPU): the
port's ``InferModel(dir, CUDA_INT8, device="cpu")`` against JAX's
``InferModel(dir, XLA_TPU_INT8)`` for a tiny fai-detr-l (R18-D, 96², 2
decoder layers) and a tiny rtmo-s, on a directory written by each package,
and the two packages' int8 stores bit for bit; ``Quantizer``'s files and
``Quantizer.load_quantized`` against JAX's dequantization.

Both packages build the int8 model in bf16 (JAX infer/infer_model.py:72), so
the detections carry bf16 rounding, which the two frameworks place
differently: ``SERVE_TOL`` was measured on these seeds and inputs. JAX's own
check that int8 scores track fp32 (tests/test_infer_stack.py:130-156) is
kept.
"""

import os

import cv2
import numpy as np
import pytest
from flax.traverse_util import flatten_dict
from test_torch_checkpoint import few_threads  # noqa: F401 (a fixture)
from test_torch_int8 import tiny  # noqa: F401 (a fixture)

from focoos_tpu.infer.infer_model import InferModel as JaxInferModel
from focoos_tpu.infer.quantizer import dequantize_weights as jax_dequantize_weights
from focoos_tpu.ports import RuntimeType as JaxRuntimeType
from focoos_tpu_torch.infer.infer_model import InferModel
from focoos_tpu_torch.infer.quantizer import Quantizer, model_variables
from focoos_tpu_torch.model_manager import ModelManager
from focoos_tpu_torch.nn.layers.common import int8_layers
from focoos_tpu_torch.ports import RuntimeType
from focoos_tpu_torch.utils.weights import jax_module_paths

SERVE_TOL = 2e-2  # abs, detection scores in [0, 1]; bf16 both sides (measured: 7.0e-3 fai-detr, 7.9e-4 rtmo)
TRACK_TOL = 0.15  # JAX's own check of int8 against fp32 scores (tests/test_infer_stack.py:150)

pytestmark = pytest.mark.usefixtures("few_threads")


@pytest.fixture(scope="module")
def served(tiny, tmp_path_factory):
    """Tiny fai-detr-l and rtmo-s exported for CUDA_INT8 by the port and, from
    the same weights, by the JAX package; JAX's int8 detections of one image
    from the port's directory, and the fp32 ones of the port's model."""
    out = {}
    for family in ("fai_detr", "rtmo"):
        pm, d, jm = tiny(family)
        pm.export(RuntimeType.CUDA_INT8, out_dir=d, overwrite=True)
        jd = str(tmp_path_factory.mktemp(f"{family}_jax"))
        jm.export(JaxRuntimeType.XLA_TPU_INT8, out_dir=jd, image_size=pm.im_size[0])
        img = np.random.default_rng(3).integers(0, 256, (*pm.im_size, 3), dtype=np.uint8)
        want = JaxInferModel(d, JaxRuntimeType.XLA_TPU_INT8).infer(img, threshold=0.0)
        out[family] = dict(dirs={"port": d, "jax": jd}, img=img, want=want, fp=pm.infer(img, threshold=0.0))
    return out


def _scores(res):
    return np.array([d.conf for d in res.detections])


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("family", ["fai_detr", "rtmo"])
def test_int8_forward_matches_jax_int8(family, writer, served):
    """The port's CUDA_INT8 InferModel on the CPU, on the directory each
    package wrote, against JAX's XLA_TPU_INT8 InferModel (one compile, on the
    port's directory: the two directories' stores are equal bit for bit,
    ``test_int8_stores_of_both_packages_are_equal``)."""
    s = served[family]
    port = InferModel(s["dirs"][writer], RuntimeType.CUDA_INT8, device="cpu")
    assert port.runtime.num_int8_layers == (68 if family == "fai_detr" else 0)
    got = port.infer(s["img"], threshold=0.0)
    assert len(got.detections) == len(s["want"].detections) > 0
    np.testing.assert_allclose(_scores(got), _scores(s["want"]), rtol=0, atol=SERVE_TOL)
    # int8 tracks the fp32 forward of the same weights (JAX's own check)
    np.testing.assert_allclose(_scores(got)[:5], _scores(s["fp"])[:5], rtol=0, atol=TRACK_TOL)


def test_int8_stores_of_both_packages_are_equal(served, tiny):
    for family, s in served.items():
        a, b = (np.load(os.path.join(s["dirs"][w], "model_int8.npz")) for w in ("port", "jax"))
        assert sorted(a.files) == sorted(b.files), family
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{family} {k}")
        assert sum(k.endswith("@q") for k in a.files) > 0
        assert {k.removesuffix("@q") for k in a.files if not k.endswith("@scale")} == set(model_variables(tiny(family)[0]))


def test_quantizer_files_and_load_quantized(tiny, tmp_path):
    """``Quantizer.quantize`` writes the int8 store, its report,
    model_info.json and, from a folder of images, calibration.npz keyed by
    the int8 layers' JAX module paths; ``Quantizer.load_quantized`` then
    gives the model JAX's dequantization of that store, bit for bit."""
    _, d, _ = tiny("fai_detr")
    model = ModelManager.get(d, device="cpu")  # a module of its own: this test loads the store into it
    calib = tmp_path / "calib"
    calib.mkdir()
    rng = np.random.default_rng(8)
    for i in range(2):
        cv2.imwrite(str(calib / f"img_{i}.png"), rng.integers(0, 256, (80, 100, 3), dtype=np.uint8))
    out = str(tmp_path / "quantized")
    path = Quantizer(model).quantize(out, calibration_images_dir=str(calib))
    assert os.path.basename(path) == "model_final.int8.npz"
    assert {"quant_report.txt", "model_info.json", "calibration.npz"} <= set(os.listdir(out))
    with np.load(os.path.join(out, "calibration.npz")) as calibration:
        assert set(calibration.files) == set(jax_module_paths(int8_layers(model.module), "fai_detr").values())
        assert all(float(calibration[k]) > 0 for k in calibration.files)
    with np.load(path) as data:
        want = flatten_dict(jax_dequantize_weights({k: data[k] for k in data.files}), sep="/")
    Quantizer.load_quantized(model, path)
    got = model_variables(model)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
