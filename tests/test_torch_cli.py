"""The port's command line (``focoos_tpu_torch/cli``) against the JAX
package's (``focoos_tpu/cli``), on the CPU at tiny widths.

One model directory serves every verb: fai-detr-l's card with
tests/test_torch_model_manager.py's ``TINY`` overrides (ResNet-18-D, 64-wide,
10 queries, 1 decoder layer) at 64², 3 classes, the port's seeded init
perturbed as tests/test_torch_fai_detr.py perturbs it, saved by the port in
the JAX package's layout (``model_final.npz``) beside ``model_info.json``.
The dataset is tools/make_synthetic_dataset.py's Roboflow-COCO set of 4
train and 4 val records at 96², which the preset maps to 64² (so validation
also scores resized records). Every port verb runs with ``--device cpu``.

Tolerances: ``predict`` agrees with the JAX CLI as
tests/test_torch_fai_detr.py's ``test_model_manager_detections_match_jax``
does (labels equal, scores within ``AUX_TOL``, boxes, rounded to whole
pixels, within 1); ``val`` equals ``FocoosModel.eval`` to 1e-9.
"""

import argparse
import io
import json
import os
import sys
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from test_torch_fai_detr import AUX_TOL, _perturb
from test_torch_model_manager import TINY

from focoos_tpu.cli import cli as jax_cli
from focoos_tpu_torch import ModelManager
from focoos_tpu_torch.cli import cli, gradio_app
from focoos_tpu_torch.ports import ModelInfo, TrainerArgs
from focoos_tpu_torch.utils.weights import from_jax_variables, to_jax_variables

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

CLASSES = ["circle", "square", "triangle"]
SIZE = TINY["image_size"]
VERBS = ("version", "checks", "settings", "train", "val", "predict", "export", "benchmark", "gradio", "hub")
# the only flags that may differ from the JAX package's: --device on every verb
# that builds a model, and the values --runtime takes
DEVICE_VERBS = ("train", "val", "predict", "export", "benchmark", "gradio")


def run(main, argv) -> str:
    """``main(argv)`` in this process with its ``os._exit`` held off (a process
    forked during the call, a loader worker, still exits through it) → its
    standard output."""
    buf, real, me = io.StringIO(), os._exit, os.getpid()
    with pytest.MonkeyPatch.context() as mp, redirect_stdout(buf):
        mp.setattr(os, "_exit", lambda code: real(code) if os.getpid() != me else None)
        main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, threads):
    d = str(tmp_path_factory.mktemp("tiny_model"))
    model = ModelManager.get("fai-detr-l-coco", device="cpu", classes=CLASSES, seed=0, **TINY)
    sd = {k: v.numpy() for k, v in model.module.state_dict().items()}
    flat = _perturb(to_jax_variables(sd, "fai_detr"), seed=0)
    model.module.load_state_dict(from_jax_variables(flat, "fai_detr"), strict=True)
    model.model_info.name = "tiny-cli"
    model.model_info.dump_json(d)
    model.save_weights(os.path.join(d, "model_final.npz"))
    return d


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from make_synthetic_dataset import make

    return make(str(tmp_path_factory.mktemp("ds")), n_train=4, n_val=4, size=96, seed=5)


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    from PIL import Image

    path = str(tmp_path_factory.mktemp("img") / "request.png")
    Image.fromarray(np.random.default_rng(11).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(path)
    return path


@pytest.fixture(scope="module")
def jax_prediction(model_dir, image, tmp_path_factory):
    """The JAX package's ``predict`` on the model directory, once."""
    out = str(tmp_path_factory.mktemp("jax_pred"))
    run(jax_cli.main, ["predict", "--model", model_dir, "--source", image, "--conf", "0", "--save-json",
                       "--output-dir", out])
    with open(os.path.join(out, "prediction.json")) as f:
        return json.load(f)


def _flags(main_module) -> dict:
    """{verb: {flag: (default, choices)}} of a CLI's parser, built as its ``main`` builds it."""
    parsers = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, argv=None, namespace=None):
        parsers["root"] = self
        raise SystemExit(0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(SystemExit):
            main_module.main(["version"])
    assert argparse.ArgumentParser.parse_args is real
    sub = next(a for a in parsers["root"]._actions if isinstance(a, argparse._SubParsersAction))
    out = {}
    for verb, p in sub.choices.items():
        out[verb] = {}
        for a in p._actions:
            if isinstance(a, argparse._HelpAction):
                continue
            name = a.option_strings[0] if a.option_strings else a.dest
            out[verb][name] = (a.default, tuple(a.choices) if a.choices else None, a.required, a.nargs)
    return out


@pytest.fixture(scope="module")
def flags():
    return _flags(jax_cli), _flags(cli)


@pytest.mark.parametrize("verb", VERBS)
def test_flags_match_jax_verb_by_verb(flags, verb):
    """Each verb's flags, defaults, choices and arity equal the JAX CLI's,
    except ``--device`` (default ``cuda``) on the verbs that build a model
    (JAX's train and val take TrainerArgs' ``device``, default None) and
    export's ``--runtime`` default (``torch_export`` for ``stablehlo``)."""
    jax_flags, port_flags = flags
    assert sorted(port_flags) == sorted(jax_flags) == sorted(VERBS)
    ref, got = dict(jax_flags[verb]), dict(port_flags[verb])
    if verb in DEVICE_VERBS:
        assert got.pop("--device") == ("cuda", None, False, None)
        ref.pop("--device", None)
    if verb == "export":
        assert got.pop("--runtime")[0] == "torch_export" and ref.pop("--runtime")[0] == "stablehlo"
    assert got == ref


def test_predict_matches_jax(model_dir, image, jax_prediction, tmp_path):
    """``predict --conf 0 --save-json`` on one model directory: the port's
    printed detections and prediction.json agree with the JAX CLI's."""
    out = str(tmp_path / "pred")
    printed = run(cli.main, ["predict", "--model", model_dir, "--source", image, "--conf", "0", "--save-json",
                             "--output-dir", out, "--device", "cpu"])
    with open(os.path.join(out, "prediction.json")) as f:
        got = json.load(f)
    assert json.loads(printed[: printed.index("saved detections json")]) == got
    ref = jax_prediction
    assert len(got["detections"]) == len(ref["detections"]) > 0
    assert [d["cls_id"] for d in got["detections"]] == [d["cls_id"] for d in ref["detections"]]
    assert [d["label"] for d in got["detections"]] == [d["label"] for d in ref["detections"]]
    np.testing.assert_allclose([d["conf"] for d in got["detections"]], [d["conf"] for d in ref["detections"]],
                               atol=AUX_TOL)
    np.testing.assert_allclose([d["bbox"] for d in got["detections"]], [d["bbox"] for d in ref["detections"]], atol=1)


def test_val_equals_focoos_model_eval(model_dir, dataset, threads):
    """``val`` prints what ``FocoosModel.eval`` returns on the same directory
    and split, at the CLI's default batch of 8."""
    printed = run(cli.main, ["val", "--model", model_dir, "--dataset", dataset, "--im-size", str(SIZE),
                             "--device", "cpu"])
    got = json.loads(printed)
    from focoos_tpu_torch.data.auto_dataset import AutoDataset
    from focoos_tpu_torch.data.default_aug import get_default_by_task
    from focoos_tpu_torch.ports import Task

    val = AutoDataset(dataset, task="detection").get_split(get_default_by_task(Task.DETECTION, SIZE)[1], split="val")
    assert val[0].image.shape[:2] == (SIZE, SIZE) and val[0].original_instances is not None  # resized records
    ref = ModelManager.get(model_dir, image_size=SIZE, device="cpu").eval(TrainerArgs(run_name="val", batch_size=8), val)
    assert sorted(got) == ["bbox"]
    for k, v in ref["bbox"].items():
        assert got["bbox"][k] == pytest.approx(v, abs=1e-9), k


def test_train_writes_weights_that_jax_loads(model_dir, dataset, tmp_path, threads):
    """A 2-step ``train`` writes ``model_final.npz`` in the JAX layout: the
    JAX package's ``ModelManager.get`` on the run directory loads every
    variable of it."""
    from focoos_tpu.model_manager import ModelManager as JaxModelManager
    from focoos_tpu.utils.checkpoint import flatten_tree

    printed = run(cli.main, ["train", "--model", model_dir, "--dataset", dataset, "--im-size", str(SIZE),
                             "--max-iters", "2", "--batch-size", "2", "--workers", "0", "--output-dir", str(tmp_path),
                             "--run-name", "cli2", "--device", "cpu"])
    res = json.loads(printed[printed.rindex('{\n  "run_dir"'):])
    run_dir = res["run_dir"]
    assert os.path.dirname(run_dir) == str(tmp_path) and os.path.basename(run_dir) == "cli2"
    assert set(res["metrics"]) == {"bbox"}
    with np.load(os.path.join(run_dir, "model_final.npz")) as data:
        saved = {k: data[k] for k in data.files}
    loaded = flatten_tree(JaxModelManager.get(run_dir).variables)
    assert sorted(loaded) == sorted(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(np.asarray(loaded[k]), v, err_msg=k)
    info = ModelInfo.from_json(os.path.join(run_dir, "model_info.json"))
    assert info.status.value == "TRAINING_COMPLETED"


def test_settings_mask_the_key_as_jax(monkeypatch):
    """``settings`` prints the config with the API key cut to its first four
    characters, as the JAX CLI does; the port's runtime default is cuda_bf16."""
    import focoos_tpu.config as jax_config

    from focoos_tpu_torch import config

    monkeypatch.setenv("FOCOOS_API_KEY", "secret-key-123")
    monkeypatch.setattr(config, "FOCOOS_CONFIG", config.FocoosConfig())
    monkeypatch.setattr(jax_config, "FOCOOS_CONFIG", jax_config.FocoosConfig())
    got, ref = run(cli.main, ["settings"]).splitlines(), run(jax_cli.main, ["settings"]).splitlines()
    assert "focoos_api_key = secr..." in got and "secret-key-123" not in "".join(got)
    assert [ln for ln in got if not ln.startswith("runtime_type")] == [ln for ln in ref if not ln.startswith("runtime_type")]
    assert "runtime_type = cuda_bf16" in got and "runtime_type = xla_tpu_bf16" in ref


def test_version_checks_and_no_fallback_to_the_cpu(model_dir, image):
    """``version`` and ``checks`` (torch, CUDA, the devices, the packages);
    a verb left at ``--device cuda`` without a card raises and runs nothing
    on the CPU; ``benchmark`` on the CPU raises (a CPU time is no device
    time)."""
    assert run(cli.main, ["version"]).strip() == "focoos-tpu-torch 0.1.0"
    checks = run(cli.main, ["checks"])
    assert f"torch_version: {torch.__version__}" in checks and "process_count: 1" in checks
    assert "numpy:" in checks and "einops:" in checks
    if not torch.cuda.is_available():
        for argv in (["predict", "--model", model_dir, "--source", image],
                     ["benchmark", "--model", model_dir], ["export", "--model", model_dir],
                     ["gradio", "--model", model_dir]):
            with pytest.raises(RuntimeError, match="--device cuda: CUDA is not available"):
                run(cli.main, argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(cli.main, ["benchmark", "--model", model_dir, "--iterations", "1", "--device", "cpu"])


def test_export_cpu_runtime_serves_the_model(model_dir, tmp_path):
    """``export --runtime cpu`` writes a directory that ``InferModel`` serves
    to FocoosModel's detections; an unknown runtime raises."""
    from focoos_tpu_torch.infer.infer_model import InferModel

    out = str(tmp_path / "exported")
    printed = run(cli.main, ["export", "--model", model_dir, "--runtime", "cpu", "--im-size", str(SIZE),
                             "--output-dir", out, "--device", "cpu"])
    assert printed.strip() == f"exported → {out}"
    img = np.random.default_rng(3).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    got = InferModel(out, "cpu", device="cpu").infer(img, threshold=0.0)
    ref = ModelManager.get(model_dir, device="cpu").infer(img, threshold=0.0)
    assert [d.cls_id for d in got.detections] == [d.cls_id for d in ref.detections]
    np.testing.assert_allclose([d.conf for d in got.detections], [d.conf for d in ref.detections], atol=1e-6)
    with pytest.raises(ValueError):
        run(cli.main, ["export", "--model", model_dir, "--runtime", "stablehlo", "--device", "cpu"])


class _FakeGradio(types.ModuleType):
    """A ``gradio`` stand-in that records the callbacks ``launch`` wires."""

    def __init__(self):
        super().__init__("gradio")
        self.clicks, self.launched = [], None
        fake = self

        class Block:
            def __init__(self, *a, **kw):
                self.args, self.kw = a, kw

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def click(self, fn, inputs, outputs):
                fake.clicks.append((fn, inputs, outputs))

            def launch(self, share=False):
                fake.launched = share

        for name in ("Blocks", "Markdown", "Dropdown", "Slider", "Tabs", "Tab", "Image", "Button", "Dataframe", "Video"):
            setattr(self, name, Block)


def test_gradio_needs_gradio_and_wires_the_port_model(model_dir, monkeypatch):
    """Without gradio ``launch`` raises a RuntimeError naming it; with a fake
    ``gradio`` module the image tab's callback returns the annotated image
    and the table of ``FocoosModel.infer`` on the same image."""
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(RuntimeError, match="gradio"):
        gradio_app.launch(model_dir, device="cpu")
    fake = _FakeGradio()
    monkeypatch.setitem(sys.modules, "gradio", fake)
    monkeypatch.setattr(gradio_app, "_MODEL_CACHE", {})
    gradio_app.launch(model_dir, share=True, device="cpu")
    assert fake.launched is True and len(fake.clicks) == 2
    predict, predict_video = fake.clicks[0][0], fake.clicks[1][0]
    assert predict_video.__name__ == "predict_video"
    img = np.random.default_rng(4).integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    annotated, table = predict(img, model_dir, 0.0)
    model = ModelManager.get(model_dir, device="cpu")
    res = model.infer(img, threshold=0.0, annotate=True)
    assert annotated.shape == img.shape and len(table) == len(res.detections) > 0
    assert table == gradio_app._result_table(model, res)
    assert [row[0] for row in table] == [d.label for d in res.detections]
