"""The port stands alone: with ``jax``, ``jaxlib``, ``flax``, ``PIL``, ``cv2``
and the JAX package ``focoos_tpu`` made unimportable, every module of
focoos_tpu_torch imports, each ported slice (fai-detr-l, fai-detr-m, rtmo)
serves an ndarray image and is evaluated on the CPU, fai-detr trains two
steps with validation and resumes for a third on the CPU, and a dataset on
disk parses, its images needing cv2 only when they are read; and no source
of the port, nor chip_smoke.py, imports ``focoos_tpu``."""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "PIL", "cv2", "focoos_tpu")
for name in BLOCKED:
    sys.modules[name] = None  # any import of these now raises ImportError

import numpy as np
import focoos_tpu_torch
for mod in pkgutil.walk_packages(focoos_tpu_torch.__path__, "focoos_tpu_torch."):
    importlib.import_module(mod.name)

from focoos_tpu_torch import ModelManager
"""

SCRIPT = PRELUDE + r"""
model = ModelManager.get(
    "fai-detr-l-coco", device="cpu", image_size=64, num_queries=10, transformer_predictor_dec_layers=1,
    backbone_config={"model_type": "resnet", "depth": 18, "variant": "d", "freeze_norm": False},
)
img = np.random.default_rng(0).integers(0, 256, (50, 70, 3), dtype=np.uint8)
res = model.infer(img, threshold=0.0)
assert len(res) == 300, len(res)
assert all(0 <= d.cls_id < 80 and np.isfinite(d.conf) for d in res.detections)
loaded = sorted(k for k, v in sys.modules.items() if v is not None and k.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("OK", len(res))
"""


RTMO_SCRIPT = PRELUDE + r"""
from focoos_tpu_torch.ports import DatasetEntry, TrainerArgs
from focoos_tpu_torch.structures import Boxes, Instances, Keypoints
model = ModelManager.get("rtmo-s-coco", device="cpu", image_size=128, nms_pre_topk=50, max_detections=10)
img = np.random.default_rng(0).integers(0, 256, (100, 120, 3), dtype=np.uint8)
res = model.infer(img, threshold=0.0)
assert 0 < len(res) <= 10, len(res)
for d in res.detections:
    assert d.cls_id == 0 and np.isfinite(d.conf) and len(d.keypoints) == 17
    assert all(isinstance(v, int) for v in d.bbox)
kpts = np.concatenate([np.full((1, 17, 2), 50.0), np.full((1, 17, 1), 2.0)], -1)
gt = Instances((128, 128), boxes=Boxes([[20, 20, 90, 100]]), classes=np.zeros(1, np.int64), keypoints=Keypoints(kpts))
scores = model.eval(TrainerArgs(run_name="e", batch_size=2), [DatasetEntry(image=img[:96, :96], height=96, width=96,
                                                                           instances=gt)])
assert set(scores) == {"keypoints"}, scores
loaded = sorted(k for k, v in sys.modules.items() if v is not None and k.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("OK", len(res))
"""


TRAIN_SCRIPT = PRELUDE + r"""
import os, tempfile
import torch
torch.set_num_threads(2)  # pytest-xdist's workers share the cores
from focoos_tpu_torch.ports import DatasetEntry, TrainerArgs
from focoos_tpu_torch.structures import Boxes, Instances
model = ModelManager.get(
    "fai-detr-l-coco", device="cpu", image_size=64, num_queries=10, transformer_predictor_dec_layers=1,
    pixel_decoder_feat_dim=64, pixel_decoder_out_dim=64, pixel_decoder_dim_feedforward=128,
    transformer_predictor_hidden_dim=64, transformer_predictor_out_dim=64, transformer_predictor_dim_feedforward=128,
    head_out_dim=64, backbone_config={"model_type": "resnet", "depth": 18, "variant": "d", "freeze_norm": False},
)
rng = np.random.default_rng(0)
boxes = np.array([[4, 6, 30, 40], [20, 10, 60, 50]], np.float32)
ds = [DatasetEntry(image=rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), height=64, width=64,
                   instances=Instances((64, 64), boxes=Boxes(boxes), classes=np.array([3, 7])))
      for _ in range(2)]
out = tempfile.mkdtemp()
ckpt = os.path.join(out, "ckpt")
# two steps with validation (its prediction mosaics need cv2: they warn and training goes on),
# then a resume for a third
res = model.train(TrainerArgs(run_name="t", output_dir=out, batch_size=2, max_iters=2, checkpointer_period=10,
                              workers_timeout=120,
                              eval_period=2, samples=1, ckpt_dir=ckpt), ds, ds)
assert os.path.isfile(os.path.join(res["run_dir"], "model_final.npz")) and "AP" in res["metrics"]["bbox"]
more = model.train(TrainerArgs(run_name="t", output_dir=out, batch_size=2, max_iters=3, checkpointer_period=10,
                               workers_timeout=120,
                               ckpt_dir=ckpt, resume=True), ds)
assert more["iterations"] == 3 and "AP" in model.eval(TrainerArgs(run_name="e", batch_size=2), ds)["bbox"]
loaded = sorted(k for k, v in sys.modules.items() if v is not None and k.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("OK", res["iterations"])
"""


DATA_SCRIPT = PRELUDE + r"""
import json, os, tempfile
from focoos_tpu_torch.data.auto_dataset import AutoDataset
from focoos_tpu_torch.data.loaders import build_train_loader
root = tempfile.mkdtemp()
for split in ("train", "valid"):
    os.makedirs(os.path.join(root, "ds", split))
    coco = dict(images=[dict(id=0, file_name="a.jpg", height=64, width=64)],
                annotations=[dict(id=1, image_id=0, category_id=1, bbox=[4, 4, 20, 20], iscrowd=0)],
                categories=[dict(id=0, name="all", supercategory="none"), dict(id=1, name="box", supercategory="all")])
    with open(os.path.join(root, "ds", split, "_annotations.coco.json"), "w") as f:
        json.dump(coco, f)
auto = AutoDataset("ds", task="detection", datasets_dir=root)
train, val = auto.get_split(split="train"), auto.get_split(split="val")
assert len(train) == len(val) == 1 and train.metadata.classes == ["box"]
try:
    val[0]
except ImportError as e:  # reading an image is where cv2 is imported
    assert "cv2" in str(e), e
else:
    raise AssertionError("an image was read without cv2")
model = ModelManager.get("fai-detr-m-coco", device="cpu", image_size=64, num_queries=10,
                         transformer_predictor_dec_layers=1, num_classes=1,
                         backbone_config={"model_type": "stdc", "base": 16, "layers": [2, 2, 2]})
res = model.infer(np.random.default_rng(0).integers(0, 256, (50, 70, 3), dtype=np.uint8), threshold=0.0)
assert len(res) == 10 and all(d.cls_id == 0 and np.isfinite(d.conf) for d in res.detections)
loaded = sorted(k for k, v in sys.modules.items() if v is not None and k.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("OK", len(res))
"""


MF_SCRIPT = PRELUDE + r"""
import torch
torch.set_num_threads(2)
from focoos_tpu_torch.ports import DatasetEntry, TrainerArgs
from focoos_tpu_torch.structures import BitMasks, Instances
rng = np.random.default_rng(0)
img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
masks = BitMasks(rng.random((2, 64, 64)) > 0.5)
gt = Instances((64, 64), boxes=masks.get_bounding_boxes(), classes=np.array([0, 1]), masks=masks)
entry = DatasetEntry(image=img, height=64, width=64, instances=gt, sem_seg=rng.integers(0, 2, (64, 64)).astype(np.uint8))
kw = dict(device="cpu", num_queries=10, transformer_predictor_dec_layers=2, num_classes=2)
out = []
for name in ("fai-mf-s-coco-ins", "fai-mf-l-ade"):
    model = ModelManager.get(name, **kw)
    scores = model.eval(TrainerArgs(run_name="e", batch_size=2), [entry])
    res = model.infer(img, threshold=1.0)  # no detection: no mask PNG, so no PIL
    assert len(res) == 0 and model.forward(img[None]).masks.shape == (1, 10, 64, 64)
    out += sorted(scores)
loaded = sorted(k for k, v in sys.modules.items() if v is not None and k.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("OK", *out)
"""


def _run(script: str) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout.strip()


def test_port_imports_and_serves_without_jax_pil_cv2():
    assert _run(SCRIPT).endswith("OK 300")


def test_fai_detr_trains_without_jax_pil_cv2():
    assert _run(TRAIN_SCRIPT).split()[-2:] == ["OK", "2"]


def test_fai_detr_m_serves_and_datasets_parse_without_jax_pil_cv2():
    assert _run(DATA_SCRIPT).split()[-2:] == ["OK", "10"]


def test_fai_mf_evaluates_without_jax_pil_cv2():
    assert _run(MF_SCRIPT).split()[-4:] == ["OK", "bbox", "segm", "sem_seg"]


def test_rtmo_serves_without_jax_pil_cv2():
    assert _run(RTMO_SCRIPT).split()[-2] == "OK"


# an import statement of focoos_tpu or a module under it (focoos_tpu_torch is
# another name), or a dynamic import of one
_JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(from|import)\s+focoos_tpu(?!\w)|import_module\(\s*f?[\"']focoos_tpu(?!\w)|__import__\(\s*[\"']focoos_tpu(?!\w)"
)


def test_port_sources_never_import_the_jax_package():
    sources = sorted(Path(REPO, "focoos_tpu_torch").rglob("*.py")) + [Path(REPO, "chip_smoke.py")]
    assert len(sources) > 40
    found = [f"{p.relative_to(REPO)}:{n}: {line.strip()}" for p in sources
             for n, line in enumerate(p.read_text().splitlines(), 1) if _JAX_PACKAGE_IMPORT.search(line)]
    assert not found, found


def test_jax_package_import_pattern():
    for line in ("from focoos_tpu.ports import TrainerArgs", "import focoos_tpu", "    import focoos_tpu.structures as s",
                 'importlib.import_module("focoos_tpu.models.rtmo")', "from focoos_tpu import ModelManager"):
        assert _JAX_PACKAGE_IMPORT.search(line), line
    for line in ("from focoos_tpu_torch.ports import TrainerArgs", "import focoos_tpu_torch",
                 'importlib.import_module(f"focoos_tpu_torch.models.{family}")', "# see focoos_tpu/ports.py"):
        assert not _JAX_PACKAGE_IMPORT.search(line), line
