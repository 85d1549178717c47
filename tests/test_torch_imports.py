"""The port stands without JAX: with ``jax``, ``jaxlib``, ``flax``, ``PIL`` and
``cv2`` made unimportable, every module of focoos_tpu_torch imports and the
fai-detr slice serves an ndarray image on the CPU."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "PIL", "cv2")
for name in BLOCKED:
    sys.modules[name] = None  # any import of these now raises ImportError

import numpy as np
import focoos_tpu_torch
for mod in pkgutil.walk_packages(focoos_tpu_torch.__path__, "focoos_tpu_torch."):
    importlib.import_module(mod.name)

from focoos_tpu_torch import ModelManager
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


def test_port_imports_and_serves_without_jax_pil_cv2():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK 300")
