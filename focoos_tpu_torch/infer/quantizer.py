"""Int8 post-training quantization (port of ``focoos_tpu/infer/quantizer.py``;
reference: focoos/infer/quantizer.py OnnxQuantizer).

- **Weight-only int8 storage**: every conv/dense kernel of at least 4096
  values is stored as int8 with per-output-channel absmax scales, in the JAX
  package's layout and keys (``<path>/kernel@q``, ``<path>/kernel@scale``).
  The numpy code is the JAX package's, so a store written by either package
  equals the other's bit for bit; loading dequantizes it to fp32
  (``utils/weights.py::from_jax_variables``).
- **Calibrated activation ranges**: a folder of images runs through the
  model with every int8 QDQ layer on (dynamic scales), each recording its
  input absmax; the largest over the images goes to ``calibration.npz``,
  keyed by the layer's JAX module path, so one artifact directory serves
  both packages. ``runtimes.Int8Runtime`` reads it as static input scales.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from focoos_tpu_torch.ports import ArtifactName, LatencyMetrics, ModelExtension
from focoos_tpu_torch.utils.logger import get_logger
from focoos_tpu_torch.utils.weights import from_jax_variables, jax_module_paths, to_jax_variables

logger = get_logger(__name__)

QUANT_SUFFIX = f".int8.{ModelExtension.WEIGHTS.value}"
MAX_CALIBRATION_IMAGES = 32


def model_variables(model) -> Dict[str, np.ndarray]:
    """A FocoosModel's weights as the JAX package's flat ``params/…`` /
    ``batch_stats/…`` arrays (the layout of ``model_final.npz``)."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.module.state_dict().items()}
    return to_jax_variables(sd, model.model_info.model_family.value)


def _is_quantizable(path: str, arr: np.ndarray) -> bool:
    return path.endswith("/kernel") and arr.ndim >= 2 and arr.size >= 4096


def quantize_weights_int8(flat: Dict[str, np.ndarray]) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
    """Flat JAX-layout variables → (store with int8 kernels + scales, SNR in dB
    per quantized kernel) (JAX quantizer.py:40-66)."""
    out: Dict[str, np.ndarray] = {}
    snr: Dict[str, float] = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if _is_quantizable(k, v):
            axes = tuple(range(v.ndim - 1))  # per-output-channel (last axis)
            scale = np.abs(v).max(axis=axes, keepdims=True) / 127.0
            scale = np.maximum(scale, 1e-12)
            q = np.clip(np.rint(v / scale), -127, 127).astype(np.int8)
            deq = q.astype(np.float32) * scale
            err = float(((v - deq) ** 2).sum())
            sig = float((v**2).sum())
            snr[k] = 10 * np.log10(max(sig, 1e-20) / max(err, 1e-20))
            out[k + "@q"] = q
            out[k + "@scale"] = scale.astype(np.float32)
        else:
            out[k] = v
    logger.info(f"Quantized {len(snr)} kernels to int8 (weight-only); median SNR "
                f"{np.median(list(snr.values())) if snr else float('nan'):.1f} dB")
    return out, snr


def dequantize_weights(flat: Dict[str, np.ndarray], dtype=np.float32) -> Dict[str, np.ndarray]:
    """An int8 store → flat variables, each int8 kernel times its scale (JAX quantizer.py:69-79)."""
    out = {}
    for k, v in flat.items():
        if k.endswith("@q"):
            base = k[:-2]
            out[base] = (v.astype(np.float32) * flat[base + "@scale"]).astype(dtype)
        elif not k.endswith("@scale"):
            out[k] = v
    return out


def load_calibration_scales(artifact_dir: str) -> Optional[Dict[str, float]]:
    """``calibration.npz`` of ``artifact_dir`` → {JAX module path: absmax / 127},
    or None without one (JAX runtimes.py:442-455)."""
    path = os.path.join(artifact_dir, ArtifactName.CALIBRATION.value)
    if not os.path.isfile(path):
        return None
    with np.load(path) as data:
        scales = {k: float(data[k]) / 127.0 for k in data.files}
    logger.info(f"Loaded {len(scales)} calibrated activation scales from {path}")
    return scales or None


class Quantizer:
    """User-facing post-training quantization (JAX quantizer.py:82; reference OnnxQuantizer: infer/quantizer.py:127)."""

    def __init__(self, model):
        self.model = model

    def quantize(self, out_dir: str, calibration_images_dir: Optional[str] = None) -> str:
        """Write ``model_final.int8.npz``, ``quant_report.txt`` (SNR per
        kernel, worst first) and ``model_info.json`` to ``out_dir``, and,
        given a folder of images, ``calibration.npz`` → the store's path.
        Calibration images go through the model's processor, at its size."""
        os.makedirs(out_dir, exist_ok=True)
        flat, snr = quantize_weights_int8(model_variables(self.model))
        name = ArtifactName.WEIGHTS.value.replace(f".{ModelExtension.WEIGHTS.value}", QUANT_SUFFIX)
        path = os.path.join(out_dir, name)
        np.savez_compressed(path, **flat)
        self.model.model_info.dump_json(out_dir)
        with open(os.path.join(out_dir, "quant_report.txt"), "w") as f:
            for k, v in sorted(snr.items(), key=lambda kv: kv[1]):
                f.write(f"{v:8.2f} dB  {k}\n")
        if calibration_images_dir and os.path.isdir(calibration_images_dir):
            self._calibrate(out_dir, calibration_images_dir)
        logger.info(f"Quantized model → {path} ({os.path.getsize(path) / 1e6:.1f} MB)")
        return path

    def _calibrate(self, out_dir: str, images_dir: str) -> None:
        """Each int8 layer's input absmax, the largest over ≤ 32 images of
        ``images_dir`` (sorted by name), one forward per image with the int8
        layers on and dynamic scales (JAX quantizer.py:103-140) →
        ``calibration.npz`` keyed by JAX module path."""
        from focoos_tpu_torch.nn.layers.common import calibration_absmax, set_int8_mode
        from focoos_tpu_torch.utils.vision import image_loader

        files = [
            os.path.join(images_dir, f)
            for f in sorted(os.listdir(images_dir))
            if f.lower().endswith((".jpg", ".jpeg", ".png"))
        ][:MAX_CALIBRATION_IMAGES]
        if not files:
            return
        model, module = self.model, self.model.module
        set_int8_mode(module, True, calibrate=True)
        try:
            for f in files:
                batch, _ = model.processor.preprocess([image_loader(f)])
                with torch.inference_mode():
                    module(torch.as_tensor(batch).to(model.device))
            absmax = calibration_absmax(module)
        finally:
            set_int8_mode(module, False)
        if absmax:
            paths = jax_module_paths(absmax, model.model_info.model_family.value)
            np.savez(os.path.join(out_dir, ArtifactName.CALIBRATION.value), **{paths[n]: v for n, v in absmax.items()})
        logger.info(f"Calibrated {len(absmax)} activation ranges over {len(files)} images")

    @staticmethod
    def load_quantized(model, path: str) -> None:
        """Load an int8 store into ``model``, dequantized to fp32."""
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
        model.module.load_state_dict(from_jax_variables(flat, model.model_info.model_family.value))
        logger.info(f"Loaded int8-quantized weights from {path}")

    def benchmark_comparison(self, quant_path: str, iterations: int = 20) -> Dict[str, LatencyMetrics]:
        """FocoosModel.benchmark with the float weights, then with the int8
        store's dequantized ones (JAX quantizer.py:150-161); the card only."""
        fp = self.model.benchmark(iterations=iterations)
        original = {k: v.clone() for k, v in self.model.module.state_dict().items()}
        try:
            self.load_quantized(self.model, quant_path)
            q = self.model.benchmark(iterations=iterations)
        finally:
            self.model.module.load_state_dict(original)
        return {"fp": fp, "int8": q}
