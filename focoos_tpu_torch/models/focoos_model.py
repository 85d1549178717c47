"""FocoosModel — the user-facing model handle (port of
focoos_tpu/models/focoos_model.py; reference: focoos/models/focoos_model.py).

Owns ``(nn.Module on a device, ModelInfo, Processor)`` and exposes the
reference's verbs. The forward runs eagerly under ``torch.inference_mode()``.
Training, evaluation and export are ported in later slices (ROADMAP Queue 1).
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from focoos_tpu.ports import (
    ArtifactName,
    FocoosDetections,
    InferLatency,
    LatencyMetrics,
    ModelConfig,
    ModelInfo,
    Task,
)
from focoos_tpu.utils.logger import get_logger
from focoos_tpu_torch.processor.processor_manager import ProcessorManager
from focoos_tpu_torch.utils.weights import from_jax_variables

logger = get_logger(__name__)


class FocoosModel:
    """High-level model API (reference: focoos/models/focoos_model.py:100)."""

    def __init__(
        self,
        module: torch.nn.Module,
        config: ModelConfig,
        model_info: ModelInfo,
        device: Union[str, torch.device],
        weights_dir: Optional[str] = None,
        init_weights: bool = True,
        seed: int = 0,
    ):
        self.config = config
        self.model_info = model_info
        self.device = torch.device(device)
        self.processor = ProcessorManager.get_processor(model_info.model_family, config, model_info.im_size)
        local = os.path.join(weights_dir, ArtifactName.WEIGHTS.value) if weights_dir else None
        if init_weights and local and os.path.isfile(local):
            self.load_weights(local, module)  # strict: covers every weight
        else:
            # made on the CPU from the seed, so a seed gives the same model on every device
            module.init_weights(torch.Generator().manual_seed(seed))
        self.module = module.to(self.device).eval()

    @property
    def name(self) -> str:
        return self.model_info.name

    @property
    def task(self) -> Task:
        return self.model_info.task

    @property
    def classes(self) -> List[str]:
        return self.model_info.classes

    @property
    def im_size(self) -> Tuple[int, int]:
        s = self.model_info.im_size or 640
        return (s, s) if isinstance(s, int) else tuple(s)

    def load_weights(self, path: str, module: Optional[torch.nn.Module] = None) -> None:
        """Load the JAX package's ``model_final.npz`` (strict: every key must match)."""
        module = self.module if module is None else module
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
        module.load_state_dict(from_jax_variables(flat, self.model_info.model_family.value), strict=True)
        logger.info(f"Loaded weights from {path}")

    # ------------------------------------------------------------------
    def forward(self, images: Union[np.ndarray, torch.Tensor]):
        """Raw batched forward: NHWC uint8/float → family ModelOutput."""
        x = torch.as_tensor(images).to(self.device)
        with torch.inference_mode():
            out, _aux = self.module(x)
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(
        self,
        inputs,
        top_k: Optional[int] = None,
        threshold: Optional[float] = None,
        **kw,
    ) -> List[FocoosDetections]:
        """preprocess → forward → postprocess with per-stage latency
        (reference: focoos_model.py:575-621)."""
        t0 = time.perf_counter()
        batch, _ = self.processor.preprocess(inputs)
        t1 = time.perf_counter()
        out = self.forward(batch)
        self._sync()
        t2 = time.perf_counter()
        results = self.processor.postprocess(out, inputs, class_names=self.classes, top_k=top_k, threshold=threshold, **kw)
        t3 = time.perf_counter()
        latency = InferLatency(preprocess=t1 - t0, inference=t2 - t1, postprocess=t3 - t2)
        for r in results:
            r.latency = latency
        return results

    def infer(self, image, threshold: Optional[float] = None, annotate: bool = False, **kw) -> FocoosDetections:
        """Single-image inference (reference: focoos_model.py:370-416). An
        ndarray needs neither PIL nor cv2; paths, bytes and PIL images, and
        ``annotate``, go through ``focoos_tpu.utils.vision``."""
        t0 = time.perf_counter()
        if isinstance(image, np.ndarray):
            arr = np.stack([image] * 3, -1) if image.ndim == 2 else image[..., :3]
            arr = arr.astype(np.uint8, copy=False)
        else:
            from focoos_tpu.utils.vision import image_loader

            arr = image_loader(image)
        t1 = time.perf_counter()
        res = self([arr], threshold=threshold, **kw)[0]
        res.latency.imload = t1 - t0
        if annotate:
            from focoos_tpu.utils.vision import annotate_image

            t2 = time.perf_counter()
            res.image = annotate_image(arr, res, task=self.task, classes=self.classes)
            res.latency.annotate = time.perf_counter() - t2
        return res

    # ------------------------------------------------------------------
    def benchmark(self, iterations: int = 50, size: Optional[Union[int, Tuple[int, int]]] = None) -> LatencyMetrics:
        """Device forward latency at batch 1, timed with CUDA events
        (reference: focoos_model.py:694). Raises off the card: a CPU time is
        not a device number."""
        if self.device.type != "cuda":
            raise RuntimeError("benchmark times the card with CUDA events; this model is on " + str(self.device))
        size = size or self.im_size
        hw = (size, size) if isinstance(size, int) else tuple(size)
        g = torch.Generator().manual_seed(0)
        x = (torch.rand((1, *hw, 3), generator=g) * 255.0).to(self.device)
        times = []
        with torch.inference_mode():
            for _ in range(3):  # warm-up: first launches, kernel builds, cuDNN autotune
                self.module(x)
            for _ in range(iterations):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                self.module(x)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
        arr = np.array(times)
        return LatencyMetrics(
            fps=int(round(1000.0 / arr.mean())),
            engine="torch.cuda",
            min=round(float(arr.min()), 3),
            max=round(float(arr.max()), 3),
            mean=round(float(arr.mean()), 3),
            std=round(float(arr.std()), 3),
            im_size=hw[0],
            device=torch.cuda.get_device_name(self.device),
        )

    # ------------------------------------------------------------------
    def train(self, *args, **kwargs):
        raise NotImplementedError("training is not ported yet (ROADMAP Queue 1 items 5-6)")

    def eval(self, *args, **kwargs):
        raise NotImplementedError("evaluation is not ported yet (ROADMAP Queue 1 item 6)")

    def export(self, *args, **kwargs):
        raise NotImplementedError("export is not ported yet (ROADMAP Queue 1 item 7)")
