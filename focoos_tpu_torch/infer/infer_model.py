"""InferModel — the serving handle over an exported directory (port of
``focoos_tpu/infer/infer_model.py``; reference: focoos/infer/infer_model.py:54-319).

``InferModel(dir, runtime_type, device=)`` reads ``model_info.json``, builds
the family's processor and loads the runtime's artifact; ``__call__`` runs
preprocess → runtime → ``export_postprocess`` with per-stage latency. The
device defaults to ``cuda`` and raises without it, as ``ModelManager.get``;
``RuntimeType.CPU`` runs on the host. A ``TORCH_EXPORT`` program serves on
the device it was exported on, and a ``device`` other than that raises.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Union

import numpy as np
import torch

from focoos_tpu_torch.ports import ArtifactName, FocoosDetections, InferLatency, LatencyMetrics, ModelInfo, RuntimeType
from focoos_tpu_torch.utils.latency import end2end_latency
from focoos_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)

_ARTIFACTS = {
    RuntimeType.TORCH_EXPORT: ArtifactName.EXPORTED_PROGRAM,
    RuntimeType.CUDA_INT8: ArtifactName.WEIGHTS_INT8,
}


def artifact_path(model_dir: str, runtime_type: RuntimeType) -> str:
    """The file a runtime loads from an exported directory: the program, the
    int8 store, or the weights (the eager runtimes)."""
    return os.path.join(model_dir, _ARTIFACTS.get(RuntimeType(runtime_type), ArtifactName.WEIGHTS).value)


def _device(runtime_type: RuntimeType, device: Optional[Union[str, torch.device]]) -> torch.device:
    if runtime_type == RuntimeType.CPU:
        if device is not None and torch.device(device).type != "cpu":
            raise ValueError(f"RuntimeType.CPU runs on the host, not {device}")
        return torch.device("cpu")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("InferModel: CUDA is not available; pass device='cpu' or RuntimeType.CPU for the host")
        device = "cuda"
    return torch.device(device)


class InferModel:
    def __init__(
        self,
        model_dir: str,
        runtime_type: RuntimeType = RuntimeType.CUDA_BF16,
        data_parallel: bool = False,
        device: Optional[Union[str, torch.device]] = None,
    ):
        info_path = os.path.join(model_dir, ArtifactName.INFO.value)
        if not os.path.isfile(info_path):
            raise FileNotFoundError(f"model_info.json not found in {model_dir}")
        runtime_type = RuntimeType(runtime_type)
        artifact = artifact_path(model_dir, runtime_type)
        if not os.path.isfile(artifact):
            raise FileNotFoundError(f"{artifact} missing — export with {runtime_type} first")
        self.model_dir = model_dir
        self.model_info = ModelInfo.from_json(info_path)
        self.runtime_type = runtime_type

        from focoos_tpu_torch.infer.runtimes import load_runtime
        from focoos_tpu_torch.model_manager import ConfigManager, ModelManager
        from focoos_tpu_torch.processor.processor_manager import ProcessorManager

        family = self.model_info.model_family
        ModelManager._ensure_family_registered(family.value)
        self.config = ConfigManager.from_dict(family, self.model_info.config)
        self.processor = ProcessorManager.get_processor(family, self.config, self.model_info.im_size)
        output_names = self.processor.get_output_names()
        if runtime_type == RuntimeType.TORCH_EXPORT:
            self.runtime = load_runtime(runtime_type, artifact_path=artifact, output_names=output_names,
                                        data_parallel=data_parallel,
                                        allow_resize_dispatch=self.processor.resize_dispatch_safe)
            on = self.runtime.device
            asked = on if device is None else torch.device(device)
            if asked.type != on.type or asked.index not in (None, on.index):
                raise ValueError(f"{artifact} was exported on {on} and serves there, not on {device}")
        else:
            device = _device(runtime_type, device)
            # the int8 model computes in bf16, as JAX's (infer_model.py:72)
            dtype = "float32" if runtime_type in (RuntimeType.CUDA_FP32, RuntimeType.CPU) else "bfloat16"
            built = ModelManager.get(model_dir, dtype=dtype, device=device)
            self.runtime = load_runtime(runtime_type, module=built.module, artifact_path=artifact,
                                        output_names=output_names, device=device, family=family.value,
                                        data_parallel=data_parallel)
        self.device = self.runtime.device

    @property
    def classes(self) -> List[str]:
        return self.model_info.classes

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, inputs, threshold: Optional[float] = None, **kw) -> List[FocoosDetections]:
        """preprocess → runtime → export_postprocess, with per-stage latency."""
        t0 = time.perf_counter()
        batch, _ = self.processor.preprocess(inputs)
        t1 = time.perf_counter()
        raw = self.runtime(batch)
        self._sync()
        t2 = time.perf_counter()
        results = self.processor.export_postprocess(raw, inputs, class_names=self.classes, threshold=threshold, **kw)
        t3 = time.perf_counter()
        for r in results:
            r.latency = InferLatency(preprocess=t1 - t0, inference=t2 - t1, postprocess=t3 - t2)
        return results

    def infer(self, image, threshold: Optional[float] = None, annotate: bool = False, **kw) -> FocoosDetections:
        """Single-image inference; an ndarray needs neither PIL nor cv2."""
        t0 = time.perf_counter()
        if isinstance(image, np.ndarray):
            arr = np.stack([image] * 3, -1) if image.ndim == 2 else image[..., :3]
            arr = arr.astype(np.uint8, copy=False)
        else:
            from focoos_tpu_torch.utils.vision import image_loader

            arr = image_loader(image)
        t1 = time.perf_counter()
        res = self([arr], threshold=threshold, **kw)[0]
        res.latency.imload = t1 - t0
        if annotate:
            from focoos_tpu_torch.utils.vision import annotate_image

            res.image = annotate_image(arr, res, task=self.model_info.task, classes=self.classes)
        return res

    def _size(self, size: Optional[int]) -> int:
        s = self.model_info.im_size
        return size or (s if isinstance(s, int) else s[0])

    def benchmark(self, iterations: int = 50, size: Optional[int] = None) -> LatencyMetrics:
        """The runtime's device time per call (CUDA events; raises off the card)."""
        return self.runtime.benchmark(iterations=iterations, size=self._size(size))

    def end2end_benchmark(self, iterations: int = 50, size: Optional[int] = None) -> LatencyMetrics:
        """preprocess + runtime + postprocess of one size² uint8 image, on the
        host clock (``__call__`` synchronizes the card)."""
        return end2end_latency(self, self._size(size), iterations, f"{type(self.runtime).__name__}.e2e", self.device)
