"""Inference runtimes (port of ``focoos_tpu/infer/runtimes.py``; reference:
focoos/infer/runtimes/).

- ``TorchRuntime`` (``CUDA_FP32``, ``CUDA_BF16``, ``CPU``; JAX's
  ``XLARuntime``): the eager module, one forward per call. Weights stay
  module parameters (the JAX engine's weights-as-constants has no
  counterpart), and no CUDA graph or ``torch.compile`` is used.
- ``Int8Runtime`` (``CUDA_INT8``; JAX's ``Int8XLARuntime``): a bf16 module
  holding the int8 store's dequantized weights, its QDQ layers switched on
  with the calibrated scales where ``calibration.npz`` has them.
- ``ExportedProgramRuntime`` (``TORCH_EXPORT``; JAX's ``StableHLORuntime``):
  ``torch.export`` programs of fixed shape, ``model.pt2`` and its
  ``model_{H}x{W}.pt2`` buckets, which hold the kernels as the custom ops
  of ``focoos_tpu_torch/ops``.

``data_parallel`` (JAX runtimes.py:138-190) serves a module runtime from a
replica on each of several devices (``DataParallelRuntime``): the batch is
padded up to a multiple of the replicas with its last image, split among
them, and the outputs gathered on the first device and cropped back.

Each runtime takes an NHWC batch (numpy or tensor) and returns the
outputs, tensors on its device, in the processor's ``get_output_names``
order. ``benchmark`` times the card with CUDA events, as
``FocoosModel.benchmark`` does, and raises off the card.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from focoos_tpu_torch.ports import ArtifactName, LatencyMetrics, ModelExtension, RuntimeType
from focoos_tpu_torch.utils.latency import cuda_event_latency
from focoos_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


class BaseRuntime:
    """(JAX runtimes.py:80; reference: infer/runtimes/base.py:10)"""

    device: torch.device

    def __call__(self, images) -> List[torch.Tensor]:
        raise NotImplementedError

    def _benchmark_input(self, size: int) -> torch.Tensor:
        g = torch.Generator().manual_seed(0)
        return torch.randint(0, 256, (1, size, size, 3), generator=g, dtype=torch.uint8).to(self.device)

    def benchmark(self, iterations: int = 50, size: int = 640) -> LatencyMetrics:
        """Device time of one call on a uint8 batch, CUDA events around each
        of ``iterations`` calls after three warm-up calls. Raises off the card."""
        x = self._benchmark_input(size)
        return cuda_event_latency(lambda: self(x), iterations, type(self).__name__, x.shape[1], self.device)


class TorchRuntime(BaseRuntime):
    """The eager module (counterpart of JAX's ``XLARuntime``, runtimes.py:125):
    one forward per call in the module's compute dtype."""

    def __init__(self, module: torch.nn.Module, output_names: List[str], device: torch.device):
        self.module = module.eval()
        self.output_names = output_names
        self.device = torch.device(device)

    def to_device(self, device: torch.device) -> "TorchRuntime":
        """Move the module (and so the runtime) to ``device``."""
        self.device = torch.device(device)
        self.module.to(self.device)
        return self

    def __call__(self, images) -> List[torch.Tensor]:
        x = torch.as_tensor(images).to(self.device)
        with torch.inference_mode():
            out, _ = self.module(x)
        return [getattr(out, name) for name in self.output_names]


class Int8Runtime(TorchRuntime):
    """Weight-only int8 serving (counterpart of JAX's ``Int8XLARuntime``,
    runtimes.py:228): ``module`` (built in bf16, as JAX's InferModel builds
    it) takes the store's dequantized weights, then its QDQ layers switch on,
    each with its calibrated input scale where ``act_scales`` (JAX module
    path → scale) has one, else the dynamic one."""

    def __init__(self, module: torch.nn.Module, store: Dict[str, np.ndarray], output_names: List[str],
                 device: torch.device, family: str, act_scales: Optional[Dict[str, float]] = None):
        from focoos_tpu_torch.nn.layers.common import int8_layers, set_int8_mode
        from focoos_tpu_torch.utils.weights import from_jax_variables, jax_module_paths

        super().__init__(module, output_names, device)
        module.load_state_dict(from_jax_variables(store, family))
        paths = jax_module_paths(int8_layers(module), family)
        scales = {name: act_scales[p] for name, p in paths.items() if act_scales and p in act_scales}
        self.num_int8_layers = set_int8_mode(module, True, act_scales=scales)
        self.num_static_scales = len(scales)
        logger.info(f"Int8Runtime: {self.num_int8_layers} int8 layers, {len(scales)} with calibrated scales")


class DataParallelRuntime(BaseRuntime):
    """A module runtime replicated on ``devices`` (JAX's ``XLARuntime`` with
    ``data_parallel``, runtimes.py:138-190): a batch of n is padded with its
    last image up to a multiple of the replicas, each replica takes an equal
    contiguous part, each part's forward is queued on its device before any
    output is read, and the outputs come back concatenated on the first
    device, cropped to n."""

    def __init__(self, runtime: TorchRuntime, devices: Sequence[torch.device]):
        import copy

        from focoos_tpu_torch.nn.layers.common import clear_cast_caches

        devices = [torch.device(d) for d in devices]
        if devices[0] != runtime.device:
            raise ValueError(f"the first device {devices[0]} must be the runtime's own, {runtime.device}")
        clear_cast_caches(runtime.module)
        self.replicas = [runtime] + [copy.deepcopy(runtime).to_device(d) for d in devices[1:]]
        self.output_names = runtime.output_names
        self.device = devices[0]

    def __call__(self, images) -> List[torch.Tensor]:
        x = torch.as_tensor(images)
        n, d = x.shape[0], len(self.replicas)
        pad = (-n) % d
        if pad:
            x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        parts = [r(part) for r, part in zip(self.replicas, x.chunk(d))]
        return [torch.cat([p[k].to(self.device) for p in parts])[:n] for k in range(len(self.output_names))]


def _program_input_shape(program) -> Tuple[int, ...]:
    """The fixed shape of an exported program's one user input."""
    name = program.graph_signature.user_inputs[0]
    node = next(n for n in program.graph.nodes if n.op == "placeholder" and n.name == name)
    return tuple(int(d) for d in node.meta["val"].shape)


def _program_device(program) -> torch.device:
    for t in (*program.state_dict.values(), *program.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def resize_uint8(images: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Squash-resize an NHWC batch to ``hw`` (bilinear, half-pixel centers),
    rounded to uint8, the programs' input type."""
    from focoos_tpu_torch.processor.base_processor import resize_bilinear

    return np.stack([np.clip(np.rint(resize_bilinear(im, hw)), 0, 255) for im in images]).astype(np.uint8)


class ExportedProgramRuntime(BaseRuntime):
    """Serves ``torch.export`` programs (counterpart of JAX's
    ``StableHLORuntime``, runtimes.py:340). ``model.pt2`` and each
    ``model_{H}x{W}.pt2`` beside it are loaded as shape buckets. A request
    whose (H, W) has no program goes to the closest bucket by area,
    squash-resized, unless ``allow_resize_dispatch`` is false (pixel-frame
    outputs), which raises. A batch is padded (with its last image) and
    chunked to the programs' fixed batch. A float batch (the processor's
    resize) is rounded to uint8, the programs' input type."""

    def __init__(self, artifact_path: str, output_names: List[str], allow_resize_dispatch: bool = True):
        # the custom ops the programs call must be registered before they load
        from focoos_tpu_torch.ops import msda, nms, stem  # noqa: F401

        self._programs: Dict[Tuple[int, int], torch.nn.Module] = {}
        ext = ModelExtension.EXPORTED_PROGRAM.value
        paths = [artifact_path] + sorted(
            p for p in glob.glob(os.path.join(os.path.dirname(artifact_path), f"model_*x*.{ext}"))
            if re.fullmatch(rf"model_\d+x\d+\.{ext}", os.path.basename(p))
        )
        for i, path in enumerate(paths):
            program = torch.export.load(path)
            shape = _program_input_shape(program)
            if i == 0:
                self._batch, self._hw = shape[0], shape[1:3]
                self.device = _program_device(program)
            self._programs.setdefault(shape[1:3], program.module())
        self.output_names = output_names
        self._allow_resize = allow_resize_dispatch

    @property
    def sizes(self) -> List[Tuple[int, int]]:
        return sorted(self._programs)

    def pick(self, h: int, w: int) -> Tuple[Tuple[int, int], bool]:
        """(the bucket a request of h x w goes to, whether it is resized)."""
        if (h, w) in self._programs:
            return (h, w), False
        if not self._allow_resize:
            raise ValueError(
                f"no exported program for input {h}x{w}, and this model's outputs are in the input's pixel frame"
                f" (resize dispatch unsafe); programs: {self.sizes} — export a matching size bucket"
            )
        return min(self._programs, key=lambda hw: abs(hw[0] * hw[1] - h * w)), True

    def __call__(self, images) -> List[torch.Tensor]:
        if isinstance(images, torch.Tensor):
            images = images.cpu().numpy()
        images = np.asarray(images)
        hw, resize = self.pick(images.shape[1], images.shape[2])
        if resize:
            images = resize_uint8(images, hw)
        elif images.dtype != np.uint8:
            images = np.clip(np.rint(images), 0, 255).astype(np.uint8)
        program, n, b = self._programs[hw], images.shape[0], self._batch
        # a program keeps the layout its example had (NHWC, contiguous): a
        # ``.contiguous()`` that was a no-op while tracing is not in the graph
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        chunks = []
        with torch.no_grad():
            for i in range(0, n, b):
                part = x[i:i + b]
                if part.shape[0] < b:
                    part = torch.cat([part, part[-1:].expand(b - part.shape[0], *part.shape[1:])])
                chunks.append(program(part))
        return [torch.cat([c[k] for c in chunks])[:n] for k in range(len(self.output_names))]

    def _benchmark_input(self, size: int) -> torch.Tensor:
        # the program's own fixed shape
        g = torch.Generator().manual_seed(0)
        return torch.randint(0, 256, (self._batch, *self._hw, 3), generator=g, dtype=torch.uint8).to(self.device)


def load_runtime(
    runtime_type: RuntimeType,
    *,
    module: Optional[torch.nn.Module] = None,
    artifact_path: Optional[str] = None,
    output_names: List[str],
    device: Optional[torch.device] = None,
    family: Optional[str] = None,
    data_parallel: bool = False,
    allow_resize_dispatch: bool = True,
    devices: Optional[Sequence[torch.device]] = None,
) -> BaseRuntime:
    """RuntimeType → runtime (JAX runtimes.py:457; reference: infer/runtimes/load_runtime.py:25).
    ``data_parallel``: the module runtimes served from a replica on each of
    ``devices`` (default: every local CUDA device for a module on the card,
    else ``device`` alone), the first of them ``device``; one device is the
    plain runtime. Exported programs are fixed to the device they were
    exported on and take no ``data_parallel``."""
    runtime_type = RuntimeType(runtime_type)
    if data_parallel:
        if runtime_type == RuntimeType.TORCH_EXPORT:
            raise ValueError("data_parallel serves the module runtimes; an exported program stays on its device")
        runtime = load_runtime(runtime_type, module=module, artifact_path=artifact_path, output_names=output_names,
                               device=device, family=family)
        if runtime.device.type == "cuda" and runtime.device.index is None:
            runtime.device = torch.device("cuda", torch.cuda.current_device())
        if devices is None:
            devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                       if runtime.device.type == "cuda" else [runtime.device])
            devices = [runtime.device] + [d for d in devices if d != runtime.device]
        return runtime if len(devices) == 1 else DataParallelRuntime(runtime, devices)
    if runtime_type in (RuntimeType.CUDA_BF16, RuntimeType.CUDA_FP32, RuntimeType.CPU):
        if module is None or device is None:
            raise ValueError(f"{runtime_type} needs the module and its device")
        return TorchRuntime(module, output_names, device)
    if runtime_type == RuntimeType.CUDA_INT8:
        if module is None or device is None or artifact_path is None or family is None:
            raise ValueError("CUDA_INT8 needs the module, its device, its family and the int8 store's path")
        from focoos_tpu_torch.infer.quantizer import load_calibration_scales

        with np.load(artifact_path) as data:
            store = {k: data[k] for k in data.files}
        return Int8Runtime(module, store, output_names, device, family,
                           act_scales=load_calibration_scales(os.path.dirname(artifact_path)))
    if runtime_type == RuntimeType.TORCH_EXPORT:
        if artifact_path is None:
            raise ValueError(f"TORCH_EXPORT needs the program's path ({ArtifactName.EXPORTED_PROGRAM.value})")
        return ExportedProgramRuntime(artifact_path, output_names, allow_resize_dispatch=allow_resize_dispatch)
    raise ValueError(f"Unsupported runtime type: {runtime_type}")
