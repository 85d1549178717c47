"""FocoosModel — the user-facing model handle (port of
focoos_tpu/models/focoos_model.py; reference: focoos/models/focoos_model.py).

Owns ``(nn.Module on a device, ModelInfo, Processor)`` and exposes the
reference's verbs. The forward runs eagerly under ``torch.inference_mode()``;
``train`` runs the port's trainer and ``eval`` its evaluation loop (every
family: fai_detr, fai_mf, bisenetformer, fai_cls, rtmo); ``export`` writes a
directory that ``infer.InferModel`` serves. The model
computes in its ``compute_dtype`` (fp32 or bf16) with fp32 parameters, as the
JAX package's FocoosModel (focoos_model.py:48,53).
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from focoos_tpu_torch.nn.layers.common import set_compute_dtype
from focoos_tpu_torch.ports import (
    ArtifactName,
    FocoosDetections,
    InferLatency,
    LatencyMetrics,
    ModelConfig,
    ModelInfo,
    RuntimeType,
    Task,
)
from focoos_tpu_torch.utils.logger import get_logger
from focoos_tpu_torch.processor.processor_manager import ProcessorManager
from focoos_tpu_torch.utils.checkpoint import load_variables_npz, merge_compatible, save_variables_npz
from focoos_tpu_torch.utils.latency import cuda_event_latency, end2end_latency
from focoos_tpu_torch.utils.weights import from_jax_variables, to_jax_variables

logger = get_logger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _compute_dtype(dtype: Optional[Union[str, torch.dtype]], device: torch.device) -> torch.dtype:
    """None, "float32", "bfloat16" or a ``torch.dtype`` → the torch dtype;
    raises on any other, and on bf16 for a card without it."""
    if dtype is None:
        return torch.float32
    dt = dtype if isinstance(dtype, torch.dtype) else _DTYPES.get(str(dtype))
    if dt not in _DTYPES.values():
        raise ValueError(f"dtype must be None, 'float32' or 'bfloat16', got {dtype!r}")
    if dt == torch.bfloat16 and device.type == "cuda" and not torch.cuda.is_bf16_supported():
        raise RuntimeError(f"dtype bfloat16: {torch.cuda.get_device_name(device)} has no bf16")
    return dt


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
        dtype: Optional[Union[str, torch.dtype]] = None,
    ):
        self.config = config
        self.model_info = model_info
        self.device = torch.device(device)
        self.dtype = _compute_dtype(dtype, self.device)
        self.compute_dtype = str(self.dtype).removeprefix("torch.")  # "float32" or "bfloat16", as JAX names it
        self.processor = ProcessorManager.get_processor(model_info.model_family, config, model_info.im_size)
        local = os.path.join(weights_dir, ArtifactName.WEIGHTS.value) if weights_dir else None
        loaded = None
        if init_weights and local and os.path.isfile(local):
            loaded = from_jax_variables(load_variables_npz(local), model_info.model_family.value)
        _, skipped, missing = merge_compatible(module.state_dict(), loaded or {})
        if skipped or missing:  # a file that covers every weight needs no random init
            # made on the CPU from the seed, so a seed gives the same model on every device
            module.init_weights(torch.Generator().manual_seed(seed))
        set_compute_dtype(module, self.dtype)
        self.module = module.to(self.device).eval()
        if loaded is not None:
            self._merge(loaded, local)

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

    def _merge(self, loaded: dict, path: str, strict: bool = False) -> None:
        merged, skipped, missing = merge_compatible(self.module.state_dict(), loaded, strict=strict)
        if skipped:
            logger.warning(f"load_weights: {len(skipped)} shape-mismatched keys skipped (e.g. {skipped[:3]})")
        if missing:
            logger.warning(f"load_weights: {len(missing)} keys missing from checkpoint (e.g. {missing[:3]})")
        self.module.load_state_dict(merged, strict=True)
        logger.info(f"Loaded weights from {path}")

    def load_weights(self, path: str, strict: bool = False) -> None:
        """Load the JAX package's ``model_final.npz``, shape-tolerant unless
        ``strict`` (reference: base_model.py:98-143): a weight whose name or
        shape the file lacks keeps its value."""
        self._merge(from_jax_variables(load_variables_npz(path), self.model_info.model_family.value), path, strict)

    def save_weights(self, path: str) -> str:
        """The weights (parameters and BatchNorm statistics) as ``path``, an
        npz in the JAX package's layout, which both packages load."""
        sd = {k: v.detach().cpu().numpy() for k, v in self.module.state_dict().items()}
        save_variables_npz(path, to_jax_variables(sd, self.model_info.model_family.value))
        return path

    # ------------------------------------------------------------------
    def forward(self, images: Union[np.ndarray, torch.Tensor]):
        """Raw batched forward: NHWC uint8/float → family ModelOutput (fp32
        outputs in either compute dtype, except fai_mf's masks, which stay in
        the compute dtype as the JAX package's)."""
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
        ``annotate``, go through ``focoos_tpu_torch.utils.vision``."""
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

            t2 = time.perf_counter()
            res.image = annotate_image(arr, res, task=self.task, classes=self.classes)
            res.latency.annotate = time.perf_counter() - t2
        return res

    # ------------------------------------------------------------------
    def benchmark(self, iterations: int = 50, size: Optional[Union[int, Tuple[int, int]]] = None) -> LatencyMetrics:
        """Device forward latency at batch 1, timed with CUDA events
        (reference: focoos_model.py:694). Raises off the card: a CPU time is
        not a device number."""
        size = size or self.im_size
        hw = (size, size) if isinstance(size, int) else tuple(size)
        g = torch.Generator().manual_seed(0)
        x = (torch.rand((1, *hw, 3), generator=g) * 255.0).to(self.device)
        with torch.inference_mode():
            return cuda_event_latency(lambda: self.module(x), iterations, "torch.cuda", hw[0], self.device)

    def end2end_benchmark(self, iterations: int = 50, size: Optional[int] = None) -> LatencyMetrics:
        """preprocess + forward + postprocess latency of one size² uint8
        image, on the host clock (``__call__`` synchronizes the card)
        (reference: focoos_model.py:723)."""
        return end2end_latency(self, size or self.im_size[0], iterations, f"torch.{self.device.type}.e2e", self.device)

    # ------------------------------------------------------------------
    def train(self, args, train_dataset, val_dataset=None):
        """Fine-tune on ``train_dataset`` on the model's device (reference:
        focoos_model.py:221-274): a sequence of DatasetEntry, such as the
        ``MapDataset`` that ``AutoDataset.get_split`` returns, which
        ``args.workers`` loader processes read and map (``val_dataset`` the
        same, mapped in the evaluation's producer thread) → {"run_dir",
        "metrics", "iterations"}; the module ends in eval mode holding the
        final (EMA when enabled) weights. The step computes in the model's
        dtype with fp32 parameters, gradients and optimizer state, as the
        JAX trainer does: ``args.amp_enabled`` is not read.

        With ``args.num_devices`` (or a 1-D ``args.mesh_shape``) above 1 and
        no process group live, it launches one process per device
        (``parallel.launch``: NCCL on the card, ``cuda:0`` onward, gloo on
        the CPU), each training a copy of this model on its share of every
        batch under ``args.sharding`` ("dp" or "fsdp"); this model then takes
        the trained weights and model info of rank 0. The datasets must
        pickle. Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set, no group
        yet) each process joins the group, trains its rank and takes the
        final weights, the same on every rank. Inside a live group
        (``launch``) it trains this process's rank."""
        from focoos_tpu_torch.parallel import mesh
        from focoos_tpu_torch.trainer.trainer import check_ported, requested_world, run_train

        check_ported(args)  # before any process starts
        n = requested_world(args, self.device)
        if n <= 1 or mesh.is_initialized():
            return run_train(self, args, train_dataset, val_dataset)
        from focoos_tpu_torch.parallel.launch import launch

        state = {k: v.detach().cpu() for k, v in self.module.state_dict().items()}
        portable = (state, self.config, self.model_info, self.device.type, self.dtype)
        out = launch(_train_rank, num_devices=n, args=(portable, args, train_dataset, val_dataset),
                     backend="nccl" if self.device.type == "cuda" else "gloo")
        with torch.no_grad():
            self.module.load_state_dict(out.pop("state"))
        self.module.eval()
        self.model_info = out.pop("model_info")
        return out

    @classmethod
    def _on_device(cls, state: dict, config: ModelConfig, model_info: ModelInfo,
                   device: torch.device, dtype: torch.dtype) -> "FocoosModel":
        """The model that ``config`` builds, holding ``state``, on ``device``."""
        from focoos_tpu_torch.model_manager import ModelManager

        family = model_info.model_family.value
        ModelManager._ensure_family_registered(family)
        module = ModelManager._builders[family](config)
        module.load_state_dict(state, strict=True)
        self = cls.__new__(cls)
        self.config, self.model_info, self.device = config, model_info, torch.device(device)
        self.dtype = dtype
        self.compute_dtype = str(dtype).removeprefix("torch.")
        self.processor = ProcessorManager.get_processor(model_info.model_family, config, model_info.im_size)
        set_compute_dtype(module, dtype)
        self.module = module.to(self.device).eval()
        return self

    def eval(self, args, val_dataset):
        """Score the model on ``val_dataset`` (a sequence of DatasetEntry, such
        as ``AutoDataset.get_split``'s ``MapDataset``) at
        ``args.batch_size`` → the task evaluator's results, e.g.
        ``{"bbox": {"AP": ..., "AP50": ...}}`` (reference: focoos_model.py:277)."""
        from focoos_tpu_torch.trainer.trainer import run_eval

        return run_eval(self, args, val_dataset)

    def export(
        self,
        runtime_type: RuntimeType = RuntimeType.CUDA_BF16,
        out_dir: Optional[str] = None,
        image_size: Optional[Union[int, Tuple[int, int]]] = None,
        batch_size: int = 1,
        size_buckets=None,
        overwrite: bool = False,
    ):
        """Export a servable directory and return an ``InferModel`` over it on
        this model's device (JAX focoos_model.py:282; reference:
        focoos_model.py:418-573): the weights (``model_final.npz``) and
        ``model_info.json`` always, the int8 store for ``CUDA_INT8``, and for
        ``TORCH_EXPORT`` a ``torch.export`` program at (batch_size, H, W, 3)
        uint8 plus one per ``size_buckets`` entry. ``overwrite=False`` reuses
        a complete directory."""
        from focoos_tpu_torch.infer.export import export_model

        return export_model(self, runtime_type, out_dir, image_size, batch_size,
                            size_buckets=size_buckets, overwrite=overwrite)


def _train_rank(portable, args, train_dataset, val_dataset):
    """One launched rank of ``FocoosModel.train``: the model on this rank's
    device, trained → its results with the trained weights (on the CPU) and
    the model info. Every rank returns them, for under torchrun every
    process goes on with its own; the trainer leaves the same full weights
    on every rank."""
    from focoos_tpu_torch.parallel import mesh
    from focoos_tpu_torch.trainer.trainer import run_train

    state, config, model_info, device_type, dtype = portable
    model = FocoosModel._on_device(state, config, model_info, mesh.local_device(device_type), dtype)
    out = run_train(model, args, train_dataset, val_dataset)
    out["state"] = {k: v.detach().cpu() for k, v in model.module.state_dict().items()}
    out["model_info"] = model.model_info
    return out
