"""Model export (port of ``focoos_tpu/infer/export.py``; reference:
focoos_model.py:418-573 FocoosModel.export).

Every export writes ``model_final.npz`` (the JAX package's layout) and
``model_info.json`` with ``im_size`` set to the export size, so that both
packages serve the directory. Then, by runtime type:

- ``CUDA_INT8``: the int8 weight store ``model_int8.npz`` (``quantizer.py``);
- ``TORCH_EXPORT``: a ``torch.export`` program of the model at
  (batch_size, H, W, 3) uint8 in its device and compute dtype
  (``model.pt2``), and one program per extra size bucket
  (``model_{H}x{W}.pt2``) — the counterpart of JAX's StableHLO programs.
  The kernels enter the programs as the custom ops of ``focoos_tpu_torch/ops``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from focoos_tpu_torch.ports import MODELS_DIR, ArtifactName, RuntimeType, bucket_program_name
from focoos_tpu_torch.utils.logger import get_logger

logger = get_logger(__name__)


class ExportOutputs(torch.nn.Module):
    """A family's module → the tuple of its outputs in ``get_output_names`` order."""

    def __init__(self, module: torch.nn.Module, output_names: Sequence[str]):
        super().__init__()
        self.module, self.output_names = module, list(output_names)

    def forward(self, images: torch.Tensor):
        out, _ = self.module(images)
        return tuple(getattr(out, n) for n in self.output_names)


def export_program(model, hw: Tuple[int, int], batch_size: int, path: str) -> str:
    """``torch.export`` the model's eval forward at (batch_size, H, W, 3) uint8
    on its device, traced without gradients and outside inference mode, to ``path``."""
    wrapper = ExportOutputs(model.module.eval(), model.processor.get_output_names())
    example = torch.zeros((batch_size, *hw, 3), dtype=torch.uint8, device=model.device)
    with torch.no_grad():
        program = torch.export.export(wrapper, (example,), strict=False)
    torch.export.save(program, path)
    logger.info(f"Exported program @{hw} to {path} ({os.path.getsize(path) / 1e6:.1f} MB)")
    return path


def export_model(
    model,
    runtime_type: RuntimeType = RuntimeType.CUDA_BF16,
    out_dir: Optional[str] = None,
    image_size: Optional[Union[int, Tuple[int, int]]] = None,
    batch_size: int = 1,
    size_buckets: Optional[Sequence] = None,
    overwrite: bool = False,
):
    """→ ``InferModel`` over the exported directory, on the model's device.
    ``size_buckets``: extra sizes (int or (H, W)) for ``TORCH_EXPORT``.
    ``overwrite=False`` reuses a directory that already holds
    ``model_info.json`` and the runtime's artifact (JAX export.py:23-136)."""
    from focoos_tpu_torch.infer.infer_model import InferModel, artifact_path

    runtime_type = RuntimeType(runtime_type)
    out_dir = out_dir or os.path.join(MODELS_DIR, model.name, "export")
    complete = os.path.isfile(os.path.join(out_dir, ArtifactName.INFO.value)) and os.path.isfile(
        artifact_path(out_dir, runtime_type))
    if not overwrite and complete:
        logger.info(f"Reusing existing export at {out_dir} (overwrite=False)")
        return InferModel(out_dir, runtime_type=runtime_type, device=model.device)
    os.makedirs(out_dir, exist_ok=True)

    size = image_size or model.im_size
    hw = (size, size) if isinstance(size, int) else tuple(size)

    model.save_weights(os.path.join(out_dir, ArtifactName.WEIGHTS.value))
    model.model_info.im_size = hw[0] if hw[0] == hw[1] else hw
    model.model_info.dump_json(out_dir)

    if runtime_type == RuntimeType.CUDA_INT8:
        from focoos_tpu_torch.infer.quantizer import model_variables, quantize_weights_int8

        store, _ = quantize_weights_int8(model_variables(model))
        path = os.path.join(out_dir, ArtifactName.WEIGHTS_INT8.value)
        np.savez(path, **store)
        logger.info(f"Exported int8 weights to {path} ({os.path.getsize(path) / 1e6:.1f} MB)")

    if runtime_type == RuntimeType.TORCH_EXPORT:
        export_program(model, hw, batch_size, os.path.join(out_dir, ArtifactName.EXPORTED_PROGRAM.value))
        for b in size_buckets or ():
            bhw = (b, b) if isinstance(b, int) else tuple(b)
            if bhw != hw:
                export_program(model, bhw, batch_size, os.path.join(out_dir, bucket_program_name(bhw)))

    logger.info(f"Export complete → {out_dir}")
    return InferModel(out_dir, runtime_type=runtime_type, device=model.device)
