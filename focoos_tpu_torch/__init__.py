"""focoos_tpu_torch — the PyTorch/CUDA port of focoos_tpu for NVIDIA Hopper.

Public surface (mirrors focoos_tpu/__init__.py)::

    from focoos_tpu_torch import ModelManager
    model = ModelManager.get("fai-detr-l-coco")      # device="cuda" by default
    detections = model.infer(image_hwc_uint8)

The package imports torch and never jax or flax; it reuses the pure-Python
modules of focoos_tpu (ports, model_registry, structures, logger, vision).
"""

__version__ = "0.1.0"

_LAZY = {
    "ModelManager": ("focoos_tpu_torch.model_manager", "ModelManager"),
    "ConfigManager": ("focoos_tpu_torch.model_manager", "ConfigManager"),
    "BackboneManager": ("focoos_tpu_torch.model_manager", "BackboneManager"),
    "FocoosModel": ("focoos_tpu_torch.models.focoos_model", "FocoosModel"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'focoos_tpu_torch' has no attribute '{name}'")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
