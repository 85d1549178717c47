"""focoos_tpu_torch — the PyTorch/CUDA port of focoos_tpu for NVIDIA Hopper.

Public surface (mirrors focoos_tpu/__init__.py)::

    from focoos_tpu_torch import ModelManager
    model = ModelManager.get("fai-detr-l-coco")      # device="cuda" by default
    detections = model.infer(image_hwc_uint8)

The package imports torch and never jax, flax or focoos_tpu: it keeps its
own copies of the numpy-only modules it needs from focoos_tpu (ports,
structures, model_registry, trainer events and hooks and evaluators, the data
pipeline, logger, vision, native with its C++).
"""

__version__ = "0.1.0"

_LAZY = {
    "ModelManager": ("focoos_tpu_torch.model_manager", "ModelManager"),
    "ConfigManager": ("focoos_tpu_torch.model_manager", "ConfigManager"),
    "BackboneManager": ("focoos_tpu_torch.model_manager", "BackboneManager"),
    "FocoosModel": ("focoos_tpu_torch.models.focoos_model", "FocoosModel"),
    "FocoosHUB": ("focoos_tpu_torch.hub.focoos_hub", "FocoosHUB"),
    "RemoteModel": ("focoos_tpu_torch.hub.remote_model", "RemoteModel"),
    "RemoteDataset": ("focoos_tpu_torch.hub.remote_dataset", "RemoteDataset"),
    "ApiClient": ("focoos_tpu_torch.hub.api_client", "ApiClient"),
    "FOCOOS_CONFIG": ("focoos_tpu_torch.config", "FOCOOS_CONFIG"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'focoos_tpu_torch' has no attribute '{name}'")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
