"""Unified model loading (port of focoos_tpu/model_manager.py; reference:
focoos/model_manager.py).

``ModelManager.get("fai-detr-l-coco")`` resolves a model card from the bundled
registry (``focoos_tpu.model_registry``, imported, not copied) or a local run
dir, builds the family's ``nn.Module``, initializes it from a seeded
``torch.Generator`` or loads the JAX package's ``model_final.npz``, and wraps
it in a ``FocoosModel`` on the requested device.
"""

from __future__ import annotations

import copy
import importlib
import os
from dataclasses import fields
from typing import Any, Callable, Dict, Optional, Union

import torch

from focoos_tpu.model_registry.model_registry import ModelRegistry
from focoos_tpu.ports import ArtifactName, ModelConfig, ModelFamily, ModelInfo
from focoos_tpu.utils.logger import get_logger
from focoos_tpu_torch.nn.backbone.base import BackboneConfig

logger = get_logger(__name__)


class BackboneManager:
    """model_type → (config class, module class) (reference: model_manager.py:237-303)."""

    _registry: Dict[str, tuple] = {}

    @classmethod
    def register(cls, model_type: str, config_cls: type, module_cls: type) -> None:
        cls._registry[model_type] = (config_cls, module_cls)

    @classmethod
    def _ensure(cls, model_type: str) -> None:
        if model_type not in cls._registry:
            # focoos_tpu_torch.nn.backbone.<model_type> registers itself on import
            importlib.import_module(f"focoos_tpu_torch.nn.backbone.{model_type}")
        if model_type not in cls._registry:
            raise ValueError(f"Unknown backbone: {model_type}")

    @classmethod
    def config_from_dict(cls, d: dict) -> BackboneConfig:
        cls._ensure(d["model_type"])
        return cls._registry[d["model_type"]][0].from_dict(d)

    @classmethod
    def from_config(cls, config: BackboneConfig):
        cls._ensure(config.model_type)
        return cls._registry[config.model_type][1](config)


class ConfigManager:
    """family → typed config, with nested backbone dispatch (reference: model_manager.py:306-389)."""

    _registry: Dict[str, type] = {}

    @classmethod
    def register(cls, family: Union[str, ModelFamily], config_cls: type) -> None:
        cls._registry[ModelFamily(family).value] = config_cls

    @classmethod
    def from_dict(cls, family: Union[str, ModelFamily], d: dict, **overrides: Any) -> ModelConfig:
        key = ModelFamily(family).value
        ModelManager._ensure_family_registered(key)
        config_cls = cls._registry[key]
        d = dict(d)
        known = {f.name for f in fields(config_cls)}
        bad_overrides = {k for k in overrides if k not in known and overrides[k] is not None}
        if bad_overrides:
            raise ValueError(f"Invalid config keys for {key}: {sorted(bad_overrides)} (known: {sorted(known)})")
        d.update({k: v for k, v in overrides.items() if v is not None})
        if isinstance(d.get("backbone_config"), dict):
            d["backbone_config"] = BackboneManager.config_from_dict(d["backbone_config"])
        bad = set(d) - known
        if bad:
            logger.warning(f"Dropping unknown config keys for {key}: {sorted(bad)}")
        return config_cls(**{k: v for k, v in d.items() if k in known})


class ModelManager:
    """Unified loader (reference: model_manager.py:17-234)."""

    _builders: Dict[str, Callable] = {}  # family → (config) -> nn.Module

    @classmethod
    def register_model(cls, family: Union[str, ModelFamily], builder: Callable) -> None:
        cls._builders[ModelFamily(family).value] = builder

    @classmethod
    def _ensure_family_registered(cls, family: str) -> None:
        if family in cls._builders and family in ConfigManager._registry:
            return
        mod = importlib.import_module(f"focoos_tpu_torch.models.{family}")
        for attr in dir(mod):
            if attr.startswith("_register"):
                getattr(mod, attr)()

    @classmethod
    def get(
        cls,
        name: str,
        *,
        device: Optional[Union[str, torch.device]] = None,
        num_classes: Optional[int] = None,
        image_size: Optional[Union[int, tuple]] = None,
        init_weights: bool = True,
        seed: int = 0,
        **config_overrides: Any,
    ):
        """Resolve + build a model on ``device`` (default ``"cuda"``; raises
        when CUDA is absent and no device was named). ``name`` may be a
        registry name or a local run dir holding model_info.json (and
        optionally the JAX package's model_final.npz).
        ``seed`` seeds the random init of every weight not loaded."""
        from focoos_tpu_torch.models.focoos_model import FocoosModel

        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("ModelManager.get: CUDA is not available; pass device='cpu' to run on the CPU")
            device = "cuda"

        weights_dir = None
        if os.path.isdir(str(name)) and os.path.isfile(os.path.join(str(name), ArtifactName.INFO.value)):
            model_info = ModelInfo.from_json(os.path.join(str(name), ArtifactName.INFO.value))
            weights_dir = str(name)
        elif ModelRegistry.exists(str(name)):
            # the registry caches its cards: edit a copy
            model_info = copy.deepcopy(ModelRegistry.get_model_info(str(name)))
        else:
            raise ValueError(
                f"'{name}' is neither a registry model nor a local dir with model_info.json. "
                f"Registry: {ModelRegistry.list_models()}"
            )

        family = ModelFamily(model_info.model_family).value
        cls._ensure_family_registered(family)

        if num_classes is not None and num_classes != len(model_info.classes):
            model_info.classes = [f"class_{i}" for i in range(num_classes)]
        if num_classes is not None:
            config_overrides["num_classes"] = num_classes
        if image_size is not None:
            model_info.im_size = image_size

        config = ConfigManager.from_dict(family, model_info.config, **config_overrides)
        model_info.config = config.to_dict()
        return FocoosModel(
            module=cls._builders[family](config),
            config=config,
            model_info=model_info,
            device=device,
            weights_dir=weights_dir,
            init_weights=init_weights,
            seed=seed,
        )
