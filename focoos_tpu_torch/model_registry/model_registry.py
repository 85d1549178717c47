"""Bundled model registry of the port (copy of
``focoos_tpu/model_registry/model_registry.py``; reference:
focoos/model_registry/model_registry.py).

Cards are compact JSON files shipped as package data, copies of the JAX
package's cards (tools/gen_registry_cards.py produces those) for the models
the port builds; other cards land with their families.
"""

from __future__ import annotations

import os
from typing import Dict, List

from focoos_tpu_torch.ports import ModelInfo

_CARDS_DIR = os.path.dirname(__file__)


class ModelRegistry:
    _cache: Dict[str, ModelInfo] = {}

    @classmethod
    def list_models(cls) -> List[str]:
        return sorted(f[:-5] for f in os.listdir(_CARDS_DIR) if f.endswith(".json"))

    @classmethod
    def exists(cls, name: str) -> bool:
        return os.path.isfile(os.path.join(_CARDS_DIR, f"{name}.json"))

    @classmethod
    def get_model_info(cls, name: str) -> ModelInfo:
        if name in cls._cache:
            return cls._cache[name]
        path = os.path.join(_CARDS_DIR, f"{name}.json")
        if not os.path.isfile(path):
            raise ValueError(f"Model '{name}' not found in registry. Available: {cls.list_models()}")
        info = ModelInfo.from_json(path)
        cls._cache[name] = info
        return info
