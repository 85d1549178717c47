"""family → Processor lazy registry (port of focoos_tpu/processor/processor_manager.py)."""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Optional, Tuple, Union

from focoos_tpu.ports import ModelConfig, ModelFamily
from focoos_tpu_torch.processor.base_processor import Processor


class ProcessorManager:
    _registry: Dict[str, Callable[..., Processor]] = {}

    @classmethod
    def register(cls, family: Union[str, ModelFamily], loader: Callable[..., Processor]) -> None:
        cls._registry[ModelFamily(family).value] = loader

    @classmethod
    def get_processor(
        cls,
        family: Union[str, ModelFamily],
        config: ModelConfig,
        image_size: Optional[Union[int, Tuple[int, int]]] = None,
    ) -> Processor:
        key = ModelFamily(family).value
        if key not in cls._registry:
            mod = importlib.import_module(f"focoos_tpu_torch.models.{key}")
            for attr in dir(mod):
                if attr.startswith("_register"):
                    getattr(mod, attr)()
        if key not in cls._registry:
            raise ValueError(f"No processor registered for family {key}")
        return cls._registry[key](config, image_size)
