from focoos_tpu_torch.model_registry.model_registry import ModelRegistry

__all__ = ["ModelRegistry"]
