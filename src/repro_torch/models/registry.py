"""Model registry: arch name -> (config, model fns).

Port of ``repro/models/registry.py``."""
from repro_torch.configs.registry import get_config, get_shape
from repro_torch.models import model

__all__ = ["model", "get_config", "get_shape"]
