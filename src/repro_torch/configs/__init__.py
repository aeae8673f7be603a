from repro_torch.configs.base import (SHAPES, ModelConfig, RunConfig,
                                     ShapeSpec, reduced_config)
from repro_torch.configs.registry import ARCHS, get_config

__all__ = ["ModelConfig", "ShapeSpec", "RunConfig", "SHAPES", "reduced_config",
           "ARCHS", "get_config"]
