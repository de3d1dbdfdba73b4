from . import presets
from .base import (DataConfig, DepthConfig, GridConfig, HSAConfig, LossConfig,
                   PropagationConfig, SANConfig, VeonConfig, ViTConfig)

__all__ = ["presets", "DataConfig", "DepthConfig", "GridConfig", "HSAConfig", "LossConfig",
           "PropagationConfig", "SANConfig", "VeonConfig", "ViTConfig"]
