from . import presets
from .base import (DataConfig, DepthConfig, GridConfig, HSAConfig, LossConfig,
                   PropagationConfig, SANConfig, VeonConfig, ViTConfig, ZoeConfig)

__all__ = ["presets", "DataConfig", "DepthConfig", "GridConfig", "HSAConfig", "LossConfig",
           "PropagationConfig", "SANConfig", "VeonConfig", "ViTConfig", "ZoeConfig"]
