"""Model configurations, copied from ``repro.configs`` (data only)."""
from .base import ModelConfig, MoEConfig, MLAConfig, ShapeConfig, TrainConfig, SHAPES  # noqa: F401
