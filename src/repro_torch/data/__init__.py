"""Synthetic LM token streams for the port's training path."""
from .pipeline import DataConfig, SyntheticLM, make_pipeline  # noqa: F401
