"""Spot-elastic data-parallel training on an engine-provisioned pool
(:mod:`.cluster`)."""
from .cluster import ElasticConfig, Node, SpotElasticTrainer, StepEvent  # noqa: F401
