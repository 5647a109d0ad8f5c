"""Checkpoints of training state (:mod:`.checkpoint`): the reference's
on-disk layout, so either package restores the other's."""
from .checkpoint import AsyncCheckpointer, latest_step, restore, save  # noqa: F401
