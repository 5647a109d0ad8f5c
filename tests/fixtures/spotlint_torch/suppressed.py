"""A real SPL002 violation silenced by a suppression comment. Expected:
zero findings (and exactly one if the comment is stripped)."""
import numpy as np
import torch


def staged_column(xs):
    return torch.as_tensor(np.asarray(xs)) * 2.0  # spotlint: disable=SPL002
