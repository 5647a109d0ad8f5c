"""Deliberate SPL002 violation: a host column staged with no dtype pin —
numpy's float64 becomes a float64 tensor.  Expected: exactly one SPL002
finding."""
import numpy as np
import torch


def staged_column(xs, device):
    return torch.as_tensor(np.asarray(xs), device=device) * 2.0
