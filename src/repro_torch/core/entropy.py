"""Entropy-based integrity assessment of the USQS sample stream (paper §3.1.1).

H(X) = -sum p(x) log2 p(x) over the discrete outcomes observed at USQS query
points.  Low entropy (paper: 2.5052 bits vs the 3.4594-bit uniform maximum
over the 11-point support) certifies that SPS transitions are predictable
enough for sparse sampling to capture them.

``empirical_entropy`` and ``max_entropy`` are numpy copies of
``repro.core.entropy``; ``entropy_bits`` computes the reference's jitted
histogram entropy in PyTorch on the histogram's own device.
"""
from __future__ import annotations

import numpy as np
import torch


def empirical_entropy(samples, support_size: int | None = None) -> float:
    """Shannon entropy (bits) of the empirical distribution of `samples`."""
    samples = np.asarray(samples)
    _, counts = np.unique(samples, return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log2(p)).sum())


def max_entropy(support_size: int) -> float:
    """Entropy of the uniform distribution over `support_size` outcomes."""
    return float(np.log2(support_size))


def entropy_bits(counts: torch.Tensor) -> torch.Tensor:
    """Entropy (bits) from a histogram of outcome counts, as a float32
    0-d tensor on ``counts``' device (the reference's ``where`` guards:
    empty bins add 0, an all-zero histogram gives 0)."""
    counts = torch.as_tensor(counts).to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=counts.device)
    p = counts / torch.maximum(counts.sum(), one)
    pos = p > 0
    return -torch.where(pos, p * torch.log2(torch.where(pos, p, one)),
                        torch.zeros_like(p)).sum()
