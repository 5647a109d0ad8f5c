"""Deliberate SPL005 violation: a Python branch on a device tensor — the
host waits for the card at every call. Expected: exactly one SPL005
finding (the ``mask`` branch test)."""
import torch


def masked_min(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    if x.dim() != 1:
        raise ValueError("x must be 1-D")
    if mask.any():
        return x[mask].min()
    return x.new_full((), float("inf"))
