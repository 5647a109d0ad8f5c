"""SPL005-clean counterpart: the decision stays on the device; branches
read host metadata or a None identity only. Expected: zero findings."""
import torch


def masked_min(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if x.dim() != 1 or x.shape[0] == 0 or x.dtype != torch.float32:
        raise ValueError("x must be a non-empty float32 vector")
    if mask is None:
        return x.min()
    return torch.where(mask, x, x.new_full((), float("inf"))).min()
