"""Device policy shared by the port's entry points.

Entry points (engine, server, archive staging, ``convert``) run on CUDA
unless the caller asks for the CPU with ``device="cpu"``.  There is no
silent fallback: asking for CUDA on a machine without it raises, so a run
that was meant for the card can never quietly measure the CPU instead.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``None`` means CUDA.  A CUDA device (by default or by name) raises
    ``RuntimeError`` when ``torch.cuda.is_available()`` is false.
    ``"meta"`` (shapes and dtypes, no storage: the launch cells' dry-run)
    is taken only when the caller names it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}: use 'cuda', 'cpu' or "
                         "'meta'")
    return dev
