"""SPL002-clean counterpart: the dtype is pinned, by ``dtype=``, by an
immediate cast, or by the numpy array wrapped.  Expected: zero
findings."""
import numpy as np
import torch


def staged_column(xs, device):
    a = torch.as_tensor(np.asarray(xs), dtype=torch.float32, device=device)
    b = torch.from_numpy(np.asarray(xs)).float()
    c = torch.from_numpy(np.asarray(xs, np.float32))
    d = torch.tensor([True], device=device).to(dtype=torch.bool)
    return a * 2.0, b, c, d
