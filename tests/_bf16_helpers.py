"""bf16 closeness for the port's LM tests: how far two results lie apart
in units of the bf16 spacing (8 significant bits) at their magnitude."""
import numpy as np


def as_f64(a) -> np.ndarray:
    """A torch tensor, jax or numpy array as a float64 numpy array."""
    if hasattr(a, "detach"):
        a = a.detach().float().cpu().numpy()
    return np.asarray(np.asarray(a, dtype=np.float32), dtype=np.float64)


def beyond_one_ulp(got, want) -> tuple[np.ndarray, np.ndarray]:
    """(|got - want|, mask of elements farther apart than one bf16 ulp of
    the larger magnitude)."""
    got, want = as_f64(got), as_f64(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                     np.finfo(np.float32).tiny)
    d = np.abs(got - want)
    return d, d > np.exp2(np.floor(np.log2(mag)) - 7)


def assert_within_ulp(got, want, rel: float = 1e-3) -> int:
    """Every element within one bf16 ulp, or within ``rel * max|want|``.
    Returns the count beyond one ulp."""
    d, far = beyond_one_ulp(got, want)
    bad = far & (d > rel * np.abs(as_f64(want)).max())
    assert not bad.any(), (f"{int(bad.sum())} of {bad.size} elements beyond "
                           f"one bf16 ulp; max diff {d.max()}")
    return int(far.sum())
