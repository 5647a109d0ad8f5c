"""SpotVista scoring: availability score (Eq. 3), cost score (Eq. 2), combined (Eq. 4).

PyTorch counterpart of ``repro.core.scoring``.  Plain tensor code on
whatever device its inputs live on: none of it sits inside a Pallas kernel
in the reference, so none of it is a hand-written kernel here.

Inputs
------
t3 : (K, T) tensor — per-candidate T3 time-series over the observation window
     (T3 = largest node count whose SPS is 3).
prices, cpus : (K,) tensors — catalog attributes.

All component normalisations (A3 magnitude, slope m, volatility sigma) are
MinMax across the candidate set, per §4.2.  Everything is pinned to float32,
as the reference is with x64 off; float64 inputs are cast down.

Division rule: a divisor is always a tensor.  ``python_float / tensor``
lowers to ``tensor.reciprocal() * python_float`` in PyTorch, and a
reciprocal flips ``ceil`` at exact multiples — so scalars are lifted to
tensors before they divide.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DEFAULT_LAMBDA = 0.1
DEFAULT_WEIGHT = 0.5

#: "auto" switches the batched engine from the dense scoring stage (full
#: Eq. 3 over the (K, T) window every batch) to the fused masked kernel
#: (``repro_torch.kernels.score_fuse``) over archive-cached statistics at
#: this many candidates — the reference's threshold, kept so both packages
#: take the same lane at the same K.
SCORE_TILED_AUTO_K = 4096

SCORE_IMPLS = ("dense", "tiled", "auto")


def resolve_score_impl(impl: str, k: int) -> str:
    """Resolve the ``score_impl`` switch for a K-candidate scoring stage."""
    if impl not in SCORE_IMPLS:
        raise ValueError(f"score_impl must be one of {SCORE_IMPLS}, got {impl!r}")
    if impl == "auto":
        return "tiled" if k >= SCORE_TILED_AUTO_K else "dense"
    return impl


def f32(x, device: torch.device | None = None) -> torch.Tensor:
    """``x`` as a float32 tensor (on ``device``, else where it already is).

    Host data (numpy arrays, scalars, lists) is copied once into a fresh
    float32 array, rounded to nearest as numpy and JAX round it.
    """
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32)


class AvailabilityComponents(NamedTuple):
    """Intermediate quantities of Eq. 3 (useful for tests / benchmarks)."""

    a3: torch.Tensor      # (K,) normalised magnitude (area under T3 curve)
    slope: torch.Tensor   # (K,) normalised trend m_i
    sigma: torch.Tensor   # (K,) normalised volatility sigma_i
    score: torch.Tensor   # (K,) AS_i in [0, 110] (bounded by 100*(1+lambda))


class CandidateStats(NamedTuple):
    """Request-independent per-candidate raw statistics of the T3 archive.

    The O(K*T) reductions of Eq. 3 before any per-request MinMax
    normalisation.  The serve layer computes them once per staged archive
    (``DeviceArchive.score_stats``); the per-request O(K) remainder of
    Eq. 2-4 lives in ``repro_torch.kernels.score_fuse``.
    """

    area: torch.Tensor   # (K,) raw trapezoid area under the T3 curve
    slope: torch.Tensor  # (K,) raw least-squares slope m_i
    std: torch.Tensor    # (K,) raw standard deviation sigma_i


def _minmax_from(x: torch.Tensor, lo, hi) -> torch.Tensor:
    rng = hi - lo
    pos = rng > 0
    return torch.where(pos, (x - lo) / torch.where(pos, rng, 1.0),
                       torch.zeros_like(x))


def _safe_minmax(x: torch.Tensor) -> torch.Tensor:
    """MinMax over the candidate axis; constant vectors map to zeros."""
    return _minmax_from(x, x.amin(-1, keepdim=True), x.amax(-1, keepdim=True))


def _masked_minmax(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MinMax where lo/hi are taken over ``mask`` lanes only.

    ``mask`` may carry leading batch axes; ``x`` broadcasts against it.
    Masked-out lanes get a (finite, garbage) value the batched path
    discards.  On valid lanes the result equals ``_safe_minmax`` over the
    gathered subset bit for bit: min/max are exact and the rest is
    elementwise.
    """
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    lo = torch.where(mask, x, inf).amin(-1, keepdim=True)
    hi = torch.where(mask, x, -inf).amax(-1, keepdim=True)
    return _minmax_from(x, lo, hi)


def _regression_slopes(t3: torch.Tensor) -> torch.Tensor:
    """Closed-form least-squares slope of each row against uniform time."""
    T = t3.shape[-1]
    t = torch.arange(T, dtype=t3.dtype, device=t3.device)
    t_c = t - t.mean()
    denom = (t_c * t_c).sum()
    # T == 1: the centered grid is identically zero, so both the numerator
    # and sum(t_c^2) vanish — the slope is 0 by convention, not 0/0 = NaN.
    denom = torch.where(denom > 0, denom, 1.0)
    y_c = t3 - t3.mean(-1, keepdim=True)
    # explicit multiply + last-axis sum, not ``@`` (the reference's
    # row-sliceability contract: a matvec may tile the row axis)
    return (y_c * t_c).sum(-1) / denom


def candidate_stats(t3) -> CandidateStats:
    """The O(K*T) pass of Eq. 3: raw area / slope / std per candidate.

    Every reduction is an elementwise multiply plus a last-axis sum (or
    ``std``), never a matrix-vector product, as in the reference.  The bits
    differ from JAX's (another summation order); the cross-package tests
    hold them at a relative tolerance and feed both packages the same
    statistics where the point is what comes after.
    """
    t3 = f32(t3)
    w = torch.ones(t3.shape[-1], dtype=torch.float32, device=t3.device)
    w[0] = 0.5
    w[-1] = 0.5
    area = (t3 * w).sum(-1)
    return CandidateStats(area, _regression_slopes(t3),
                          t3.std(-1, correction=0))


def stats_from_moments(s0, s1, q, y_first, y_last, length,
                       ref=0.0) -> CandidateStats:
    """:class:`CandidateStats` from streaming moments of a window.

    ``s0 = sum(y)``, ``s1 = sum(i * y)`` (``i`` the position inside the
    window, oldest first), ``q = sum((y - ref)^2)`` over the current
    ``length``-sample window whose first/last columns are ``y_first`` /
    ``y_last``; ``ref`` the per-candidate frozen centring point of ``q``.
    The O(K) tail of the live-ingest update (``kernels.stats_update``):

    - area : ``s0 - (y_first + y_last) / 2``, or ``s0 / 2`` when T == 1;
    - slope: ``(s1 - (T - 1) / 2 * s0) / (T (T^2 - 1) / 12)``, 0-guarded;
    - std  : ``sqrt(max(q / T - (s0 / T - ref)^2, 0))``.

    The reference's op order, one correctly rounded float32 result per op.
    Every divisor is a float32 tensor on the operands' device (a CUDA
    division by a Python scalar multiplies by its reciprocal), so the CUDA
    kernel B3, built with ``--fmad=false``, gives the same bits on the card
    and on the CPU.
    """
    dev = s0.device
    T = f32(length, dev)
    two, twelve = f32(2.0, dev), f32(12.0, dev)
    area = torch.where(T > 1, s0 - 0.5 * (y_first + y_last), 0.5 * s0)
    denom = T * (T * T - 1.0) / twelve
    slope = (s1 - (T - 1.0) / two * s0) / torch.where(denom > 0, denom, 1.0)
    d = s0 / T - ref
    var = torch.clamp(q / T - d * d, min=0.0)
    # PyTorch's vectorized float32 sqrt on the CPU is not always correctly
    # rounded; the float64 root rounded to float32 is, as IEEE sqrtf is.
    std = torch.sqrt(var.double()).float()
    return CandidateStats(area, slope, std)


def _availability(stats: CandidateStats, lam, norm) -> AvailabilityComponents:
    a3, slope, sigma = (norm(x) for x in stats)
    score = torch.clamp(100.0 * a3 * (1.0 + lam * (slope - sigma)), min=0.0)
    return AvailabilityComponents(a3, slope, sigma, score)


def availability_scores(t3, lam=DEFAULT_LAMBDA, *,
                        return_components: bool = False):
    """Eq. 3: AS_i = 100 * A3_i * (1 + lam * (m_i - sigma_i)).

    - A3_i   : area under the T3 curve (trapezoid), MinMax across candidates.
    - m_i    : first-order linear-regression slope, MinMax across candidates.
    - sigma_i: standard deviation of T3_i, MinMax across candidates.
    """
    comp = _availability(candidate_stats(t3), lam, _safe_minmax)
    return comp if return_components else comp.score


def cost_scores(prices, cpus, required_cpus) -> torch.Tensor:
    """Eq. 2: CS_i = 100 * C_min / C_i with C_i = p_i * ceil(R_C / CPU_i).

    Inverse min-scaling — deliberately *not* MinMax — so the score is
    independent of the shape of the cost distribution (§4.1).
    """
    total = pool_costs(prices, cpus, required_cpus)
    return 100.0 * total.amin() / total


def pool_costs(prices, cpus, required_cpus) -> torch.Tensor:
    """Total cost C_i = p_i * ceil(R / CPU_i) for every candidate (helper)."""
    prices = f32(prices)
    cpus = f32(cpus, prices.device)
    return prices * torch.ceil(f32(required_cpus, prices.device) / cpus)


def combined_scores(avail, cost, weight=DEFAULT_WEIGHT) -> torch.Tensor:
    """Eq. 4: S_i = W * AS_i + (1 - W) * CS_i."""
    return weight * avail + (1.0 - weight) * cost


# ---------------------------------------------------------------------------
# Masked variants — the batched serving path.  The candidate axis keeps its
# full width and each request's filter is a boolean mask threaded through
# every cross-candidate reduction; on valid lanes the outputs equal the
# gathered versions bit for bit.
# ---------------------------------------------------------------------------

def masked_availability(stats: CandidateStats, lam, mask) -> torch.Tensor:
    """Eq. 3 from precomputed statistics, MinMax over ``mask`` lanes.

    ``mask`` is (K,) or (B, K); ``lam`` a scalar or (B, 1).
    """
    return _availability(stats, lam, lambda x: _masked_minmax(x, mask)).score


def availability_scores_masked(t3, lam, mask) -> torch.Tensor:
    """Eq. 3 with MinMax normalisations restricted to ``mask`` lanes."""
    return masked_availability(candidate_stats(t3), lam, mask)


def cost_scores_masked(prices, cpus, required, mask) -> torch.Tensor:
    """Eq. 2 with C_min taken over ``mask`` lanes only.

    ``cpus`` and ``mask`` are (K,) or (B, K); ``required`` a scalar or (B, 1).
    """
    total = pool_costs(prices, cpus, required)
    inf = torch.tensor(float("inf"), dtype=total.dtype, device=total.device)
    c_min = torch.where(mask, total, inf).amin(-1, keepdim=True)
    return 100.0 * c_min / total


# ---------------------------------------------------------------------------
# NumPy reference oracle (float64).
# ---------------------------------------------------------------------------

def availability_scores_ref(t3: np.ndarray, lam: float = DEFAULT_LAMBDA) -> np.ndarray:
    t3 = np.asarray(t3, np.float64)

    def mm(x):
        rng = x.max() - x.min()
        return (x - x.min()) / rng if rng > 0 else np.zeros_like(x)

    area = np.trapezoid(t3, axis=-1) if hasattr(np, "trapezoid") else np.trapz(t3, axis=-1)
    a3 = mm(area)
    T = t3.shape[-1]
    t = np.arange(T) - (T - 1) / 2.0
    denom = t @ t if T > 1 else 1.0    # T == 1: slope is 0, not 0/0
    slope = mm((t3 - t3.mean(-1, keepdims=True)) @ t / denom)
    sigma = mm(t3.std(-1))
    return np.maximum(100.0 * a3 * (1.0 + lam * (slope - sigma)), 0.0)


def cost_scores_ref(prices: np.ndarray, cpus: np.ndarray, required: float) -> np.ndarray:
    total = np.asarray(prices, np.float64) * np.ceil(required / np.asarray(cpus, np.float64))
    return 100.0 * total.min() / total
