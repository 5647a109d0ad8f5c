"""MSTL-style multi-seasonal decomposition + stability statistics (paper §6.2).

Implements the analysis pipeline behind Table 1:

- ``mstl_decompose``     : iterative seasonal-trend decomposition for multiple
                           periods (daily=24, weekly=168 on hourly data) — a
                           moving-average "lite" variant of Bandara et al.'s
                           MSTL (loess replaced by MA smoothing; adequate for
                           variance bookkeeping on simulated series).
- ``seasonal_strength``  : F_S = max(0, 1 - Var(R) / Var(S + R))  (Wang et al.).
- ``bai_perron``         : dynamic-programming structural-break detection on a
                           seasonal-amplitude series with a BIC model-selection
                           penalty (piecewise-constant means), reporting break
                           count and max relative amplitude variation.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _centered_ma(x: np.ndarray, window: int) -> np.ndarray:
    """Centered moving average with edge padding (even windows use 2x2 MA)."""
    if window <= 1:
        return x.copy()
    if window % 2 == 0:
        # classic 2xMA for even windows
        first = _centered_ma(x, window + 1)
        return first
    pad = window // 2
    xp = np.pad(x, pad, mode="edge")
    kern = np.ones(window) / window
    return np.convolve(xp, kern, mode="valid")


@dataclass
class MSTLResult:
    trend: np.ndarray
    seasonal: dict[int, np.ndarray]   # period -> component
    residual: np.ndarray

    def variance_decomposition(self) -> dict[str, float]:
        out = {f"seasonal_{p}": float(np.var(s)) for p, s in self.seasonal.items()}
        out["trend"] = float(np.var(self.trend))
        out["residual"] = float(np.var(self.residual))
        return out


def mstl_decompose(series, periods=(24, 168), iterations: int = 2) -> MSTLResult:
    x = np.asarray(series, np.float64)
    n = len(x)
    periods = [p for p in sorted(periods) if 2 * p <= n]
    seasonal = {p: np.zeros(n) for p in periods}
    deseason = x.copy()
    for _ in range(iterations):
        for p in periods:
            work = deseason + seasonal[p]          # re-attach own component
            detrended = work - _centered_ma(work, p)
            # per-phase means, centred
            phases = np.arange(n) % p
            means = np.array([detrended[phases == k].mean() for k in range(p)])
            means -= means.mean()
            comp = means[phases]
            seasonal[p] = comp
            deseason = work - comp
    trend = _centered_ma(deseason, max(periods) if periods else max(2, n // 4))
    residual = deseason - trend
    return MSTLResult(trend=trend, seasonal=seasonal, residual=residual)


def seasonal_strength(seasonal: np.ndarray, residual: np.ndarray) -> float:
    """F_S in [0, 1]: how strongly the periodic component dominates the noise."""
    denom = np.var(seasonal + residual)
    if denom <= 0:
        return 0.0
    return float(max(0.0, 1.0 - np.var(residual) / denom))


@dataclass
class BaiPerronResult:
    n_breaks: int
    breakpoints: list[int]
    segment_means: list[float]
    max_variation: float      # max |segment mean - overall mean| / overall mean


def bai_perron(amplitudes, max_breaks: int = 5, min_segment: int = 3) -> BaiPerronResult:
    """Piecewise-constant structural-break fit, BIC-selected break count."""
    y = np.asarray(amplitudes, np.float64)
    n = len(y)
    if n < 2 * min_segment:
        mu = float(y.mean()) if n else 0.0
        return BaiPerronResult(0, [], [mu], 0.0)

    # Precompute segment SSEs: sse[i][j] for segment y[i:j+1].
    cs, cs2 = np.concatenate([[0.0], y.cumsum()]), np.concatenate([[0.0], (y ** 2).cumsum()])

    def sse(i, j):  # inclusive
        m = j - i + 1
        s = cs[j + 1] - cs[i]
        return (cs2[j + 1] - cs2[i]) - s * s / m

    max_breaks = min(max_breaks, n // min_segment - 1)
    # DP: cost[k][j] = min SSE of fitting y[0..j] with k breaks.
    INF = float("inf")
    cost = [[INF] * n for _ in range(max_breaks + 1)]
    back = [[-1] * n for _ in range(max_breaks + 1)]
    for j in range(n):
        if j + 1 >= min_segment:
            cost[0][j] = sse(0, j)
    for k in range(1, max_breaks + 1):
        for j in range(n):
            if j + 1 < (k + 1) * min_segment:
                continue
            for b in range(k * min_segment - 1, j - min_segment + 1):
                c = cost[k - 1][b] + sse(b + 1, j)
                if c < cost[k][j]:
                    cost[k][j] = c
                    back[k][j] = b
    # BIC model selection over k.
    best_k, best_bic = 0, INF
    for k in range(max_breaks + 1):
        rss = max(cost[k][n - 1], 1e-12)
        bic = n * np.log(rss / n) + (2 * k + 1) * np.log(n)
        if bic < best_bic:
            best_bic, best_k = bic, k
    # Recover breakpoints.
    bps: list[int] = []
    k, j = best_k, n - 1
    while k > 0:
        b = back[k][j]
        bps.append(b + 1)       # first index of the new segment
        j, k = b, k - 1
    bps.reverse()
    bounds = [0] + bps + [n]
    seg_means = [float(y[bounds[i]:bounds[i + 1]].mean()) for i in range(len(bounds) - 1)]
    overall = float(y.mean())
    max_var = max((abs(m - overall) / abs(overall) if overall else 0.0) for m in seg_means)
    return BaiPerronResult(best_k, bps, seg_means, float(max_var))
