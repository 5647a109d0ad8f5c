"""The plain reference: SpotVista's statistics, Eq. 2-4, Algorithm 1 and the
results tail, written from the paper's definitions in plain PyTorch.

It imports nothing of the program.  The benchmark runs it in float64 to
judge the program's answers (``judge``), and in bfloat16, put in the
program's place, as the control that the comparison has to fail
(``control.py``).  Every function takes the dtype it computes in; inputs
are cast to it first.

What each step computes (masked lanes are the request's filter):

- statistics of a T3 row: the trapezoid area, the least-squares slope
  against uniform time and the population standard deviation;
- Eq. 3: ``AS = max(0, 100 A3 (1 + lam (m - sigma)))`` with A3, m and sigma
  each MinMax-normalised over the masked lanes (a constant one is 0);
- Eq. 2: ``CS = 100 C_min / C`` with ``C = price * ceil(R / capacity)`` and
  C_min over the masked lanes;
- Eq. 4: ``S = W AS + (1 - W) CS``;
- Algorithm 1 over the masked lanes in descending S: prefix k allocates
  ``ceil(s_j R / (sum_{i<=k} s_i c_j))`` nodes to each member j; the scan
  stops at the first k whose leader's count does not fall (k >= 1) or
  whose newest member gets 0 nodes, and returns prefix k - 1 (the leader
  alone with ``ceil(R / c_0)`` when k = 0, every lane when it never
  stops);
- the tail: ``max_types`` keeps the first members and splits R over them
  in proportion to S; the hourly cost is ``sum(price * count)`` in float64;
  ``greedy_iterations`` is the stopping lane + 1 (1 when the scan never
  stops); ``candidates_considered`` the masked lanes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

SCORE_SCALE = 100.0      # scores lie in [0, 110]


def window_stats(t3: torch.Tensor, dtype) -> torch.Tensor:
    """(3, R) area, slope and std of each row of an (R, T) window."""
    x = t3.to(dtype)
    T = x.shape[1]
    area = x.sum(1) - 0.5 * (x[:, 0] + x[:, -1])
    t = torch.arange(T, dtype=dtype, device=x.device) - (T - 1) / 2.0
    denom = (t * t).sum()
    slope = ((x - x.mean(1, keepdim=True)) * t).sum(1) / denom
    std = x.std(1, correction=0)
    return torch.stack((area, slope, std))


def stats_in_blocks(rows, K: int, dtype, block: int = 65536) -> torch.Tensor:
    """(3, K) statistics of a window given as ``rows(a, b)`` -> its rows
    [a, b) on the device, taken ``block`` rows at a time so that a float64
    copy of a block is all that is held besides the window."""
    parts = [window_stats(rows(a, min(a + block, K)), dtype)
             for a in range(0, K, block)]
    return torch.cat(parts, 1)


def _minmax(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    lo = torch.where(mask, x, inf).min()
    hi = torch.where(mask, x, -inf).max()
    span = hi - lo
    if not span > 0:
        return torch.zeros_like(x)
    return (x - lo) / span


def capacity(req: dict, vcpus: torch.Tensor,
             memory_gb: torch.Tensor) -> torch.Tensor:
    return vcpus if "cpus" in req else memory_gb


def amount(req: dict) -> float:
    return req["cpus"] if "cpus" in req else req["memory_gb"]


def scores(stats: torch.Tensor, prices: torch.Tensor, cap: torch.Tensor,
           mask: torch.Tensor, req: dict):
    """(S, AS, CS), each (K,), in the dtype of ``stats``; lanes outside
    ``mask`` hold values that nothing reads."""
    a3, m, sigma = (_minmax(x, mask) for x in stats)
    avail = torch.clamp(100.0 * a3 * (1.0 + req["lam"] * (m - sigma)),
                        min=0.0)
    total = prices * torch.ceil(amount(req) / cap)
    inf = torch.tensor(float("inf"), dtype=total.dtype, device=total.device)
    cost = 100.0 * torch.where(mask, total, inf).min() / total
    w = req["weight"]
    return w * avail + (1.0 - w) * cost, avail, cost


def best(comb: torch.Tensor, mask: torch.Tensor, n: int):
    """The ``n`` best masked lanes in descending S: ``(lanes, values)``."""
    n = min(n, int(mask.sum()))
    key = torch.where(mask, comb, torch.tensor(float("-inf"),
                                               dtype=comb.dtype,
                                               device=comb.device))
    v, i = torch.topk(key, n)
    return i, v


def scan(s: torch.Tensor, c: torch.Tensor, R: float):
    """Algorithm 1's stopping lane over a sorted prefix ``(s, c)``:
    ``(k_stop, found)``; ``found`` is False when no lane of the prefix
    stops it."""
    csum = torch.cumsum(s, 0)
    csum = torch.where(csum > 0, csum, torch.ones_like(csum))
    top = torch.ceil(s[0] * R / (csum * c[0]))
    newest = torch.ceil(s * R / (csum * c))
    term = newest == 0
    term[1:] |= top[1:] >= top[:-1]
    hit = torch.nonzero(term)
    if hit.numel() == 0:
        return s.shape[0], False
    return int(hit[0, 0]), True


@dataclass
class Answer:
    """One request's pool, as the results tail returns it."""

    rows: np.ndarray          # members' catalog rows, in pool order
    counts: np.ndarray        # node counts
    combined: np.ndarray      # S, AS, CS of each member
    availability: np.ndarray
    cost: np.ndarray
    hourly_cost: float
    iterations: int
    considered: int
    k_stop: int = -1          # the lane the scan stopped at (the lanes
    found: bool = False       # it scanned, less one), and whether it did


def pool(comb, avail, cost, prices, cap, mask, req: dict, *,
         prefix: int = 64) -> Answer:
    """Algorithm 1 and the results tail for one request, in the dtype of
    ``comb``; the sorted prefix grows until the scan stops in it."""
    N = int(mask.sum())
    R = amount(req)
    while True:
        lanes, s = best(comb, mask, prefix)
        c = cap[lanes]
        k, found = scan(s, c, R)
        if found or lanes.shape[0] == N:
            break
        prefix *= 4
    if found and k == 0:
        keep = lanes[:1]
        counts = torch.ceil(R / c[:1])
    else:
        L = k if found else N
        csum = torch.cumsum(s[:L], 0)
        counts = torch.ceil(s[:L] * R / (csum[L - 1] * c[:L]))
        keep = lanes[:L]
    mt = req.get("max_types")
    if mt is not None and keep.shape[0] > mt:
        keep = keep[:mt]
        sk = comb[keep]
        total = sk.sum()
        share = (sk / total * R if total > 0
                 else torch.full_like(sk, R / mt))
        counts = torch.ceil(share / cap[keep])
    host = lambda x: x[keep].cpu().to(torch.float64).numpy()  # noqa: E731
    n = counts.cpu().to(torch.float64).numpy().astype(np.int64)
    return Answer(
        rows=keep.cpu().numpy().astype(np.int64), counts=n,
        combined=host(comb), availability=host(avail), cost=host(cost),
        hourly_cost=float((host(prices) * n).sum()),
        iterations=k + 1 if found else 1, considered=N,
        k_stop=k, found=found)
