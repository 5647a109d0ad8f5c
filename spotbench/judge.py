"""How ``correct`` is decided: the program's answers held against the plain
reference in float64.

Five numbers, each the widest over the answers a run judges (whole calls
drawn from the seed, ``harness.judged_calls``), each held to the limit
that the configuration file gives it (``limits``; PERF.md gives the
readings each limit was set from):

- ``stats_err``: the program's statistics of the served window against
  the reference's, the widest gap over the K candidates as a share of the
  statistic's range;
- ``score_err``: each returned member's S, AS and CS against the
  reference's, the widest gap in units of 100 points;
- ``rank_gap``: how far below the reference's j-th best score the
  program's j-th member lies in the reference's scores, in units of 100
  points (a member swapped with a near-tie reads the tie's width);
- ``decision_gap``: Algorithm 1 replayed on the program's own members in
  float64: every lane it went on past, the lane it stopped at, and every
  node count it gave (after the ``max_types`` split where that applies).
  Where the reference decides otherwise, the reading is the least relative
  move of a ``ceil`` operand that would make it agree: a decision within
  rounding of an integer is a tie and reads about float32's rounding, a
  wrong one reads far more.  A pool outside the request's filter, a
  repeated member, an iteration count that does not match the pool's
  length or a count of candidates considered other than the filter's
  reads 1;
- ``hourly_err``: the returned hourly cost against ``sum(price * count)``
  of the returned pool, relative.

The judge also counts the pools that are not bit for bit the reference's
own answer (near-ties), which is reported and not held to a limit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import reference as ref

NUMBERS = ("stats_err", "score_err", "rank_gap", "decision_gap",
           "hourly_err")
STRUCTURAL = 1.0          # the reading of a pool that is malformed
FILTER_COLUMNS = ("regions", "azs", "categories", "families")


def filter_key(req: dict) -> tuple:
    """A request's filters: the values it allows in each filtered column."""
    return tuple(tuple(req.get(c) or ()) for c in FILTER_COLUMNS)


def verdict(attempted: int, answered: int, checks: dict,
            limits: dict) -> bool:
    """``correct``: every request answered and every number within its
    limit.  The program's answers and the control's go through this one
    rule."""
    return (attempted > 0 and attempted == answered
            and all(checks[n] <= limits[n] for n in NUMBERS))


def stats_err(prog: np.ndarray, want: torch.Tensor) -> float:
    """The widest gap of (3, K) statistics, as a share of each one's range."""
    want = want.cpu().numpy()
    worst = 0.0
    for p, w in zip(np.asarray(prog, np.float64), want):
        span = float(w.max() - w.min())
        worst = max(worst, float(np.abs(p - w).max()) / span)
    return worst


def _outside(x: float, n: int) -> float:
    """The relative move that puts ``x`` into ``(n - 1, n]``, where
    ``ceil(x) == n``."""
    if x > n:
        return (x - n) / x
    if x <= n - 1:
        return ((n - 1) - x) / x if x > 0 else STRUCTURAL
    return 0.0


def _goes_on(a: float, b: float) -> float:
    """Lane k went on: ``ceil(a) < ceil(b)`` for the leader's operands at
    lanes k and k - 1.  The least relative move that makes it so."""
    na, nb = math.ceil(a), math.ceil(b)
    if na < nb:
        return 0.0
    return min((a - (nb - 1)) / a, (na - b) / b)


def _stops(a: float, b: float) -> float:
    """The scan stopped at lane k: ``ceil(a) >= ceil(b)``.  The least
    relative move that makes it so."""
    na, nb = math.ceil(a), math.ceil(b)
    if na >= nb:
        return 0.0
    return min(((nb - 1) - a) / a, (b - na) / b)


class Judge:
    """The reference's side of the comparison on ``device``: the catalog in
    float64, the request filters' masks (kept by filter) and the readings
    of one answer at a time."""

    def __init__(self, cat, device, dtype=torch.float64):
        self.cat = cat
        self.device = device
        self.dtype = dtype
        on = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
        self.prices = on(cat.prices)
        self.vcpus = on(cat.vcpus)
        self.memory_gb = on(cat.memory_gb)
        self._masks: dict = {}

    def mask(self, req: dict) -> torch.Tensor:
        key = filter_key(req)
        m = self._masks.get(key)
        if m is None:
            host = np.ones(len(self.cat), bool)
            for col, values in zip(FILTER_COLUMNS, key):
                if values:
                    host &= np.isin(getattr(self.cat, col), values)
            m = self._masks[key] = torch.as_tensor(host, device=self.device)
        return m

    def scores(self, stats: torch.Tensor, req: dict):
        """(mask, capacity, S, AS, CS) of a request on these statistics."""
        mask = self.mask(req)
        cap = ref.capacity(req, self.vcpus, self.memory_gb)
        return (mask, cap, *ref.scores(stats.to(self.dtype), self.prices,
                                       cap, mask, req))

    def answer(self, stats: torch.Tensor, req: dict) -> ref.Answer:
        """The reference's own answer, in this judge's dtype."""
        mask, cap, comb, avail, cost = self.scores(stats, req)
        return ref.pool(comb, avail, cost, self.prices, cap, mask, req)

    def readings(self, stats: torch.Tensor, req: dict, got: ref.Answer):
        """``(readings, own)``: the four per-answer numbers of ``got``, and
        the reference's own answer (its pool and the lanes it scanned)."""
        mask, cap, comb, avail, cost = self.scores(stats, req)
        own = ref.pool(comb, avail, cost, self.prices, cap, mask, req)
        out = dict(score_err=0.0, rank_gap=0.0, decision_gap=0.0,
                   hourly_err=0.0)
        rows = np.asarray(got.rows, np.int64)
        m = rows.shape[0]
        N = own.considered
        lanes = torch.as_tensor(rows, device=self.device)
        if (m == 0 or got.considered != N or len(set(rows.tolist())) != m
                or rows.min() < 0 or rows.max() >= len(self.cat)
                or not bool(mask[lanes].all())):
            out["decision_gap"] = STRUCTURAL
            return out, own
        host = lambda x: x.cpu().to(torch.float64).numpy()  # noqa: E731
        s_got, a_got, c_got = (host(x[lanes]) for x in (comb, avail, cost))
        out["score_err"] = max(
            float(np.abs(np.asarray(v, np.float64) - w).max())
            for v, w in ((got.combined, s_got), (got.availability, a_got),
                         (got.cost, c_got))) / ref.SCORE_SCALE
        mt = req.get("max_types")
        L = self._length(got, m, N, mt)
        if L is None:
            out["decision_gap"] = STRUCTURAL
            return out, own
        top_lanes, top_vals = ref.best(comb, mask, min(N, L + 1 + m))
        out["rank_gap"] = float(np.abs(host(top_vals[:m]) - s_got).max()
                                ) / ref.SCORE_SCALE
        # the members' sequence: the program's own, then (where the
        # max_types cap hid the rest of its scan) the reference's order
        seq = rows.tolist()
        seen = set(seq)
        for lane in top_lanes.tolist():
            if len(seq) >= min(N, L + 1):
                break
            if lane not in seen:
                seq.append(lane)
                seen.add(lane)
        seq_t = torch.as_tensor(seq, device=self.device)
        s = host(comb[seq_t])
        c = host(cap[seq_t])
        R = ref.amount(req)
        csum = np.cumsum(s)
        csum = np.where(csum > 0, csum, 1.0)
        x0 = s[0] * R / (csum * c[0])
        gaps = [0.0]
        if L == 0:
            gaps.append(0.0 if s[0] == 0 else STRUCTURAL)
        else:
            if s[0] <= 0:
                gaps.append(STRUCTURAL)
            for k in range(1, L):
                gaps.append(_goes_on(x0[k], x0[k - 1]) if s[k] > 0
                            else STRUCTURAL)
            if L < N and s[L] > 0:
                gaps.append(_stops(x0[L], x0[L - 1]))
        counts = np.asarray(got.counts, np.int64)
        if mt is not None and L > mt:
            share = s[:m] / s[:m].sum() * R if s[:m].sum() > 0 \
                else np.full(m, R / m)
            want = share / c[:m]
        elif L == 0:
            want = np.array([R / c[0]])
        else:
            want = s[:L] * R / (csum[L - 1] * c[:L])
        gaps += [_outside(float(x), int(n)) for x, n in zip(want, counts)]
        out["decision_gap"] = max(gaps)
        hourly = float((self.cat.prices[rows] * counts).sum())
        out["hourly_err"] = abs(got.hourly_cost - hourly) / hourly
        return out, own

    @staticmethod
    def _length(got: ref.Answer, m: int, N: int, mt) -> int | None:
        """The length of the pool the program's scan chose, before any
        ``max_types`` cap, from its iteration count; ``None`` where that
        does not agree with the members returned."""
        g = got.iterations
        if g >= 2:
            L = g - 1
        elif m == min(N, mt or N) and N > 1 or N == 1:
            L = N                     # the scan never stopped
        else:
            L = 0                     # stopped at the leader
        shown = 1 if L == 0 else (min(L, mt) if mt is not None else L)
        if m != shown or len(got.counts) != m or L > N:
            return None
        return L


def same_pool(a: ref.Answer, b: ref.Answer) -> bool:
    """Bit for bit the same pool, iterations and hourly cost."""
    return (np.array_equal(a.rows, b.rows)
            and np.array_equal(a.counts, b.counts)
            and a.iterations == b.iterations
            and a.considered == b.considered
            and a.hourly_cost == b.hourly_cost)
