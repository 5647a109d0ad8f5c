"""Heterogeneous spot-pool formation (paper §4.3, Algorithm 1).

PyTorch counterpart of ``repro.core.pool``:

- ``greedy_pool``           : faithful line-by-line Algorithm 1 (Python loop)
                              — the oracle.
- ``greedy_pool_vectorized``: the same algorithm over *all* candidate
                              prefixes at once, on a device.  Two
                              interchangeable all-prefix scans, selected by
                              ``pool_impl``:

                              * ``"dense"`` — an O(K^2) matrix of prefix
                                allocations in plain PyTorch (small K);
                              * ``"tiled"`` — the O(K) scan of
                                :mod:`repro_torch.kernels.pool_scan` (the
                                CUDA kernel on the card, its plain version
                                on the CPU);
                              * ``"auto"`` (default) — ``"tiled"`` from
                                ``POOL_TILED_AUTO_K`` candidates up.
- ``greedy_pool_masked``    : the batched engine's form, over a full-width
                              candidate axis with per-request masks.
- ``ilp_pool``              : the §6.3.1 ILP baseline (scipy's ``milp``, on
                              the host, float64), as in the reference.

Every scan runs in float32, as the reference does with x64 off.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..kernels.pool_scan import (INT32_MAX, _clamped_prefix_sums,
                                 _finalize, _first_true, pool_scan)
from .scoring import f32

#: "auto" switches from the dense K x K scan to the O(K) scan at this many
#: candidates (the reference's threshold).
POOL_TILED_AUTO_K = 512

POOL_IMPLS = ("dense", "tiled", "auto")


def resolve_pool_impl(impl: str, k: int) -> str:
    """Resolve the ``pool_impl`` switch for a K-candidate scan."""
    if impl not in POOL_IMPLS:
        raise ValueError(f"pool_impl must be one of {POOL_IMPLS}, got {impl!r}")
    if impl == "auto":
        return "tiled" if k >= POOL_TILED_AUTO_K else "dense"
    return impl


@dataclass
class PoolResult:
    """Allocation result: parallel arrays over the *selected* candidates."""

    indices: np.ndarray       # (M,) indices into the original candidate arrays
    counts: np.ndarray        # (M,) node count per selected type
    scores: np.ndarray        # (M,) combined score S_i of each selected type
    iterations: int = 0       # greedy iterations executed
    solve_time_s: float = 0.0
    extra: dict = field(default_factory=dict)

    @property
    def num_types(self) -> int:
        return int((self.counts > 0).sum())

    def total_cpus(self, cpus: np.ndarray) -> float:
        return float((np.asarray(cpus)[self.indices] * self.counts).sum())

    def total_score(self, scores_all: np.ndarray | None = None) -> float:
        """Sum of S_i over allocated nodes (score-weighted pool quality)."""
        s = self.scores if scores_all is None else np.asarray(scores_all)[self.indices]
        return float((s * self.counts).sum())


# ---------------------------------------------------------------------------
# Algorithm 1 — faithful loop implementation (oracle).
# ---------------------------------------------------------------------------

def greedy_pool(scores, cpus, required: float) -> PoolResult:
    """Greedy heuristic for spot instance pool formation (Algorithm 1)."""
    t0 = time.perf_counter()
    scores = np.asarray(scores, np.float64)
    cpus = np.asarray(cpus, np.float64)
    order = np.argsort(-scores, kind="stable")  # descending, deterministic ties

    pool: list[int] = []
    x_best: dict[int, int] = {}
    x_prev_top = math.inf
    top = int(order[0])
    iters = 0
    for i in order:
        pool.append(int(i))
        iters += 1
        s_total = float(scores[pool].sum())
        if s_total <= 0:
            break
        x_curr = {}
        for j in pool:
            r_j = scores[j] / s_total * required           # score-based allocation
            x_curr[j] = int(math.ceil(r_j / cpus[j]))
        if x_curr[top] >= x_prev_top or x_curr[int(i)] == 0:
            break  # return previous iteration's allocation
        x_best = x_curr
        x_prev_top = x_curr[top]

    if not x_best:  # degenerate: first iteration already terminated
        x_best = {top: int(math.ceil(required / cpus[top]))}
    idx = np.array(sorted(x_best, key=lambda j: -scores[j]), np.int64)
    return PoolResult(
        indices=idx,
        counts=np.array([x_best[int(j)] for j in idx], np.int64),
        scores=scores[idx],
        iterations=iters,
        solve_time_s=time.perf_counter() - t0,
    )


# ---------------------------------------------------------------------------
# Algorithm 1 — all-prefix form on a device (production path).
# ---------------------------------------------------------------------------

def _prefix_allocations(s: torch.Tensor, c: torch.Tensor, required, *,
                        impl: str = "dense"):
    """All-prefix Algorithm 1 over pre-sorted ``(s, c)``, (K,) or (B, K).

    For the score-descending ordering, the allocation matrix of every
    prefix length k is::

        X[k, j] = ceil( S_j * R / (cumsum(S)[k] * CPU_j) )    for j <= k

    and the termination conditions are masks over it.  Returns the
    allocation row of the last prefix before the first terminating prefix,
    the first terminating prefix and whether one terminated.

    ``impl="dense"`` materializes X (O(B K^2) memory, plain PyTorch);
    ``impl="tiled"`` runs :func:`repro_torch.kernels.pool_scan.pool_scan`.
    Both read the prefix sums of one :func:`_clamped_prefix_sums` call and
    give bit-identical output.
    """
    if impl == "tiled":
        return pool_scan(s, c, required)
    single = s.dim() == 1
    s2 = s.reshape(1, -1) if single else s
    B, K = s2.shape
    c2 = c.reshape(B, K)
    R = f32(required, s2.device).reshape(-1).expand(B)[:, None, None]
    s_tot = _clamped_prefix_sums(s2)                             # (B, K)
    raw = s2[:, None, :] * R / (s_tot[:, :, None] * c2[:, None, :])
    X = torch.ceil(raw).to(torch.int32)                          # X[b, k, j]
    tri = torch.ones(K, K, dtype=torch.bool, device=s2.device).tril()
    X = torch.where(tri, X, 0)
    top = X[:, :, 0]                                             # (B, K)
    newest = torch.diagonal(X, dim1=1, dim2=2)
    prev = torch.cat([torch.full_like(top[:, :1], INT32_MAX), top[:, :-1]], 1)
    term = (top >= prev) | (newest == 0)
    term[:, 0] = newest[:, 0] == 0                       # x_prev_top = inf at k=0
    any_term, k_stop = _first_true(term)
    k_best, deg = _finalize(any_term, k_stop, K)
    counts = X[torch.arange(B, device=s2.device), k_best.long()]
    fallback = torch.zeros_like(counts)
    fallback[:, 0] = torch.ceil(R[:, 0, 0] / c2[:, 0]).to(torch.int32)
    counts = torch.where(deg[:, None], fallback, counts)
    out = (counts, k_stop, any_term)
    return tuple(x[0] for x in out) if single else out


def _sort_masked(scores: torch.Tensor, cpus: torch.Tensor, mask: torch.Tensor):
    """Score-descending stable order with masked lanes last: ``(order, s, c)``.

    Masked-out lanes sort after every valid one (key ``+inf``) and carry
    score 0 and capacity 1, so they add nothing to the prefix sums.
    """
    inf = torch.tensor(float("inf"), dtype=scores.dtype, device=scores.device)
    order = torch.sort(torch.where(mask, -scores, inf), dim=-1,
                       stable=True).indices
    mask_sorted = mask.gather(-1, order)
    s = torch.where(mask_sorted, scores.gather(-1, order), 0.0)
    c = torch.where(mask_sorted, cpus.gather(-1, order), 1.0)
    return order, s, c


def greedy_pool_masked(scores, cpus, required, mask, *, impl: str = "dense"):
    """Algorithm 1 over the ``mask`` lanes of a full-width candidate axis.

    ``scores``, ``cpus`` and ``mask`` are (K,) or (B, K) tensors on one
    device, ``required`` a scalar or (B,).  Masked-out candidates sort
    strictly after every valid one and contribute score 0, so the
    ``newest == 0`` condition terminates the scan no later than the first
    masked lane — where the gathered-subset scan runs out of candidates.
    Prefixes over valid lanes equal the gathered scan's bit for bit (zeros
    appended to a cumsum do not perturb earlier partial sums).

    Returns ``(order, counts_sorted, k_stop, any_term)``.  ``impl`` must be
    resolved ("dense" or "tiled", see :func:`resolve_pool_impl`).
    """
    scores = f32(scores)
    cpus = f32(cpus, scores.device)
    mask = torch.as_tensor(mask, device=scores.device).bool()
    order, s, c = _sort_masked(scores, cpus, mask)
    counts, k_stop, any_term = _prefix_allocations(s, c, required, impl=impl)
    return order, counts, k_stop, any_term


def greedy_pool_vectorized(scores, cpus, required: float, *,
                           impl: str = "auto", device=None) -> PoolResult:
    """Algorithm 1 for one request, all prefixes at once on ``device``.

    ``device`` follows the port's policy (CUDA unless ``"cpu"`` is asked
    for).  Pool output equals :func:`greedy_pool`'s.
    """
    t0 = time.perf_counter()
    dev = resolve_device(device)
    scores_t = f32(scores, dev)
    cpus_t = f32(cpus, dev)
    impl = resolve_pool_impl(impl, scores_t.shape[0])
    order = torch.sort(-scores_t, stable=True).indices
    counts, k_stop, _ = _prefix_allocations(
        scores_t[order], cpus_t[order], f32(required, dev), impl=impl)
    order, counts = order.cpu().numpy(), counts.cpu().numpy()
    sel = counts > 0
    idx = order[sel]
    return PoolResult(
        indices=idx.astype(np.int64),
        counts=counts[sel].astype(np.int64),
        scores=scores_t.cpu().numpy()[idx],
        iterations=int(k_stop) + 1,
        solve_time_s=time.perf_counter() - t0,
    )


# ---------------------------------------------------------------------------
# ILP baseline (§6.3.1): max  sum S_i * CPU_i * x_i  +  gamma * sum z_i
#                        s.t. R <= sum CPU_i x_i <= R + slack,
#                             z_i = 1 iff x_i > 0  (linking constraints).
# ---------------------------------------------------------------------------

def ilp_pool(scores, cpus, required: float, *, gamma: float = 1.0,
             slack: float | None = None,
             time_limit: float | None = None) -> PoolResult:
    """The ILP baseline, a copy of the reference's: host numpy and scipy's
    ``milp`` (imported here, so the port imports without scipy)."""
    from scipy.optimize import Bounds, LinearConstraint, milp
    from scipy.sparse import diags as sp_diags
    from scipy.sparse import hstack as sp_hstack
    from scipy.sparse import identity as sp_eye

    t0 = time.perf_counter()
    scores = np.asarray(scores, np.float64)
    cpus = np.asarray(cpus, np.float64)
    K = scores.shape[0]
    if slack is None:
        slack = float(cpus.max())  # tightest always-feasible over-provision bound
    M = np.ceil((required + slack) / cpus)

    # Variables: [x_0..x_{K-1}, z_0..z_{K-1}]
    c = -np.concatenate([scores * cpus, np.full(K, gamma)])
    constraints = [
        # R <= sum CPU_i x_i <= R + slack
        LinearConstraint(np.concatenate([cpus, np.zeros(K)])[None, :],
                         required, required + slack),
        # x_i - M_i z_i <= 0   (x>0 forces z=1)
        LinearConstraint(sp_hstack([sp_eye(K), sp_diags(-M)]), -np.inf, 0),
        # z_i - x_i <= 0       (z=1 requires x>=1; keeps the bonus honest)
        LinearConstraint(sp_hstack([-sp_eye(K), sp_eye(K)]), -np.inf, 0),
    ]
    bounds = Bounds(np.zeros(2 * K), np.concatenate([M, np.ones(K)]))
    options = {} if time_limit is None else {"time_limit": time_limit}
    res = milp(c, constraints=constraints, integrality=np.ones(2 * K),
               bounds=bounds, options=options)
    if res.x is None:
        raise RuntimeError(f"ILP infeasible / failed: {res.message}")
    x = np.round(res.x[:K]).astype(np.int64)
    idx = np.flatnonzero(x > 0)
    idx = idx[np.argsort(-scores[idx], kind="stable")]
    return PoolResult(
        indices=idx,
        counts=x[idx],
        scores=scores[idx],
        solve_time_s=time.perf_counter() - t0,
        extra={"status": res.status, "objective": -float(res.fun)},
    )


# ---------------------------------------------------------------------------
# Decision-margin replay: may two prefix-sum orders honestly disagree?
# ---------------------------------------------------------------------------

F32_EPS = 2.0 ** -24


def prefix_sum_tie(s, c, required: float, csc_a, csc_b, runs):
    """Whether two prefix-sum vectors of the same sorted row may flip a pool.

    ``s``, ``c`` are one request's sorted scores and capacities, ``csc_a``
    and ``csc_b`` two clamped prefix sums of ``s`` taken in other summation
    orders (JAX and PyTorch, or the CPU and the card), ``runs`` the
    ``(k_stop, any_term)`` of the scans being compared.  Algorithm 1 only
    looks at ``ceil`` operands ``s_j R / (csc_k c_j)``: ``top`` and
    ``newest`` of every prefix up to the last one either scan reached (the
    ``top[k] >= top[k-1]`` test changes only where one of them crosses an
    integer), and the count row of each scan's winning prefix.  Prefixes
    whose two sums agree bit for bit give both scans the same operands, so
    only prefixes where they differ are replayed.

    Returns ``(tie, margin, budget)``: ``margin`` is the smallest distance
    of a replayed operand from an integer, relative to the operand;
    ``budget`` the largest relative disagreement of the two sums plus
    8 float32 ulps for the rounding of the operand itself.  A tie is
    ``margin <= budget``.
    """
    s, c, a, b = (np.asarray(x, np.float64) for x in (s, c, csc_a, csc_b))
    K = s.shape[0]
    k_hi = max(k if found else K - 1 for k, found in runs)
    k_bests = {max(k - 1, 0) if found else K - 1 for k, found in runs}
    k = np.arange(k_hi + 1)
    diff = a[k] != b[k]
    budget = float((np.abs(a[k] - b[k]) / np.abs(a[k])).max()) + 8 * F32_EPS
    kd = k[diff]
    ops = [s[0] * required / (a[kd] * c[0]), s[kd] * required / (a[kd] * c[kd])]
    ops += [s[: kb + 1] * required / (a[kb] * c[: kb + 1])
            for kb in k_bests if a[kb] != b[kb]]
    margin = np.inf
    for x in ops:
        x = x[x != 0]            # zero scores give exact zeros: no flip
        if x.size:
            margin = min(margin, float((np.abs(x - np.rint(x)) / np.abs(x)).min()))
    return margin <= budget, margin, budget
