"""Recommendation engine facade (paper §4 + Fig. 3's serverless handler path).

PyTorch counterpart of ``repro.core.engine``.  Given a
:class:`ResourceRequest` and a :class:`CandidateSet`, the engine

1. applies the user's filters (region / AZ / family / category / type),
2. computes availability (Eq. 3) + cost (Eq. 2) + combined (Eq. 4) scores,
3. forms the heterogeneous pool with the greedy heuristic (Algorithm 1).

Two entry points:

- :meth:`RecommendationEngine.recommend` — one request at a time on the
  gathered filtered subset.
- :meth:`RecommendationEngine.recommend_batch` — B requests over the full
  candidate axis with per-request masks: the fused scoring stage
  (``kernels.score_fuse``), a stable sort and the all-prefix Algorithm 1
  scan (``kernels.pool_scan``), the batch axis written out in every stage.

The engine runs on ``device``: CUDA unless ``device="cpu"`` is asked for.
On the card the tiled stages launch the hand-written kernels; on the CPU
they run the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from .._device import resolve_device
from ..kernels import score_fuse as score_fuse_lib
from . import pool as pool_lib
from . import scoring
from .config import EngineConfig, resolve_engine_config
from .scoring import f32
from .types import CandidateSet, Recommendation, RequestBatch, ResourceRequest


def _dedup_masks(masks: np.ndarray):
    """Collapse identical filter masks: ``(unique_masks, inverse)``.

    The Eq. 3 MinMax bounds depend only on (stats, mask), so requests that
    share a filter combination share one extrema reduction.  A batch of
    filterless requests — the common serve case — collapses to one row.
    """
    packed = np.packbits(masks, axis=1)
    index: dict = {}
    rows: list[int] = []
    inv = np.empty(masks.shape[0], np.int32)
    for b in range(masks.shape[0]):
        i = index.setdefault(packed[b].tobytes(), len(rows))
        if i == len(rows):
            rows.append(b)
        inv[b] = i
    return masks[np.asarray(rows)], inv


def _batched_scores(t3, prices, vcpus, memory_gb, masks, use_cpus, weights,
                    lams, amounts, stats=None, uniq_masks=None, uniq_inv=None,
                    *, score_impl: str = "dense"):
    """The batched scoring stage: (B, K) combined / availability / cost.

    ``score_impl="dense"`` evaluates the full Eq. 3 chain from ``t3`` in
    plain PyTorch.  ``"tiled"`` runs the fused masked scoring
    (:func:`~repro_torch.kernels.score_fuse.score_fuse_batch`) over
    per-candidate ``stats`` (computed from ``t3`` when not supplied by the
    archive cache), with the Eq. 3 MinMax bounds shared per unique filter
    mask.  On the same statistics the two give the same bits.
    """
    if score_impl == "tiled":
        if stats is None:
            stats = scoring.candidate_stats(t3)
        out = score_fuse_lib.score_fuse_batch(
            torch.stack(tuple(stats)), prices, vcpus, memory_gb, masks,
            use_cpus, amounts, lams, weights, uniq_masks, uniq_inv)
        return out.comb, out.avail, out.cost
    avail = scoring.masked_availability(scoring.candidate_stats(t3),
                                        lams[:, None], masks)
    caps = torch.where(use_cpus[:, None], vcpus, memory_gb)
    cost = scoring.cost_scores_masked(prices, caps, amounts[:, None], masks)
    comb = scoring.combined_scores(avail, cost, weights[:, None])
    return comb, avail, cost


def _pool_stage(comb, vcpus, memory_gb, masks, use_cpus, amounts, *,
                pool_impl: str):
    """Algorithm 1 over (B, K) score rows: each request's capacity row, then
    the masked scan.  ``(order, counts, k_stop, any_term)``.  The K-sharded
    pipeline (``repro_torch.shard.compute``) runs this same function on its
    gathered rows, so both give the same bits."""
    caps = torch.where(use_cpus[:, None], vcpus, memory_gb)          # (B, K)
    return pool_lib.greedy_pool_masked(comb, caps, amounts, masks,
                                       impl=pool_impl)


def _fused_recommend_batch(t3, prices, vcpus, memory_gb, masks, use_cpus,
                           weights, lams, amounts, stats=None,
                           uniq_masks=None, uniq_inv=None, *,
                           pool_impl: str = "dense",
                           score_impl: str = "dense"):
    """Eq. 3 -> Eq. 2 -> Eq. 4 -> Algorithm 1 for B masked requests.

    All operands are tensors on one device (``uniq_inv`` a host array).
    ``pool_impl`` / ``score_impl`` must be resolved, not "auto".  Returns
    ``(comb, avail, cost, order, counts, k_stop, any_term)`` on the device.
    """
    comb, avail, cost = _batched_scores(
        t3, prices, vcpus, memory_gb, masks, use_cpus, weights, lams,
        amounts, stats, uniq_masks, uniq_inv, score_impl=score_impl)
    return (comb, avail, cost) + tuple(_pool_stage(
        comb, vcpus, memory_gb, masks, use_cpus, amounts,
        pool_impl=pool_impl))


def _apply_max_types(idx: np.ndarray, counts: np.ndarray, comb: np.ndarray,
                     caps: np.ndarray, amount: float, max_types: int | None):
    """Cap pool diversity: keep the top-scoring members, re-allocate."""
    if max_types is None or len(idx) <= max_types:
        return idx, counts
    keep = idx[:max_types]
    s = comb[keep]
    total = s.sum()
    if total > 0:
        r = s / total * amount
    else:
        # All kept scores zero (e.g. W=1 with a flat archive): the
        # score-proportional split is 0/0, so allocate equally instead.
        r = np.full(len(keep), amount / len(keep))
    counts = np.ceil(r / caps[keep]).astype(np.int64)
    return keep, counts


class RecommendationEngine:
    """Stateless scoring + pool formation over a candidate archive slice.

    ``config`` (an :class:`~repro_torch.core.EngineConfig`) carries the
    ``pool_impl`` and ``score_impl`` switches, as in the reference; both
    lanes of each give bit-identical output on one device.  ``device`` is
    where requests without a staged archive run (CUDA unless ``"cpu"``);
    with an archive, its device.  The per-knob ``pool_impl=`` /
    ``score_impl=`` keyword arguments are deprecated shims.
    """

    def __init__(self, config: EngineConfig | None = None, *, device=None,
                 pool_impl: str | None = None, score_impl: str | None = None):
        self.config = resolve_engine_config(
            config, pool_impl=pool_impl, score_impl=score_impl)
        self.device = resolve_device(device)
        self.pool_impl = self.config.pool_impl
        self.score_impl = self.config.score_impl
        #: optional callable ``(request, recommendation) -> None`` invoked for
        #: every recommendation this engine returns (both entry points).  A
        #: raising sink is a bug in the subscriber, never in serving: the
        #: exception becomes a warning and the caller still gets its result.
        self.result_sink = None

    def _emit_results(self, requests, recs) -> None:
        if self.result_sink is None:
            return
        for req, rec in zip(requests, recs):
            try:
                self.result_sink(req, rec)
            except Exception as err:  # noqa: BLE001 — see result_sink contract
                warnings.warn(f"result_sink raised {err!r}; recommendation "
                              "delivery is unaffected", RuntimeWarning,
                              stacklevel=3)

    def score(self, cands: CandidateSet, req: ResourceRequest):
        """Return (combined S, availability AS, cost CS) for all candidates."""
        dev = self.device
        avail = scoring.availability_scores(f32(cands.t3, dev), req.lam)
        cost = scoring.cost_scores(f32(cands.prices, dev),
                                   f32(req.capacity_of(cands), dev),
                                   req.amount)
        comb = scoring.combined_scores(avail, cost, req.weight)
        return tuple(x.cpu().numpy() for x in (comb, avail, cost))

    def recommend(self, cands: CandidateSet, req: ResourceRequest) -> Recommendation:
        """One request through filter -> score -> Algorithm 1.

        Raises ``ValueError`` when the filters leave no candidate — the
        same empty-filter contract :meth:`recommend_batch` applies per row.
        """
        mask = req.filter_mask(cands)
        if not mask.any():
            raise ValueError("no candidates satisfy the request filters")
        sub = cands.take(np.flatnonzero(mask))
        comb, avail, cost = self.score(sub, req)

        caps = np.asarray(req.capacity_of(sub), np.float64)
        result = pool_lib.greedy_pool_vectorized(
            comb, caps, req.amount, impl=self.pool_impl, device=self.device)
        idx, counts = _apply_max_types(result.indices, result.counts, comb,
                                       caps, req.amount, req.max_types)
        hourly = float((sub.prices[idx] * counts).sum())
        rec = Recommendation(
            names=sub.names[idx], regions=sub.regions[idx], azs=sub.azs[idx],
            counts=counts, combined=comb[idx], availability=avail[idx],
            cost=cost[idx], hourly_cost=hourly,
            diagnostics={
                "candidates_considered": int(mask.sum()),
                "greedy_iterations": result.iterations,
                "solve_time_s": result.solve_time_s,
            },
        )
        self._emit_results([req], [rec])
        return rec

    def batch_arrays(self, cands: CandidateSet, batch: RequestBatch, *,
                     archive=None):
        """The fused stages for one :class:`RequestBatch`, as host arrays.

        Returns ``(comb, avail, cost, order, counts, k_stop, any_term)``:
        (B, K) score rows, the (B, K) sort order and counts, (B,) scan ends.
        A K-sharded ``archive`` (``is_sharded``) runs the per-shard
        pipeline of :mod:`repro_torch.shard.compute` (tiled scoring).
        """
        K = len(cands)
        impl = pool_lib.resolve_pool_impl(self.pool_impl, K)
        if archive is not None and getattr(archive, "is_sharded", False):
            from ..shard import sharded_batch_arrays
            uniq_masks, uniq_inv = _dedup_masks(batch.masks)
            return sharded_batch_arrays(
                archive, batch.masks, batch.use_cpus, batch.weights,
                batch.lams, batch.amounts, uniq_masks, uniq_inv,
                pool_impl=impl)
        s_impl = scoring.resolve_score_impl(self.score_impl, K)
        if (s_impl == "dense" and archive is not None
                and not getattr(archive, "dense_capable", True)):
            # version-pinned snapshots carry statistics but no window, so
            # they feed the tiled stage whatever the auto threshold says
            s_impl = "tiled"
        dev = archive.device if archive is not None else self.device
        if s_impl == "tiled":
            stats = archive.score_stats() if archive is not None else None
            uniq_masks, uniq_inv = _dedup_masks(batch.masks)
            uniq_masks = torch.as_tensor(uniq_masks, dtype=torch.bool,
                                         device=dev)
        else:
            stats = uniq_masks = uniq_inv = None
        if archive is not None:
            # With cached statistics the scoring stage never reads t3, so it
            # is not asked for: a rolling archive would gather its window,
            # O(K*T), and a snapshot has none.
            t3 = archive.t3 if stats is None else None
            prices, vcpus, memory_gb = (archive.prices, archive.vcpus,
                                        archive.memory_gb)
        else:
            t3, prices, vcpus, memory_gb = (
                f32(x, dev) for x in (cands.t3, cands.prices, cands.vcpus,
                                      cands.memory_gb))
        on = lambda x, dtype=torch.float32: torch.as_tensor(  # noqa: E731
            x, dtype=dtype, device=dev)
        outs = _fused_recommend_batch(
            t3, prices, vcpus, memory_gb, on(batch.masks, torch.bool),
            on(batch.use_cpus, torch.bool),
            on(batch.weights), on(batch.lams), on(batch.amounts), stats,
            uniq_masks, uniq_inv, pool_impl=impl, score_impl=s_impl)
        return tuple(x.cpu().numpy() for x in outs)

    def recommend_batch(self, cands: CandidateSet, requests,
                        *, pad_to: int | None = None,
                        archive=None) -> list[Recommendation]:
        """Serve B requests in one fused pass; order matches ``requests``.

        Parity with calling :meth:`recommend` per request: the same pool
        (members, order, node counts, hourly cost, diagnostics); scores
        agree to float32-ulp level (the per-request path reduces the
        gathered subset's statistics, another summation order).

        Empty-filter contract (shared with :meth:`recommend`): a request
        whose filters leave no candidate raises ``ValueError`` naming the
        batch row, before anything runs on the device.

        ``solve_time_s`` in the diagnostics is the whole-batch wall time,
        stamped on every request.  ``pad_to`` pads the batch axis with inert
        rows that are computed and discarded.  ``archive`` is an optional
        staged :class:`repro_torch.serve.DeviceArchive` (or quantised
        archive), live :class:`repro_torch.stream.RollingDeviceArchive` or
        its :class:`~repro_torch.stream.ArchiveSnapshot`, or a K-sharded
        archive (``repro_torch.shard``): the batch runs on its device, reads
        its resident arrays and its memoised statistics.
        """
        requests = list(requests)
        if not requests:
            return []
        t0 = time.perf_counter()
        batch = RequestBatch.from_requests(cands, requests, pad_to=pad_to)
        # Defensive re-check of the empty-filter contract: an all-masked row
        # would end in a degenerate k = 0 pool on a filtered-out candidate.
        empty = ~batch.masks[:batch.n_valid].any(axis=1)
        if empty.any():
            raise ValueError("no candidates satisfy the request filters "
                             f"(batch row {int(np.flatnonzero(empty)[0])})")
        arrays = self.batch_arrays(cands, batch, archive=archive)
        return self._build_recommendations(
            cands, batch, requests, *arrays[:6], time.perf_counter() - t0)

    def _build_recommendations(self, cands: CandidateSet, batch: RequestBatch,
                               requests, comb, avail, cost, order, counts,
                               k_stop, solve_time: float) -> list[Recommendation]:
        """Materialise :class:`Recommendation`\\ s from the batched arrays:
        the ``max_types`` cap, float64 hourly-cost accounting and the
        diagnostics contract."""
        recs = []
        for b, req in enumerate(requests):
            sel = counts[b] > 0
            idx = np.asarray(order[b])[sel].astype(np.int64)
            cnt = np.asarray(counts[b])[sel].astype(np.int64)
            caps = np.asarray(req.capacity_of(cands), np.float64)
            idx, cnt = _apply_max_types(idx, cnt, comb[b], caps, req.amount,
                                        req.max_types)
            hourly = float((cands.prices[idx] * cnt).sum())
            n_real = int(batch.masks[b].sum())
            # A stop at the first masked lane is the gathered scan running
            # out of candidates, which the per-request path reports as 1.
            iters = int(k_stop[b]) + 1 if int(k_stop[b]) < n_real else 1
            recs.append(Recommendation(
                names=cands.names[idx], regions=cands.regions[idx],
                azs=cands.azs[idx], counts=cnt, combined=comb[b][idx],
                availability=avail[b][idx], cost=cost[b][idx],
                hourly_cost=hourly,
                diagnostics={
                    "candidates_considered": n_real,
                    "greedy_iterations": iters,
                    "solve_time_s": solve_time,
                    "batch_size": batch.batch_size,
                },
            ))
        self._emit_results(requests, recs)
        return recs

    def score_archive(self, archive, *, lam: float = scoring.DEFAULT_LAMBDA,
                      weight: float = 0.5, amount: float = 1.0,
                      use_cpus: bool = True):
        """Fresh unfiltered (K,) score rows for a staged archive.

        One stats-backed fused scoring call, never touching the (K, T)
        window; returns ``(combined, availability, cost)`` float32 numpy rows.
        A K-sharded archive goes through the per-shard pipeline: a shard
        scored alone would normalise Eq. 3 against its own extrema, so the
        exact cross-shard merge is what makes its rows equal the
        single-device archive's.
        """
        if getattr(archive, "is_sharded", False):
            from ..shard import sharded_batch_arrays
            mask = np.ones((1, len(archive)), bool)
            impl = pool_lib.resolve_pool_impl(self.pool_impl, len(archive))
            comb, avail, cost, *_ = sharded_batch_arrays(
                archive, mask, np.array([use_cpus]),
                np.array([weight], np.float32), np.array([lam], np.float32),
                np.array([amount], np.float32), mask, np.zeros(1, np.int32),
                pool_impl=impl)
            return comb[0], avail[0], cost[0]
        dev = archive.device
        mask = torch.ones((1, len(archive)), dtype=torch.bool, device=dev)
        one = lambda x: f32([x], dev)  # noqa: E731
        out = score_fuse_lib.score_fuse_batch(
            torch.stack(tuple(archive.score_stats())), archive.prices,
            archive.vcpus, archive.memory_gb, mask,
            torch.tensor([use_cpus], dtype=torch.bool, device=dev),
            one(amount), one(lam), one(weight), mask, [0])
        return tuple(x[0].cpu().numpy() for x in (out.comb, out.avail,
                                                  out.cost))
