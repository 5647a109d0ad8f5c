"""Fused masked scoring: the per-request O(K) remainder of Eq. 2-4 over
archive-cached per-candidate statistics, for a whole request batch.

PyTorch counterpart of ``repro.kernels.score_fuse``.  The (K, T) reductions
of Eq. 3 are request-independent and cached per archive
(``core.scoring.candidate_stats``); per request there remain

    phase 0:  masked min/max of the three statistics (the Eq. 3 MinMax
              bounds) and the masked C_min of Eq. 2 — seven scalars;
    phase 1:  the normalized combined / availability / cost rows (Eq. 4).

:func:`score_fuse_batch` does both for B requests in one call.  The stat
extrema depend only on ``(stats, mask)``, so they are taken once per
*unique* filter mask (``uniq_masks`` / ``inv``, see ``core.engine.
_dedup_masks``) and shared by the requests that carry it.
:func:`score_fuse_phase0` does phase 0 alone: the K-sharded pipeline
(``repro_torch.shard.compute``) takes it on every shard, merges the
scalars across shards and hands them to :func:`score_fuse_batch` as
``extrema`` / ``cost_floor``.

Two versions, one contract:

- the plain PyTorch version (:func:`_score_fuse_torch`), which CPU tensors
  take and ``backend="torch"`` forces;
- the CUDA kernel ``csrc/score_fuse.cu`` (:func:`_score_fuse_cuda`), which
  CUDA tensors take: a K-split reduction (``score_reduce_kernel``, at least
  one block an SM at the serving shape, partial extrema and C_min per
  K-slice into scratch) and an emit (``score_emit_kernel``) that merges its
  row's partials and writes the rows 16 bytes a thread on aligned rows;
  grids from :func:`score_plan` (mirrored on the CPU in
  ``tests/test_torch_schedules.py``); phase 0 alone is the reduction and
  ``score_merge_kernel`` (one block a row).  It is built with ``--fmad=false``
  and keeps the op order of ``_emit_rows`` below, so on the same inputs
  its rows, extrema and C_min equal the plain version's bit for bit.

Against the JAX reference, extrema and C_min are bit-equal on the same
statistics (min and max are exact); the rows agree to float32-ulp level,
because XLA contracts the elementwise chain into fused multiply-adds.

An all-masked row (which the engine rejects before dispatch) yields
``cost = +inf`` everywhere and ``combined = NaN`` when ``weight == 1``
(``1*avail + 0*inf``), as in the reference.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.scoring import _minmax_from, f32
from . import _build

INF = float("inf")

REDUCE_WARPS = 8         # a reduce block: 8 warps of 4 rows each
ROWS_PER_WARP = 4
REDUCE_ROWS = REDUCE_WARPS * ROWS_PER_WARP   # rows a reduce block (grid y)
EMIT_THREADS = 256
EMIT_GROUPS = 2          # 4-lane groups an emit thread
LANES = 4                # lanes a group: one 16-byte access
EMIT_LANES = EMIT_THREADS * EMIT_GROUPS * LANES
SLICES_PER_SM = 2        # reduce blocks aimed at, per SM


class FusedScores(NamedTuple):
    """Outputs of :func:`score_fuse_batch`."""

    comb: torch.Tensor     # (B, K) combined score S (Eq. 4)
    avail: torch.Tensor    # (B, K) availability score AS (Eq. 3)
    cost: torch.Tensor     # (B, K) cost score CS (Eq. 2)
    extrema: torch.Tensor  # (U, 6) (lo, hi) of area, slope, std per mask
    c_min: torch.Tensor    # (B,) masked C_min per request


def _tile_total(prices, vcpus, memory_gb, use_cpus, required):
    """Eq. 2 cost basis C_i = p_i * ceil(R / cap_i); exact division."""
    caps = torch.where(use_cpus, vcpus, memory_gb)
    return prices * torch.ceil(required / caps)


def _emit_rows(stats, total, ext, c_min, lam, weight):
    """Phase 1, op for op as the reference's ``_emit_rows`` and the kernel.

    ``ext`` is (B, 6), ``c_min``/``lam``/``weight`` are (B,).
    """
    col = lambda x: x[:, None]  # noqa: E731
    a3 = _minmax_from(stats[0], ext[:, 0:1], ext[:, 1:2])
    slope_n = _minmax_from(stats[1], ext[:, 2:3], ext[:, 3:4])
    sigma_n = _minmax_from(stats[2], ext[:, 4:5], ext[:, 5:6])
    avail = torch.clamp(100.0 * a3 * (1.0 + col(lam) * (slope_n - sigma_n)),
                        min=0.0)
    cost = 100.0 * col(c_min) / total
    comb = col(weight) * avail + (1.0 - col(weight)) * cost
    return comb, avail, cost


def _extrema_torch(stats, uniq_masks):
    """Phase 0's (U, 6) masked (lo, hi) pairs of area, slope, std."""
    u = uniq_masks.bool()[:, None, :]                            # (U, 1, K)
    lo = torch.where(u, stats, INF).amin(-1)                     # (U, 3)
    hi = torch.where(u, stats, -INF).amax(-1)
    return torch.stack([lo, hi], -1).reshape(-1, 6)


def _cost_floor_torch(total, masks):
    """Phase 0's (B,) masked C_min."""
    return torch.where(masks.bool(), total, INF).amin(-1)


def _score_fuse_torch(stats, prices, vcpus, memory_gb, masks, use_cpus,
                      amount, lam, weight, uniq_masks, inv, extrema,
                      cost_floor) -> FusedScores:
    total = _tile_total(prices, vcpus, memory_gb, use_cpus[:, None].bool(),
                        amount[:, None])
    if extrema is None:
        extrema = _extrema_torch(stats, uniq_masks)
    if cost_floor is None:
        cost_floor = _cost_floor_torch(total, masks)
    comb, avail, cost = _emit_rows(stats, total, extrema[inv.long()],
                                   cost_floor, lam, weight)
    return FusedScores(comb, avail, cost, extrema, cost_floor)


@dataclass(frozen=True)
class ScorePlan:
    """B1's grids.  The reduce runs on (``slices``, ``row_groups``) blocks:
    block (g, y) takes lanes [g * ``slice``, (g + 1) * ``slice``) of K (a
    multiple of ``LANES``) and rows [32 y, 32 y + 32) of the U extrema rows
    followed by the B C_min rows, and writes one partial per row and slice.
    The emit runs on (``emit_blocks``, B) blocks of ``EMIT_LANES`` lanes.
    ``vec``: 16-byte accesses (:func:`vec_ok`)."""

    slices: int
    slice: int
    row_groups: int
    emit_blocks: int
    vec: bool


def score_plan(K: int, rows: int, sms: int, vec: bool) -> ScorePlan:
    """Split K so that the reduce has about ``SLICES_PER_SM`` blocks an SM
    (never more slices than 4-lane groups, so at most that many partials a
    row for the emit to merge)."""
    row_groups = max(1, -(-rows // REDUCE_ROWS))
    groups = -(-K // LANES)
    want = max(1, -(-SLICES_PER_SM * sms // row_groups))
    per = -(-groups // min(groups, want))
    width = LANES * per
    return ScorePlan(slices=-(-K // width), slice=width, row_groups=row_groups,
                     emit_blocks=-(-K // EMIT_LANES), vec=vec)


def reduce_block_work(plan: ScorePlan, K: int, rows: int, x: int, y: int):
    """(lanes, rows) that reduce block (x, y) scans."""
    return (range(x * plan.slice, min(K, (x + 1) * plan.slice)),
            range(y * REDUCE_ROWS, min(rows, (y + 1) * REDUCE_ROWS)))


def emit_block_work(plan: ScorePlan, K: int, x: int, y: int):
    """(request row, lanes) that emit block (x, y) writes."""
    return y, range(x * EMIT_LANES, min(K, (x + 1) * EMIT_LANES))


def vec_ok(K: int, floats, bytes_) -> bool:
    """Whether every row can be read and written 16 bytes a thread: K a
    multiple of 4 (so rows 1 and 2 of ``stats`` and every (B, K) row start
    on a 16-byte boundary when row 0 does), every float array on a 16-byte
    boundary and every byte-mask array on a 4-byte one."""
    return _build.rows_aligned(K, (*floats, *bytes_))


def _library():
    return _build.library("score_fuse", {"score_fuse_reduce": (10, 7),
                                         "score_fuse_emit": (16, 6),
                                         "score_fuse_merge": (4, 3)})


def occupancy(device) -> tuple[int, int]:
    """Blocks of ``score_reduce_kernel`` and ``score_emit_kernel`` an SM
    holds at once on ``device``, as the CUDA runtime reports them."""
    return _occupancy(torch.device(device))


@functools.lru_cache(maxsize=None)
def _occupancy(device) -> tuple[int, int]:
    return _build.int_outputs(_library(), "score_fuse_occupancy", 2, device)


def _score_fuse_cuda(stats, prices, vcpus, memory_gb, masks, use_cpus,
                     amount, lam, weight, uniq_masks, inv, extrema,
                     cost_floor) -> FusedScores:
    B, K = masks.shape
    U = uniq_masks.shape[0]
    dev = stats.device
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    comb, avail, cost = new(B, K), new(B, K), new(B, K)
    ext = new(U, 6) if extrema is None else extrema
    cmin = new(B) if cost_floor is None else cost_floor
    n_ext = U if extrema is None else 0
    n_cmin = B if cost_floor is None else 0
    vec = vec_ok(K, (stats, prices, vcpus, memory_gb, comb, avail, cost),
                 (masks, uniq_masks))
    plan = score_plan(K, n_ext + n_cmin, _build.sm_count(dev), vec)
    part_ext = new(n_ext, 6, plan.slices) if n_ext else None
    part_cmin = new(n_cmin, plan.slices) if n_cmin else None
    lib = _library()
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if n_ext + n_cmin:
            _build.check(lib.score_fuse_reduce(
                ptr(stats), ptr(prices), ptr(vcpus), ptr(memory_gb),
                ptr(uniq_masks), ptr(masks), ptr(use_cpus), ptr(amount),
                ptr(part_ext), ptr(part_cmin), K, n_ext, n_cmin,
                plan.slices, plan.slice, plan.row_groups, int(vec), stream),
                "score_fuse_reduce")
        _build.check(lib.score_fuse_emit(
            ptr(stats), ptr(prices), ptr(vcpus), ptr(memory_gb),
            ptr(use_cpus), ptr(amount), ptr(lam), ptr(weight), ptr(inv),
            ptr(ext), ptr(cmin), ptr(part_ext), ptr(part_cmin), ptr(comb),
            ptr(avail), ptr(cost), K, B, U, plan.slices, plan.emit_blocks,
            int(vec), stream), "score_fuse_emit")
    score_fuse_batch.launches += 1
    return FusedScores(comb, avail, cost, ext, cmin)


def _expect_phase0(stats, prices, vcpus, memory_gb, masks, use_cpus,
                   amount, uniq_masks) -> None:
    """Check the operands both phases read (see :func:`score_fuse_batch`)."""
    K, (B, U) = stats.shape[-1], (masks.shape[0], uniq_masks.shape[0])
    f, byte = (torch.float32,), (torch.bool, torch.uint8)
    for t, name, shape, dt in (
            (stats, "stats", (3, K), f), (prices, "prices", (K,), f),
            (vcpus, "vcpus", (K,), f), (memory_gb, "memory_gb", (K,), f),
            (masks, "masks", (B, K), byte), (use_cpus, "use_cpus", (B,), byte),
            (amount, "amount", (B,), f),
            (uniq_masks, "uniq_masks", (U, K), byte)):
        _build.expect(t, name, shape, dt, stats.device)


def score_fuse_batch(stats, prices, vcpus, memory_gb, masks, use_cpus,
                     amount, lam, weight, uniq_masks=None, inv=None, *,
                     extrema=None, cost_floor=None,
                     backend: str | None = None) -> FusedScores:
    """Masked Eq. 2-4 for B requests over one candidate axis.

    ``stats`` (3, K) float32 rows (area, slope, std); ``prices`` /
    ``vcpus`` / ``memory_gb`` (K,) float32; ``masks`` (B, K) bool or uint8;
    ``use_cpus`` (B,) bool or uint8; ``amount`` / ``lam`` / ``weight`` (B,)
    float32.  ``uniq_masks`` (U, K) holds the distinct filter masks and
    ``inv`` (B,) maps each request to its row — a host array (numpy or CPU
    tensor), checked against U before it goes to the device; by default
    every request is its own row.  ``extrema`` (U, 6) short-circuits the
    stat half of phase 0 with precomputed ``(lo, hi)`` pairs and
    ``cost_floor`` (B,) the C_min half; both are used verbatim.

    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    kernel (or raise); ``backend="torch"`` forces the plain version on any
    device, for tests and the on-card comparison.
    """
    if uniq_masks is None:
        uniq_masks, inv = masks, np.arange(masks.shape[0])
    dev = stats.device
    K = stats.shape[-1]
    B, U = masks.shape[0], uniq_masks.shape[0]
    if K < 1 or B < 1:
        raise ValueError("score_fuse_batch needs K >= 1 and B >= 1")
    inv = np.asarray(torch.as_tensor(inv, dtype=torch.int64).cpu())
    if inv.shape != (B,) or inv.min() < 0 or inv.max() >= U:
        raise ValueError(f"inv must be {B} indices into {U} unique masks")
    inv = torch.as_tensor(inv, dtype=torch.int32).to(dev)
    _expect_phase0(stats, prices, vcpus, memory_gb, masks, use_cpus, amount,
                   uniq_masks)
    for t, name, shape in ((lam, "lam", (B,)), (weight, "weight", (B,)),
                           (extrema, "extrema", (U, 6)),
                           (cost_floor, "cost_floor", (B,))):
        if t is not None:
            _build.expect(t, name, shape, (torch.float32,), dev)
    args = (stats, prices, vcpus, memory_gb, masks, use_cpus, amount, lam,
            weight, uniq_masks, inv, extrema, cost_floor)
    if _build.route(backend, dev) == "cuda":
        if B > 65535:
            raise ValueError("the kernel takes at most 65535 requests a call")
        return _score_fuse_cuda(*args)
    return _score_fuse_torch(*args)


#: kernel launches by :func:`score_fuse_batch` (one per call that ran it)
score_fuse_batch.launches = 0


def _phase0_cuda(stats, prices, vcpus, memory_gb, masks, use_cpus, amount,
                 uniq_masks):
    B, K = masks.shape
    U = uniq_masks.shape[0]
    dev = stats.device
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    vec = vec_ok(K, (stats, prices, vcpus, memory_gb), (masks, uniq_masks))
    plan = score_plan(K, U + B, _build.sm_count(dev), vec)
    part_ext, part_cmin = new(U, 6, plan.slices), new(B, plan.slices)
    ext, cmin = new(U, 6), new(B)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.score_fuse_reduce(
            stats.data_ptr(), prices.data_ptr(), vcpus.data_ptr(),
            memory_gb.data_ptr(), uniq_masks.data_ptr(), masks.data_ptr(),
            use_cpus.data_ptr(), amount.data_ptr(), part_ext.data_ptr(),
            part_cmin.data_ptr(), K, U, B, plan.slices, plan.slice,
            plan.row_groups, int(vec), stream), "score_fuse_reduce")
        _build.check(lib.score_fuse_merge(
            part_ext.data_ptr(), part_cmin.data_ptr(), ext.data_ptr(),
            cmin.data_ptr(), U, B, plan.slices, stream), "score_fuse_merge")
    score_fuse_phase0.launches += 1
    return ext, cmin


def score_fuse_phase0(stats, prices, vcpus, memory_gb, masks, use_cpus,
                      amount, uniq_masks, *, backend: str | None = None):
    """Phase 0 alone: ``(extrema (U, 6), cost_floor (B,))``.

    The masked (lo, hi) of area, slope and std per unique filter mask and
    the masked Eq. 2 C_min per request, over this candidate axis — what
    :func:`score_fuse_batch` computes before it emits, and takes verbatim
    as ``extrema=`` / ``cost_floor=``.  Operands as there.  CPU tensors
    take the plain version, CUDA tensors the reduce kernel and
    ``score_merge_kernel`` (or raise); min and max are exact, so both give
    the same values (a zero's sign aside, as for :func:`score_fuse_batch`).
    """
    dev = stats.device
    if min(stats.shape[-1], masks.shape[0], uniq_masks.shape[0]) < 1:
        raise ValueError("score_fuse_phase0 needs K >= 1, B >= 1 and U >= 1")
    _expect_phase0(stats, prices, vcpus, memory_gb, masks, use_cpus, amount,
                   uniq_masks)
    if _build.route(backend, dev) == "cuda":
        return _phase0_cuda(stats, prices, vcpus, memory_gb, masks, use_cpus,
                            amount, uniq_masks)
    total = _tile_total(prices, vcpus, memory_gb, use_cpus[:, None].bool(),
                        amount[:, None])
    return _extrema_torch(stats, uniq_masks), _cost_floor_torch(total, masks)


#: kernel launches by :func:`score_fuse_phase0` (one per call that ran it)
score_fuse_phase0.launches = 0


def stat_extrema(area, slope, std, mask):
    """Masked (min, max) of the three stats: ``(lo, hi)``, each (3,).

    Phase 0 minus the cost term, ordered (area, slope, std).  Min and max
    are exact, so this equals the reference's streamed scan bit for bit.
    """
    x = torch.stack([f32(area), f32(slope), f32(std)])
    m = torch.as_tensor(mask, device=x.device).bool()
    return (torch.where(m, x, INF).amin(-1),
            torch.where(m, x, -INF).amax(-1))


def cost_min(prices, vcpus, memory_gb, mask, use_cpus, required):
    """Masked Eq. 2 C_min — the request-dependent half of phase 0."""
    prices = f32(prices)
    dev = prices.device
    total = _tile_total(prices, f32(vcpus, dev), f32(memory_gb, dev),
                        torch.as_tensor(use_cpus, device=dev).bool(),
                        f32(required, dev))
    m = torch.as_tensor(mask, device=dev).bool()
    return torch.where(m, total, INF).amin()


def score_fuse(area, slope, std, prices, vcpus, memory_gb, mask, use_cpus,
               required, lam, weight, extrema=None, cost_floor=None, *,
               backend: str | None = None):
    """Masked Eq. 2-4 for one request: ``(combined, availability, cost)``.

    The one-request form of :func:`score_fuse_batch`, with the reference's
    signature.  ``extrema=(lo, hi)`` (each (3,), see :func:`stat_extrema`)
    must have been taken over exactly this ``mask``; ``cost_floor`` (see
    :func:`cost_min`) is used verbatim.  Float64 inputs are cast to float32.
    """
    area = f32(area)
    dev = area.device
    K = area.shape[0]
    stats = torch.stack([area, f32(slope, dev), f32(std, dev)])
    masks = torch.as_tensor(mask, device=dev).bool().reshape(1, K)
    one = lambda x: f32(x, dev).reshape(1)  # noqa: E731
    ext = None if extrema is None else torch.stack(
        [f32(extrema[0], dev), f32(extrema[1], dev)], -1).reshape(1, 6)
    out = score_fuse_batch(
        stats, f32(prices, dev), f32(vcpus, dev), f32(memory_gb, dev), masks,
        torch.as_tensor(use_cpus, device=dev).bool().reshape(1),
        one(required), one(lam), one(weight), masks, [0], extrema=ext,
        cost_floor=None if cost_floor is None else one(cost_floor),
        backend=backend)
    return out.comb[0], out.avail[0], out.cost[0]
