"""Algorithm 1's all-prefix termination scan in O(K) memory per request.

PyTorch counterpart of ``repro.kernels.pool_scan``.  The dense scan
(``core.pool._prefix_allocations``) materializes

    X[k, j] = ceil( s_j * R / (cumsum(s)[k] * c_j) )        for j <= k

but Algorithm 1 only inspects one column and the diagonal of X::

    top[k]    = X[k, 0]   — depends only on s_0, c_0 and cumsum(s)[k]
    newest[k] = X[k, k]   — depends only on s_k, c_k and cumsum(s)[k]

so the scan needs the (K,) prefix-sum vector, not the matrix.  It stops at
the first k where ``top[k] >= top[k-1]`` or ``newest[k] == 0`` and emits the
allocation row of prefix k - 1 (or ``ceil(R / c_0)`` on the leader when it
stops at k = 0).

The prefix sums come from :func:`_clamped_prefix_sums`, the one call the
dense and tiled scans share on a device, so the two give bit-identical
pools.  That sharing is within one package and one device: ``torch.cumsum``
and ``jnp.cumsum`` (and the CPU and CUDA ``torch.cumsum``) sum in other
orders, which is why pools are compared across them with a decision-margin
replay (``core.pool.prefix_sum_tie``) and not bit for bit.

Two versions, one contract, both batched over a leading request axis:

- the plain PyTorch version (:func:`_pool_scan_torch`), which CPU tensors
  take and ``backend="torch"`` forces;
- the CUDA kernel ``csrc/pool_scan.cu`` (:func:`_pool_scan_cuda`), which
  CUDA tensors take: one launch, a thread-block cluster a request.  Every
  block scans the first tile of :func:`pool_scan_plan`, which holds the
  stop in the serving mix; otherwise the blocks walk their own tiles in
  order, each to its first terminating lane or its last tile, and merge
  once.  Then they write the counts row, 16 bytes a thread on aligned rows
  (mirrored on the CPU in ``tests/test_torch_schedules.py``).  Its outputs
  equal the plain version's bit for bit on the same inputs.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.scoring import f32
from . import _build

INT32_MAX = 2 ** 31 - 1


def _clamped_prefix_sums(s: torch.Tensor) -> torch.Tensor:
    """Prefix sums along the last axis, with non-positive sums set to 1."""
    s_tot = torch.cumsum(s, dim=-1)
    return torch.where(s_tot > 0, s_tot, 1.0)


def _first_true(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(any, first index or 0)`` along the last axis of a bool tensor."""
    K = x.shape[-1]
    lane = torch.arange(K, dtype=torch.int32, device=x.device)
    first = torch.where(x, lane, K).amin(-1)
    found = first < K
    return found, torch.where(found, first, 0).to(torch.int32)


def _finalize(found, k_stop, k_total):
    """Dense-scan semantics of the reduction outputs: ``k_best``, ``deg``."""
    k_best = torch.where(found, torch.clamp(k_stop - 1, min=0), k_total - 1)
    return k_best, found & (k_stop == 0)


def _emit_row(s, c, required, csc, k_best, deg):
    """The counts row of prefix ``k_best``; ``ceil(R / c_0)`` on the leader
    under the degenerate k = 0 guard.  (B, K) inputs, (B,) scalars."""
    col = lambda x: x[:, None]  # noqa: E731
    lane = torch.arange(s.shape[-1], device=s.device)
    stot = csc.gather(1, col(k_best.long()))
    row = torch.ceil(s * col(required) / (stot * c)).to(torch.int32)
    row = torch.where(lane <= col(k_best), row, 0)
    fb0 = torch.ceil(col(required) / c[:, :1]).to(torch.int32)
    return torch.where(col(deg), torch.where(lane == 0, fb0, 0), row)


def _pool_scan_torch(s, c, csc, required):
    R = required[:, None]
    K = s.shape[-1]
    top = torch.ceil(s[:, :1] * R / (csc * c[:, :1])).to(torch.int32)
    newest = torch.ceil(s * R / (csc * c)).to(torch.int32)
    prev = torch.cat([torch.full_like(top[:, :1], INT32_MAX), top[:, :-1]], 1)
    term = (top >= prev) | (newest == 0)
    term[:, 0] = newest[:, 0] == 0                       # x_prev_top = inf at k=0
    found, k_stop = _first_true(term)
    k_best, deg = _finalize(found, k_stop, K)
    return _emit_row(s, c, required, csc, k_best, deg), k_stop, found


CLUSTER = 8           # blocks a request: one thread-block cluster
THREADS = 256         # threads a block
LANES = 4             # adjacent lanes a thread: one 16-byte access
TILE = THREADS * LANES


@dataclass(frozen=True)
class PoolScanPlan:
    """B2's launch: a (``cluster``, B) grid of clusters of ``cluster``
    blocks.  Lanes come in tiles of ``tile``, ``lanes`` adjacent lanes a
    thread; block r's e-th tile is tile ``e * cluster + r``.  Every block
    scans tile 0; past it a block walks at most its ``tiles`` tiles (block
    0 from its second), in order; each writes the counts row over its own
    tiles."""

    cluster: int
    threads: int
    lanes: int
    tile: int
    tiles: int
    grid: tuple[int, int]


def pool_scan_plan(B: int, K: int) -> PoolScanPlan:
    """The kernel's grid and tiles a block for B requests of K lanes."""
    if not 1 <= B <= 65535:
        raise ValueError("the kernel takes 1 to 65535 requests a call")
    return PoolScanPlan(cluster=CLUSTER, threads=THREADS, lanes=LANES,
                        tile=TILE, tiles=-(-K // (CLUSTER * TILE)),
                        grid=(CLUSTER, B))


def block_lanes(plan: PoolScanPlan, K: int, e: int, r: int) -> range:
    """Lanes of block ``r``'s ``e``-th tile."""
    k0 = (e * plan.cluster + r) * plan.tile
    return range(min(k0, K), min(k0 + plan.tile, K))


def _library():
    return _build.library("pool_scan", {"pool_scan_launch": (7, 4)})


def geometry(device) -> tuple[int, int, int, int]:
    """``(cluster, threads, lanes)`` as the kernel was compiled, and how
    many of its clusters ``device`` holds at once."""
    return _build.int_outputs(_library(), "pool_scan_geometry", 4,
                              torch.device(device))


def _pool_scan_cuda(s, c, csc, required):
    B, K = s.shape
    dev = s.device
    new = lambda *shape: torch.empty(shape, dtype=torch.int32, device=dev)  # noqa: E731
    counts, k_stop = new(B, K), new(B)
    any_term = torch.empty(B, dtype=torch.bool, device=dev)
    plan = pool_scan_plan(B, K)
    vec = _build.rows_aligned(K, (s, c, csc, counts))
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.pool_scan_launch(
            s.data_ptr(), c.data_ptr(), csc.data_ptr(), required.data_ptr(),
            counts.data_ptr(), k_stop.data_ptr(), any_term.data_ptr(), B, K,
            plan.tiles, int(vec), stream), "pool_scan_launch")
    pool_scan.launches += 1
    return counts, k_stop, any_term


def pool_scan(s, c, required, csc=None, *, backend: str | None = None):
    """All-prefix Algorithm 1 scan over score-sorted ``(s, c)``.

    ``s``, ``c`` are (K,) or (B, K) float32 in score-descending order,
    ``required`` a scalar or (B,).  ``csc`` defaults to
    :func:`_clamped_prefix_sums` of ``s``; pass it to scan given prefix
    sums.  Returns ``(counts_sorted, k_stop, any_term)`` with the dense
    scan's semantics: int32 counts, int32 k_stop, bool any_term.

    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    kernel (or raise); ``backend="torch"`` forces the plain version.
    """
    single = s.dim() == 1
    s2 = s.reshape(1, -1) if single else s
    B, K = s2.shape
    if K < 1 or B < 1:
        raise ValueError("pool_scan needs K >= 1 and B >= 1")
    dev = s2.device
    c2 = c.reshape(B, K)
    csc2 = _clamped_prefix_sums(s2) if csc is None else csc.reshape(B, K)
    req = f32(required, dev).reshape(-1).expand(B).contiguous()
    for t, name in ((s2, "s"), (c2, "c"), (csc2, "csc")):
        _build.expect(t, name, (B, K), (torch.float32,), dev)
    if _build.route(backend, dev) == "cuda":
        out = _pool_scan_cuda(s2, c2, csc2, req)
    else:
        out = _pool_scan_torch(s2, c2, csc2, req)
    return tuple(x[0] for x in out) if single else out


#: kernel launches by :func:`pool_scan` (one per call that ran it)
pool_scan.launches = 0
