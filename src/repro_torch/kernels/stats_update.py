"""Incremental candidate statistics: the O(K) rank-1 update of the Eq. 3
reductions when the live collector appends (and possibly evicts) one T3
column.

PyTorch counterpart of ``repro.kernels.stats_update``.  Every statistic of
Eq. 3 is a function of three streaming moments per candidate,

    S0 = sum(y_i),   S1 = sum(i * y_i),   Q = sum((y_i - ref)^2)

(``i`` the position inside the window, oldest first; ``ref`` a frozen
per-candidate centring point), and one tick updates each with O(1) work:

    append y_new (window grows to length L):
        S0 += y_new;  S1 += (L - 1) * y_new;  Q += (y_new - ref)^2
    evict y_old (window slides, length stays L):
        S0 -= y_old
        S1  = S1 - S0_pre + y_old            (every survivor's index drops 1)
        Q  -= (y_old - ref)^2

The moments are float32 Neumaier pairs ``(sum, compensation)``, so a long
stream of ticks cannot drift them; ``core.scoring.stats_from_moments``
turns them back into ``(area, slope, std)``.

Two versions, one contract:

- the plain PyTorch version (:func:`_stats_update_torch`), which CPU
  tensors take and ``backend="torch"`` forces;
- the CUDA kernel B3, ``csrc/stats_update.cu`` (:func:`_stats_update_cuda`),
  which CUDA tensors take: one elementwise pass over K that reads the six
  moment halves, ``ref`` and the four columns (int8 codes and a scale row on
  the quantized tier) and writes the six new halves and the statistics.  It
  is built with ``--fmad=false`` and keeps the op order of
  :func:`_update_tile`, so on the same inputs it equals the plain version
  bit for bit.

Against the JAX reference the outputs agree to float32-ulp level, not bit
for bit: XLA on the CPU contracts ``s + a * b`` into fused multiply-adds
inside ``_update_tile`` and ``stats_from_moments``, which PyTorch's eager
ops never do.  (On the float32 tier S0, its compensation and the area hold
no product and stay bit-equal.)
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import scoring
from ..core.scoring import f32
from . import _build


class StreamMoments(NamedTuple):
    """Float32 Neumaier pairs of the three streaming moments, each (K,).

    The resolved value of each moment is ``sum + comp``.  ``ref`` is the
    frozen centring point of the second moment, a constant (re-priming the
    archive is the only thing that moves it).
    """

    s0: torch.Tensor       # sum(y)
    s0c: torch.Tensor
    s1: torch.Tensor       # sum(i * y), window-relative index, oldest first
    s1c: torch.Tensor
    q: torch.Tensor        # sum((y - ref)^2)
    qc: torch.Tensor
    ref: torch.Tensor      # frozen centring point (seed window's mean)

    @property
    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in self)


def moments_from_window(t3, *, scale=None, chunk: int = 65536,
                        device=None) -> StreamMoments:
    """Exact cold-start moments of a host (K, T) window.

    The reference's numpy code: float64 host reductions, each split into a
    float32 ``(hi, lo)`` pair, and ``ref`` frozen at the float32-rounded
    seed-window mean, so both packages seed the same bits.  ``scale`` seeds
    an int8 tier: ``t3`` holds codes, decoded ``code.astype(f32) * scale``
    per chunk before the reductions.  ``t3`` may be a numpy array or a
    tensor (a bf16 tensor casts to float32 exactly).  The moments land on
    ``device`` (the CPU when ``None``).
    """
    if isinstance(t3, torch.Tensor):
        t3 = t3.detach().cpu()
        t3 = (t3.float() if t3.dtype == torch.bfloat16 else t3).numpy()
    t3 = np.asarray(t3)
    if scale is not None:
        scale = np.asarray(scale, np.float32)
    K, T = t3.shape
    idx = np.arange(T, dtype=np.float64)
    s0 = np.empty(K, np.float64)
    s1 = np.empty(K, np.float64)
    q = np.empty(K, np.float64)
    ref32 = np.empty(K, np.float32)
    for a in range(0, K, chunk):
        b = min(a + chunk, K)
        if scale is not None:
            blk = (t3[a:b].astype(np.float32)
                   * scale[a:b, None]).astype(np.float64)
        else:
            blk = t3[a:b].astype(np.float64)
        ref32[a:b] = blk.mean(-1).astype(np.float32)
        d = blk - ref32[a:b].astype(np.float64)[:, None]
        s0[a:b] = blk.sum(-1)
        s1[a:b] = blk @ idx
        q[a:b] = (d * d).sum(-1)

    def pair(x64):
        hi = x64.astype(np.float32)
        lo = (x64 - hi.astype(np.float64)).astype(np.float32)
        return f32(hi, device), f32(lo, device)

    return StreamMoments(*pair(s0), *pair(s1), *pair(q), f32(ref32, device))


# ---------------------------------------------------------------------------
# plain PyTorch version: the reference's tile math, op for op.
# ---------------------------------------------------------------------------

def _cadd(s, c, x):
    """One Neumaier-compensated add: ``(s, c) += x``."""
    t = s + x
    c = c + torch.where(s.abs() >= x.abs(), (s - t) + x, (x - t) + s)
    return t, c


def _update_tile(s0, s0c, s1, s1c, q, qc, ref, y_new, y_old, y_first, y_last,
                 length, evict: bool, scale=None):
    """The fused rank-1 update and Eq. 3 derivation (elementwise).

    ``length`` (a float32 0-dim tensor on the operands' device) is the
    window length after the append; ``evict`` gates the subtraction terms
    (a gated addend of exactly 0.0 leaves the compensated sums unchanged, so
    grow and slide share one op sequence).  S1 is updated first, from the
    pre-update S0 pair.  With ``scale`` the four columns are int8 codes,
    decoded ``code * scale`` first.
    """
    if scale is not None:
        deq = lambda y: y.to(torch.float32) * scale  # noqa: E731
        y_new, y_old = deq(y_new), deq(y_old)
        y_first, y_last = deq(y_first), deq(y_last)
    zero = torch.zeros_like(y_new)
    gate = lambda x: x if evict else zero  # noqa: E731
    s0_pre, s0c_pre = s0, s0c
    s1, s1c = _cadd(s1, s1c, (length - 1.0) * y_new)
    s1, s1c = _cadd(s1, s1c, gate(y_old))
    s1, s1c = _cadd(s1, s1c, gate(-s0_pre))
    s1, s1c = _cadd(s1, s1c, gate(-s0c_pre))
    s0, s0c = _cadd(s0, s0c, y_new)
    s0, s0c = _cadd(s0, s0c, gate(-y_old))
    d_new = y_new - ref
    d_old = y_old - ref
    q, qc = _cadd(q, qc, d_new * d_new)
    q, qc = _cadd(q, qc, gate(-(d_old * d_old)))
    stats = scoring.stats_from_moments(
        s0 + s0c, s1 + s1c, q + qc, y_first, y_last, length, ref)
    return StreamMoments(s0, s0c, s1, s1c, q, qc, ref), stats


def _stats_update_torch(moments, cols, length, evict, scale):
    L = f32(length, moments.s0.device)
    return _update_tile(*moments, *cols, L, evict, scale)


# ---------------------------------------------------------------------------
# CUDA kernel B3.
# ---------------------------------------------------------------------------

def _stats_update_cuda(moments, cols, length, evict, scale):
    K = moments.s0.shape[0]
    dev = moments.s0.device
    # one buffer for the nine outputs: rows 0-5 the new moment halves, 6-8
    # (area, slope, std).  Fresh every tick, so statistics a snapshot holds
    # are never overwritten by a later tick.
    out = torch.empty((9, K), dtype=torch.float32, device=dev)
    lib = _build.library("stats_update", {"stats_update_launch": (13, 3, 1)})
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.stats_update_launch(
            *(ptr(m) for m in moments), *(ptr(c) for c in cols), ptr(scale),
            ptr(out), K, int(evict), int(scale is not None), float(length),
            stream), "stats_update_launch")
    stats_update.launches += 1
    return (StreamMoments(*out[:6], moments.ref),
            scoring.CandidateStats(*out[6:]))


def stats_update(moments: StreamMoments, y_new, y_old, y_first, y_last,
                 length, evict, *, scale=None, backend: str | None = None):
    """One collector tick: rank-1-update the moments, derive the statistics.

    Parameters
    ----------
    moments : StreamMoments
        Compensated accumulators of the window before this tick; their
        device is where the tick runs.
    y_new, y_old : (K,)
        The appended column, and the evicted one (ignored when ``evict`` is
        False: pass anything finite of the right shape).
    y_first, y_last : (K,)
        First (oldest) and last column of the window after the tick.
    length : number
        Window length after the tick.
    evict : bool
        Whether the window was full (slide) or still growing (append only).
    scale : (K,) float32, optional
        The int8 tier: the four columns are stored int8 codes, decoded
        ``code * scale`` inside the update.  bf16 columns take the
        ``scale=None`` path after an exact cast to float32.

    Returns ``(new_moments, CandidateStats)``, new tensors (the inputs are
    not written).  CPU tensors take the plain PyTorch version, CUDA tensors
    launch kernel B3 (or raise); ``backend="torch"`` forces the plain
    version.  Pinned to float32 like the scoring path.
    """
    dev = moments.s0.device
    moments = StreamMoments(*(f32(m, dev) for m in moments))
    K = moments.s0.shape[0]
    if K < 1:
        raise ValueError("stats_update needs K >= 1")
    cols = (y_new, y_old, y_first, y_last)
    if scale is None:
        cols = tuple(f32(y, dev) for y in cols)
        col_dtype = (torch.float32,)
    else:
        cols = tuple((y if isinstance(y, torch.Tensor)
                      else torch.from_numpy(np.ascontiguousarray(y))).to(dev)
                     for y in cols)
        scale = f32(scale, dev)
        col_dtype = (torch.int8,)
        _build.expect(scale, "scale", (K,), (torch.float32,), dev)
    for name, m in zip(StreamMoments._fields, moments):
        _build.expect(m, name, (K,), (torch.float32,), dev)
    for name, y in zip(("y_new", "y_old", "y_first", "y_last"), cols):
        _build.expect(y, name, (K,), col_dtype, dev)
    length, evict = float(length), bool(evict)
    if _build.route(backend, dev) == "cuda":
        return _stats_update_cuda(moments, cols, length, evict, scale)
    return _stats_update_torch(moments, cols, length, evict, scale)


#: kernel launches by :func:`stats_update` (one per call that ran it)
stats_update.launches = 0
