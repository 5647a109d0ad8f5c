"""Archive storage tiers and int8 gradient compression.

PyTorch counterpart of ``repro.parallel.compression``.  Its first half
is the archive storage tiers: float32, bfloat16 and int8 with a float32
scale.  A (K, T) T3 window can be held as int8 codes with one float32
scale per candidate (or as bfloat16, scale-free), cutting resident window
bytes about 4x (2x for bf16).  The per-candidate scale is the
quantisation step: a stored sample differs from its float32 source by at
most ``scale / 2`` while it stays inside the clip range ``[-127 * scale,
127 * scale]``; the rolling archives count clipped samples instead of
hiding them.

The op sequence per sample is the reference's: a float32 divide by a
float32 tensor (never by a Python scalar, which PyTorch turns into a
reciprocal multiply on the card), ``torch.round`` (half to even, like
``jnp.round``), a clip, a cast.  bf16 is PyTorch's own ``bfloat16``, which
rounds to nearest even as ``ml_dtypes`` does, so both packages store the
same codes.

Its second half is the int8 gradient exchange of spot-elastic training
(:mod:`repro_torch.elastic`): :func:`quantize` with one float32 scale a
tensor, :class:`ErrorFeedback` carrying each worker's rounding error into
its next round, and :func:`allreduce_compressed` / :func:`allreduce_exact`,
which mean-reduce the workers' gradient trees (walked in JAX's leaf order,
``_tree.tree_flatten``) and count the bytes the exchange puts on the
wire.  The reduction is process-local, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .._tree import tree_flatten

#: Storage dtypes an archive window can be held in.  "float32" is the exact
#: baseline; "bfloat16" halves window bytes (scale-free — dequantisation is
#: a cast); "int8" quarters them with a per-candidate float32 scale.
ARCHIVE_PRECISIONS = ("float32", "bfloat16", "int8")

#: bf16 keeps 8 significand bits, so rounding to nearest puts a stored
#: sample within ``|y| * 2**-8`` of its float32 source; as a per-candidate
#: "step" (``maxabs * 2**-7``) the bf16 tier shares int8's ``step / 2``
#: error contract.
BF16_RELATIVE_STEP = 2.0 ** -7

#: Host-side chunk (rows) for staging-time passes over a (K, T) window, so
#: seeding a large archive never materialises a second full-window copy.
STAGE_CHUNK = 65536

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


def resolve_precision(precision: str) -> str:
    """Validate an ``archive_precision`` knob value."""
    if precision not in ARCHIVE_PRECISIONS:
        raise ValueError(
            f"archive precision must be one of {ARCHIVE_PRECISIONS}, "
            f"got {precision!r}")
    return precision


def storage_dtype(precision: str) -> torch.dtype:
    """The torch storage dtype of an archive tier."""
    return _DTYPES[resolve_precision(precision)]


def candidate_scales(window, precision: str, *, headroom: float = 1.0,
                     chunk: int = STAGE_CHUNK) -> np.ndarray:
    """Per-candidate quantisation step of a host (K, T) window, float32.

    ``int8``: ``maxabs * headroom / 127`` (``headroom > 1`` buys clip
    slack for live columns beyond the seed's range); ``bfloat16``:
    ``maxabs * headroom * BF16_RELATIVE_STEP``, used only for byte
    accounting and error bounds; ``float32``: zeros.  Host numpy, as in the
    reference, so both packages derive the same scale bits.
    """
    resolve_precision(precision)
    if headroom < 1.0:
        raise ValueError(f"headroom must be >= 1.0, got {headroom}")
    window = np.asarray(window)
    K = window.shape[0]
    if precision == "float32":
        return np.zeros(K, np.float32)
    maxabs = np.empty(K, np.float32)
    for a in range(0, K, chunk):
        b = min(a + chunk, K)
        maxabs[a:b] = np.abs(window[a:b]).max(axis=-1).astype(np.float32)
    step = BF16_RELATIVE_STEP if precision == "bfloat16" else 1.0 / 127.0
    return np.maximum(maxabs * np.float32(headroom), np.float32(1e-12)) \
        .astype(np.float32) * np.float32(step)


def quantize_window(window, scale, precision: str, *,
                    chunk: int = STAGE_CHUNK) -> torch.Tensor:
    """Encode a host (K, T) window at ``precision``: a CPU tensor of the
    tier's storage dtype, built chunk by chunk.

    Per sample the same ops as :func:`quantize_column` (float32 divide,
    round half to even, clip), so a staged window and a stream of appended
    columns land on identical codes.
    """
    resolve_precision(precision)
    window = np.asarray(window)
    if precision == "float32":
        return torch.from_numpy(window.astype(np.float32))
    out = torch.empty(window.shape, dtype=_DTYPES[precision])
    for a in range(0, window.shape[0], chunk):
        b = min(a + chunk, window.shape[0])
        blk = torch.from_numpy(np.asarray(window[a:b], np.float32))
        if precision == "bfloat16":
            out[a:b] = blk.to(torch.bfloat16)
        else:
            step = torch.from_numpy(np.asarray(scale[a:b], np.float32))
            out[a:b] = torch.clamp(torch.round(blk / step[:, None]),
                                   -127, 127).to(torch.int8)
    return out


def dequantize_window(q: torch.Tensor, scale, precision: str) -> torch.Tensor:
    """Stored window/ring content back to float32: ``code * scale`` per
    candidate row on the int8 tier, an exact cast otherwise.  One float32
    multiply, so host and device decodes agree bit for bit."""
    resolve_precision(precision)
    if precision == "int8":
        step = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
        return q.to(torch.float32) * step[:, None]
    return q.to(torch.float32)


def quantize_column(col: torch.Tensor, scale, precision: str):
    """Encode one (K,) tick column; returns ``(codes, n_clipped)``.

    ``n_clipped`` (an int32 tensor on the column's device) counts samples
    outside the int8 clip range, always 0 on the bf16 and float32 tiers:
    the error bound holds only for unclipped samples, so the archives
    surface the count instead of saturating silently.
    """
    resolve_precision(precision)
    col = col.to(torch.float32)
    zero = torch.zeros((), dtype=torch.int32, device=col.device)
    if precision == "bfloat16":
        return col.to(torch.bfloat16), zero
    if precision == "float32":
        return col, zero
    step = torch.as_tensor(scale, dtype=torch.float32, device=col.device)
    codes = torch.round(col / step)
    clipped = ((codes > 127) | (codes < -127)).sum().to(torch.int32)
    return torch.clamp(codes, -127, 127).to(torch.int8), clipped


# ---------------------------------------------------------------------------
# int8 gradient exchange with error feedback
# ---------------------------------------------------------------------------

def _f32(v: float, device) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=device)


def quantize(g: torch.Tensor, error: torch.Tensor | None = None):
    """Returns ``(q int8, scale float32, new_error float32)``: one scale
    for the tensor, ``max(|g + error|, 1e-12) / 127``, and the codes
    ``round(g / scale)`` (half to even) clipped to [-127, 127].  Both
    divisions are by float32 tensors on ``g``'s device, as the reference's
    are true divisions."""
    g32 = g.to(torch.float32)
    if error is not None:
        g32 = g32 + error.to(torch.float32)
    dev = g32.device
    scale = torch.maximum(g32.abs().max(), _f32(1e-12, dev)) / _f32(127.0, dev)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale, g32 - dequantize(q, scale)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * torch.as_tensor(scale, dtype=torch.float32,
                                                 device=q.device)


class ErrorFeedback:
    """Per-worker error-feedback state over a gradient tree: the float32
    error each leaf's last quantisation left, added to its next gradient."""

    def __init__(self):
        self._err: list | None = None

    @property
    def error(self):
        """The error leaves in JAX order (``None`` before the first round)."""
        return self._err

    def compress(self, grads):
        """``(codes tree, scales tree)`` of ``grads``, updating the error."""
        flat_g, rebuild = tree_flatten(grads)
        if self._err is None:
            self._err = [torch.zeros(g.shape, dtype=torch.float32,
                                     device=g.device) for g in flat_g]
        qs, scales, errs = [], [], []
        for g, e in zip(flat_g, self._err):
            q, s, ne = quantize(g, e)
            qs.append(q)
            scales.append(s)
            errs.append(ne)
        self._err = errs
        return rebuild(qs), rebuild(scales)


def _divide(total: list, n: int) -> list:
    """The reference's ``sum(xs) / n`` after the sums: a true division by
    ``n`` (a float32 tensor, never a reciprocal multiply)."""
    return [t / _f32(float(n), t.device) for t in total]


def _accumulate(total: list | None, leaves: list) -> list:
    """Add one worker's leaves to the running sums, left to right, as
    Python's ``sum`` adds the reference's list (``0 + x0`` is ``x0``)."""
    if total is None:
        return list(leaves)
    return [t + x for t, x in zip(total, leaves)]


def allreduce_compressed(worker_grads: list, feedbacks: list[ErrorFeedback]):
    """Mean-reduce gradients across workers on int8 payloads.

    ``worker_grads``: one gradient tree a worker (one layout).  Returns the
    dequantised float32 mean tree and the wire bytes exchanged: every int8
    code plus 4 bytes a scale, for every worker.  Each worker's payload is
    dequantised into a running sum as it arrives, which adds in the
    reference's order and holds one float32 tree instead of one a worker.
    """
    total, wire_bytes, rebuild = None, 0, None
    for grads, fb in zip(worker_grads, feedbacks):
        q, s = fb.compress(grads)
        flat_q, rebuild = tree_flatten(q)
        flat_s = tree_flatten(s)[0]
        wire_bytes += sum(x.numel() for x in flat_q)
        wire_bytes += 4 * len(flat_s)
        total = _accumulate(total, [dequantize(a, b)
                                    for a, b in zip(flat_q, flat_s)])
    return rebuild(_divide(total, len(worker_grads))), wire_bytes


def allreduce_exact(worker_grads: list):
    """Uncompressed reduction (float32 wire format), the baseline."""
    total, rebuild = None, None
    for grads in worker_grads:
        flat, rebuild = tree_flatten(grads)
        total = _accumulate(total, [x.to(torch.float32) for x in flat])
    wire = sum(4 * x.numel() for x in tree_flatten(worker_grads[0])[0])
    return rebuild(_divide(total, len(worker_grads))), wire * len(worker_grads)
