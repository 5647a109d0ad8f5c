"""Archive storage tiers: float32, bfloat16 and int8 with a float32 scale.

PyTorch counterpart of the archive-tier half of
``repro.parallel.compression``.  A (K, T) T3 window can be held as int8
codes with one float32 scale per candidate (or as bfloat16, scale-free),
cutting resident window bytes about 4x (2x for bf16).  The per-candidate
scale is the quantisation step: a stored sample differs from its float32
source by at most ``scale / 2`` while it stays inside the clip range
``[-127 * scale, 127 * scale]``; the rolling archives count clipped
samples instead of hiding them.

The op sequence per sample is the reference's: a float32 divide by a
float32 tensor (never by a Python scalar, which PyTorch turns into a
reciprocal multiply on the card), ``torch.round`` (half to even, like
``jnp.round``), a clip, a cast.  bf16 is PyTorch's own ``bfloat16``, which
rounds to nearest even as ``ml_dtypes`` does, so both packages store the
same codes.  The gradient-compression half of the reference module waits
for the LM stack.
"""
from __future__ import annotations

import numpy as np
import torch

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
