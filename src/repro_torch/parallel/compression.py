"""Archive storage tiers (the validation half of the reference module).

Only the float32 tier is staged in this slice; the quantized tiers
("bfloat16", "int8") are validated here so ``EngineConfig`` accepts the same
values as the reference, and staging them raises ``NotImplementedError``
until the live-ingest slice ports the quantisation machinery.
"""
from __future__ import annotations

#: Storage dtypes an archive window can be held in.  "float32" is the exact
#: baseline; "bfloat16" halves window bytes (scale-free — dequantisation is
#: a cast); "int8" quarters them with a per-candidate float32 scale.
ARCHIVE_PRECISIONS = ("float32", "bfloat16", "int8")


def resolve_precision(precision: str) -> str:
    """Validate an ``archive_precision`` knob value."""
    if precision not in ARCHIVE_PRECISIONS:
        raise ValueError(
            f"archive precision must be one of {ARCHIVE_PRECISIONS}, "
            f"got {precision!r}")
    return precision
