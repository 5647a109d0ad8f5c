"""One frozen configuration object for the whole serving stack.

PyTorch counterpart of ``repro.core.config``: the same fields, the same
validation, and builders that return the port's objects.  The device is not
a field: it is an explicit argument of the builders and constructors (CUDA
unless ``device="cpu"`` is asked for, see ``repro_torch._device``).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace

from ..parallel import compression
from . import pool as pool_lib
from . import scoring


class APIDeprecationWarning(DeprecationWarning):
    """Deprecated serving-API surface (shimmed per-knob keyword arguments).

    A distinct subclass so a test run can turn the port's deprecations into
    errors without tripping on unrelated ``DeprecationWarning``\\ s.
    """


@dataclass(frozen=True)
class EngineConfig:
    """Every tunable of the scoring/serving stack, in one frozen value.

    Parameters
    ----------
    pool_impl : str
        Algorithm 1 all-prefix scan: ``"dense"`` (O(K^2) allocation matrix),
        ``"tiled"`` (O(K) scan, the ``pool_scan`` kernel on the card), or
        ``"auto"`` (tiled from ``POOL_TILED_AUTO_K`` candidates up).
    score_impl : str
        Batched Eq. 2-4 scoring stage: ``"dense"`` re-reduces the (K, T)
        window every batch, ``"tiled"`` runs the fused masked scoring (the
        ``score_fuse`` kernel on the card) over cached per-candidate
        statistics, ``"auto"`` switches at ``SCORE_TILED_AUTO_K``.
    cache_capacity : int
        Entry count of the serve layer's staged-archive LRU.
    cache_max_bytes : int | None
        Optional device-byte budget for the same LRU (``None`` = uncapped).
    archive_precision : str
        Storage tier of staged and rolling T3 windows: ``"float32"`` (exact
        baseline), ``"bfloat16"`` (2x fewer window bytes) or ``"int8"`` (4x
        fewer, a per-candidate float32 scale).  A quantised tier moves each
        stored sample by at most half its per-candidate step;
        ``core.quantized`` turns that into the score-drift budget and the
        pool-parity contract.  The tier is part of every archive's cache key.
    archive_headroom : float
        int8 clip slack of the quantized tier (``>= 1.0``).

    Frozen, so a config can be shared across threads and layers; derive
    variants with :meth:`with_`.
    """

    pool_impl: str = "auto"
    score_impl: str = "auto"
    cache_capacity: int = 4
    cache_max_bytes: int | None = None
    archive_precision: str = "float32"
    archive_headroom: float = 1.0

    def __post_init__(self):
        if self.pool_impl not in pool_lib.POOL_IMPLS:
            raise ValueError(f"pool_impl must be one of {pool_lib.POOL_IMPLS}, "
                             f"got {self.pool_impl!r}")
        if self.score_impl not in scoring.SCORE_IMPLS:
            raise ValueError(f"score_impl must be one of {scoring.SCORE_IMPLS}, "
                             f"got {self.score_impl!r}")
        if self.cache_capacity < 1:
            raise ValueError("cache_capacity must be >= 1")
        if self.cache_max_bytes is not None and self.cache_max_bytes < 1:
            raise ValueError("cache_max_bytes must be >= 1")
        compression.resolve_precision(self.archive_precision)
        if self.archive_headroom < 1.0:
            raise ValueError("archive_headroom must be >= 1.0")

    def with_(self, **changes) -> "EngineConfig":
        """A copy with ``changes`` applied (validation re-runs)."""
        return replace(self, **changes)

    # -- factories (lazy imports: engine/serve import this module) --------

    def build_engine(self, *, device=None):
        """A :class:`~repro_torch.core.RecommendationEngine` on this config."""
        from .engine import RecommendationEngine
        return RecommendationEngine(config=self, device=device)

    def build_cache(self, *, device=None):
        """An :class:`~repro_torch.serve.ArchiveCache` on this config's
        budgets, staging misses at ``archive_precision`` /
        ``archive_headroom`` on ``device``."""
        from ..serve.archive import ArchiveCache
        return ArchiveCache(capacity=self.cache_capacity,
                            max_bytes=self.cache_max_bytes,
                            precision=self.archive_precision,
                            headroom=self.archive_headroom, device=device)

    def build_server(self, **kw):
        """A :class:`~repro_torch.serve.BatchServer` on this config.

        Extra keyword arguments (``bucket_sizes``, ``device``, a pre-built
        ``engine``) pass through to the constructor.
        """
        from ..serve.server import BatchServer
        return BatchServer(config=self, **kw)

    def build_ingestor(self, collector, *, window: int, **kw):
        """A :class:`~repro_torch.stream.LiveIngestor` on this config.

        The ingestor derives its archive cache and the ring's storage tier
        (``archive_precision`` / ``archive_headroom``) from this config;
        extra keyword arguments (``name``, ``device``, or an explicit shared
        ``cache``) pass through.
        """
        from ..stream.ingest import LiveIngestor
        if "cache" in kw:
            return LiveIngestor(collector, window=window,
                                precision=self.archive_precision,
                                headroom=self.archive_headroom, **kw)
        return LiveIngestor(collector, window=window, config=self, **kw)


def resolve_engine_config(config: EngineConfig | None,
                          *, stacklevel: int = 3,
                          **legacy) -> EngineConfig:
    """Merge a ``config`` argument with shimmed legacy kwargs.

    ``legacy`` holds the deprecated per-constructor kwargs (value ``None``
    means "not passed").  Passing any of them without a ``config`` warns
    with :class:`APIDeprecationWarning` and maps them onto a fresh
    :class:`EngineConfig`; passing both is an error (two sources of truth).
    """
    given = {k: v for k, v in legacy.items() if v is not None}
    if given:
        if config is not None:
            raise TypeError(
                "pass either config=EngineConfig(...) or the legacy kwargs "
                f"({', '.join(sorted(given))}), not both")
        args = ", ".join(f"{k}={v!r}" for k, v in sorted(given.items()))
        warnings.warn(
            f"the {', '.join(sorted(given))} keyword argument(s) are "
            f"deprecated; pass config=EngineConfig({args}) instead",
            APIDeprecationWarning, stacklevel=stacklevel)
        return EngineConfig(**given)
    return config if config is not None else EngineConfig()
