"""Request mixes for the load harness.

A mix is a deterministic sampler of :class:`~repro_torch.core.ResourceRequest`\\ s
drawn from a **discrete** signature space — discrete because real request
populations are: users ask for one of a few standard sizes with one of a few
filter presets, and that recurrence is precisely what makes the degraded
pool-cache tier (:class:`repro_torch.serve.PoolCache`) meaningful.  A mix sampling
continuous amounts would have unique signatures, an always-cold memo, and an
unshed-able queue — a worst case worth testing, but not the default.

Two mixes anchor the benchmark matrix:

- :func:`filterless_mix` — no filters at all.  Every request in a batch
  shares the all-true mask, so the engine's mask-dedup collapses the Eq. 3
  extrema scans to **one** per batch: the scoring fast path.
- :func:`distinct_mask_mix` — cycles deterministically through ``n`` filter
  presets built from the catalog's actual (region, family, category, az)
  values, so consecutive requests carry **distinct** masks.  With ``n`` at
  least the largest serve bucket, every batch pays one extrema scan per
  row: the mask-dedup worst case from the streaming-scoring kernel's
  benchmark, now under arrival-driven batching.

Filter presets are validated non-empty against the candidate set at mix
construction — the engine's empty-filter contract raises per batch row, and
a load test that trips it would measure the exception path, not serving.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

from ..core.types import CandidateSet, ResourceRequest

#: discrete request sizes (vCPUs or GiB) — standard shapes, so signatures recur
DEFAULT_AMOUNTS = (16.0, 64.0, 128.0, 256.0)
#: discrete Eq. 4 weights users actually pick (cost-lean / balanced / avail-lean)
DEFAULT_WEIGHTS = (0.3, 0.5, 0.7)


@dataclass
class RequestMix:
    """A named sampler over a finite population of request shapes.

    ``filters`` is a sequence of kwargs-dicts (possibly ``[{}]`` for the
    filterless mix); ``cycle_filters=True`` walks them round-robin so a
    window of ``len(filters)`` consecutive samples is guaranteed
    all-distinct (the dedup worst case needs the guarantee — iid sampling
    would collide ~37% of the time at batch size == population size).
    Amounts/weights/capacity-axis are drawn iid from their discrete sets.
    """

    name: str
    filters: list
    amounts: tuple = DEFAULT_AMOUNTS
    weights: tuple = DEFAULT_WEIGHTS
    lam: float = 0.1
    cpu_fraction: float = 0.5       # P(request is vCPU-denominated)
    cycle_filters: bool = False
    _cycle: "itertools.cycle" = field(init=False, repr=False, default=None)

    def __post_init__(self):
        if not self.filters:
            raise ValueError("need at least one filter preset")
        if self.cycle_filters:
            self._cycle = itertools.cycle(self.filters)

    @property
    def n_signatures(self) -> int:
        return (len(self.filters) * len(self.amounts) * len(self.weights)
                * (2 if 0.0 < self.cpu_fraction < 1.0 else 1))

    def sample(self, rng: np.random.Generator) -> ResourceRequest:
        if self.cycle_filters:
            filt = next(self._cycle)
        else:
            filt = self.filters[int(rng.integers(len(self.filters)))]
        amount = float(self.amounts[int(rng.integers(len(self.amounts)))])
        weight = float(self.weights[int(rng.integers(len(self.weights)))])
        axis = ({"cpus": amount} if rng.random() < self.cpu_fraction
                else {"memory_gb": amount})
        return ResourceRequest(weight=weight, lam=self.lam, **axis, **filt)


def filterless_mix(**kw) -> RequestMix:
    """The mask-dedup fast path: every request keeps all K candidates."""
    return RequestMix(name="filterless", filters=[{}], **kw)


def distinct_mask_mix(cands: CandidateSet, n_filters: int = 64,
                      seed: int = 0, **kw) -> RequestMix:
    """The mask-dedup worst case: consecutive requests, distinct masks.

    Builds up to ``n_filters`` presets from the catalog's real value
    combinations — single-column filters first (every region, family,
    category, az), then two-column products — keeping only presets whose
    mask is non-empty and dropping duplicates *by mask* (two presets
    selecting the same candidate rows would dedup inside the engine and
    quietly soften the worst case this mix exists to exercise).
    """
    cols = {
        "regions": np.unique(cands.regions),
        "families": np.unique(cands.families),
        "categories": np.unique(cands.categories),
        "azs": np.unique(cands.azs),
    }
    presets: list[dict] = []
    seen_masks: set = set()

    def _try(preset: dict) -> None:
        if len(presets) >= n_filters:
            return
        mask = ResourceRequest(cpus=1.0, **preset).filter_mask(cands)
        if not mask.any():
            return
        fp = mask.tobytes()
        if fp in seen_masks:
            return
        seen_masks.add(fp)
        presets.append(preset)

    for key, values in cols.items():
        for v in values:
            _try({key: [str(v)]})
    pairs = [("regions", "families"), ("regions", "categories"),
             ("families", "azs"), ("categories", "azs"),
             ("regions", "azs"), ("families", "categories")]
    for a, b in pairs:
        for va in cols[a]:
            for vb in cols[b]:
                _try({a: [str(va)], b: [str(vb)]})
    if not presets:
        raise ValueError("catalog yielded no non-empty filter presets")
    rng = np.random.default_rng(seed)
    rng.shuffle(presets)
    return RequestMix(name="distinct-mask", filters=presets,
                      cycle_filters=True, **kw)


def mixed_mix(cands: CandidateSet, n_filters: int = 16, seed: int = 0,
              filtered_fraction: float = 0.5, **kw) -> RequestMix:
    """A blended population: some filterless traffic, some filtered.

    The general-case mix for tests and demos — per-batch mask dedup lands
    between the two extremes, like production traffic would.
    """
    base = distinct_mask_mix(cands, n_filters=n_filters, seed=seed)
    n_plain = max(1, int(round(len(base.filters) * (1 - filtered_fraction)
                               / max(filtered_fraction, 1e-9))))
    return RequestMix(name="mixed", filters=base.filters + [{}] * n_plain,
                      **kw)
