"""Shared datatypes for the recommendation engine."""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np


@dataclass
class CandidateSet:
    """Flat arrays describing the candidate (instance type, region, az) space.

    `t3` is the (K, T) matrix of T3 time-series over the scoring window — the
    engine is agnostic to where it came from (live collector, object-store
    archive, or the cloudsim simulator).
    """

    names: np.ndarray        # (K,) str — instance type names
    regions: np.ndarray      # (K,) str
    azs: np.ndarray          # (K,) str
    families: np.ndarray     # (K,) str
    categories: np.ndarray   # (K,) str
    vcpus: np.ndarray        # (K,) float
    memory_gb: np.ndarray    # (K,) float
    prices: np.ndarray       # (K,) float — $/hr spot price
    t3: np.ndarray           # (K, T) float — T3 history, most recent last

    def __len__(self) -> int:
        return len(self.names)

    def take(self, idx) -> "CandidateSet":
        idx = np.asarray(idx)
        return CandidateSet(
            names=self.names[idx], regions=self.regions[idx], azs=self.azs[idx],
            families=self.families[idx], categories=self.categories[idx],
            vcpus=self.vcpus[idx], memory_gb=self.memory_gb[idx],
            prices=self.prices[idx], t3=self.t3[idx],
        )

    def fingerprint(self) -> str:
        """Content hash of the archive slice — the serve-layer cache key.

        Covers every array that feeds scoring or pool formation, so two
        slices with the same fingerprint are interchangeable on device.
        """
        h = hashlib.blake2b(digest_size=16)
        for a in (self.names, self.regions, self.azs, self.families,
                  self.categories, self.vcpus, self.memory_gb, self.prices,
                  self.t3):
            a = np.ascontiguousarray(a)
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        return h.hexdigest()


@dataclass
class ResourceRequest:
    """User-facing request (§4: R_C cores or R_M memory + optional filters)."""

    cpus: float | None = None
    memory_gb: float | None = None
    regions: list[str] | None = None
    azs: list[str] | None = None
    families: list[str] | None = None
    categories: list[str] | None = None
    types: list[str] | None = None
    weight: float = 0.5            # W in Eq. 4
    lam: float = 0.1               # lambda in Eq. 3
    max_types: int | None = None   # cap on returned pool diversity

    def __post_init__(self):
        if (self.cpus is None) == (self.memory_gb is None):
            raise ValueError("specify exactly one of cpus / memory_gb")

    @property
    def amount(self) -> float:
        return self.cpus if self.cpus is not None else self.memory_gb

    def capacity_of(self, cands: CandidateSet) -> np.ndarray:
        return cands.vcpus if self.cpus is not None else cands.memory_gb

    def signature(self) -> tuple:
        """Canonical hashable identity of everything that shapes the pool.

        Two requests with equal signatures are interchangeable to the
        engine: same filters, same capacity axis and amount, same Eq. 3/4
        parameters, same diversity cap.  Filter lists are order-insensitive
        (sorted) because ``filter_mask`` is a set-membership test.  This is
        the key of the admission layer's degraded "cached-pool" tier
        (:class:`repro_torch.serve.PoolCache`): under overload, a shed request is
        answered with the last pool computed for its exact signature.
        """
        norm = lambda v: None if v is None else tuple(sorted(v))  # noqa: E731
        return (self.cpus, self.memory_gb, norm(self.regions),
                norm(self.azs), norm(self.families), norm(self.categories),
                norm(self.types), self.weight, self.lam, self.max_types)

    def filter_mask(self, cands: CandidateSet) -> np.ndarray:
        """Boolean mask of candidates surviving this request's filters."""
        mask = np.ones(len(cands), bool)
        for values, col in (
            (self.regions, cands.regions), (self.azs, cands.azs),
            (self.families, cands.families), (self.categories, cands.categories),
            (self.types, cands.names),
        ):
            if values is not None:
                mask &= np.isin(col, np.asarray(values))
        return mask


@dataclass
class RequestBatch:
    """A padded, array-of-structs view of B requests over one candidate axis.

    This is the device-facing form the fused batched engine consumes: every
    per-request quantity is a (B,)- or (B, K)-shaped array so the whole batch
    runs as one pass of batched kernels.  ``pad_to`` rounds B up with inert
    dummy rows (all-true mask, amount 1) whose results are discarded — the
    serve layer uses this to snap batches onto its bucket ladder.
    """

    masks: np.ndarray      # (B, K) bool — per-request filter survivors
    use_cpus: np.ndarray   # (B,) bool — capacity axis: vcpus vs memory_gb
    weights: np.ndarray    # (B,) float32 — W in Eq. 4
    lams: np.ndarray       # (B,) float32 — lambda in Eq. 3
    amounts: np.ndarray    # (B,) float32 — R_C / R_M
    requests: list         # the n_valid original ResourceRequest objects
    n_valid: int           # rows beyond this are padding

    @classmethod
    def from_requests(cls, cands: CandidateSet, requests,
                      pad_to: int | None = None) -> "RequestBatch":
        requests = list(requests)
        n = len(requests)
        if n == 0:
            raise ValueError("empty request batch")
        B = max(pad_to, n) if pad_to is not None else n
        K = len(cands)
        masks = np.ones((B, K), bool)
        use_cpus = np.ones(B, bool)
        weights = np.full(B, 0.5, np.float32)
        lams = np.full(B, 0.1, np.float32)
        amounts = np.ones(B, np.float32)
        for b, req in enumerate(requests):
            mask = req.filter_mask(cands)
            if not mask.any():
                raise ValueError(
                    f"no candidates satisfy the request filters (batch row {b})")
            masks[b] = mask
            use_cpus[b] = req.cpus is not None
            weights[b] = req.weight
            lams[b] = req.lam
            amounts[b] = req.amount
        return cls(masks=masks, use_cpus=use_cpus, weights=weights, lams=lams,
                   amounts=amounts, requests=requests, n_valid=n)

    @property
    def batch_size(self) -> int:
        return self.masks.shape[0]


@dataclass
class Recommendation:
    """Engine output: the heterogeneous pool plus per-candidate diagnostics."""

    names: np.ndarray           # (M,) selected type names
    regions: np.ndarray
    azs: np.ndarray
    counts: np.ndarray          # (M,) node counts
    combined: np.ndarray        # (M,) S_i
    availability: np.ndarray    # (M,) AS_i
    cost: np.ndarray            # (M,) CS_i
    hourly_cost: float          # $/hr of the recommended pool
    diagnostics: dict = field(default_factory=dict)

    @property
    def num_types(self) -> int:
        return len(self.names)
