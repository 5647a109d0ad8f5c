"""Seeded inputs of a cell: the candidate catalog with its T3 window, and
the requests of every serve call.

Plain numpy, handed alike to the program (wrapped into its own types by
``harness``) and to the plain reference.  Everything is drawn from the
configuration file's layout and a generator seeded by ``--seed`` and a
fixed tag, so one seed gives the same inputs in every run, whatever the
timing:

- the catalog and the window from ``default_rng((seed, CATALOG_TAG))``;
- the requests of call ``i`` from ``default_rng((seed, REQUEST_TAG, i))``
  (of warm-up call ``i``, ``WARMUP_TAG``), by ``Mix.requests``.

The catalog's layout and prices follow the seed system's
``src/repro/cloudsim/catalog.py`` (``Catalog.pools`` and ``spot_price``),
with the layout's tables in the configuration file; the T3 samples lie on
the collector's probe grid (``core/usqs.py``: the largest probed node
count whose placement score is 3, or 0).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

CATALOG_TAG = 1
REQUEST_TAG = 2
WARMUP_TAG = 3           # warm-up calls: the mix's kinds, draws of their own
FILTERS = {"region": "regions", "az": "azs", "category": "categories",
           "family": "families"}


@dataclass
class Catalog:
    """K candidates, one a (type, AZ): string columns, float64 numbers and
    the (K, T) float32 window (oldest column first)."""

    names: np.ndarray
    regions: np.ndarray
    azs: np.ndarray
    families: np.ndarray
    categories: np.ndarray
    vcpus: np.ndarray
    memory_gb: np.ndarray
    prices: np.ndarray
    t3: np.ndarray

    def __len__(self) -> int:
        return len(self.names)

    def rows(self) -> dict:
        """``(type name, AZ) -> row``."""
        return {(n, z): i for i, (n, z) in enumerate(zip(self.names,
                                                         self.azs))}


def node_counts(config: dict) -> np.ndarray:
    """The collector's probed node counts (``t3_nodes``)."""
    g = config["t3_nodes"]
    return np.arange(g["min"], g["max"] + 1, g["step"])


def types(config: dict) -> list[tuple]:
    """``(name, family, category, vcpus, memory_gb, od_per_vcpu)`` of every
    instance type, in the catalog's order."""
    out = []
    for cat, spec in config["categories"].items():
        for fam in spec["families"]:
            for size, vcpus in config["sizes"].items():
                out.append((f"{fam}.{size}", fam, cat, float(vcpus),
                            vcpus * spec["gb_per_vcpu"], spec["od_per_vcpu"]))
    return out


def zones(config: dict) -> list[tuple[str, str]]:
    """``(region, AZ)`` of every zone, in the catalog's order."""
    return [(r, f"{r}{chr(ord('a') + i)}")
            for r, n in config["regions"].items() for i in range(n)]


def catalog(config: dict, seed: int) -> Catalog:
    """Every type in every zone, priced per (type, region), with a window of
    ``config["window"]`` T3 samples a candidate."""
    rng = np.random.default_rng((seed, CATALOG_TAG))
    tys, zs = types(config), zones(config)
    regions = list(config["regions"])
    n_t = len(tys)
    lo, hi = config["spot_discount"]
    discount = rng.uniform(lo, hi, (n_t, len(regions)))
    region_mult = 1.0 + config["region_price_spread"] * rng.random(
        len(regions))
    od = np.array([t[3] * t[5] for t in tys])
    price = od[:, None] * (1.0 - discount) * region_mult[None, :]
    r_of = np.array([regions.index(r) for r, _ in zs])
    col = lambda j: np.tile(np.array([t[j] for t in tys]), len(zs))  # noqa: E731
    K = n_t * len(zs)
    levels = np.concatenate([[0.0], node_counts(config)]).astype(np.float32)
    t3 = levels[rng.integers(0, len(levels), (K, config["window"]),
                             dtype=np.int8)]
    return Catalog(
        names=col(0), families=col(1), categories=col(2),
        vcpus=col(3).astype(np.float64), memory_gb=col(4).astype(np.float64),
        regions=np.repeat([r for r, _ in zs], n_t),
        azs=np.repeat([z for _, z in zs], n_t),
        prices=price[:, r_of].T.reshape(-1), t3=t3)


class Mix:
    """A traffic mix over one configuration's catalog, with the tables its
    requests are drawn from built once."""

    def __init__(self, config: dict, traffic: dict):
        self.config = config
        self.traffic = traffic
        self.nodes = node_counts(config)
        self.types = types(config)
        self.values = {"region": list(config["regions"]),
                       "az": [z for _, z in zones(config)],
                       "category": list(config["categories"]),
                       "family": [f for c in config["categories"].values()
                                  for f in c["families"]]}

    def requests(self, seed: int, call: int, *,
                 tag: int = REQUEST_TAG) -> list[dict]:
        """The requests of serve call ``call``: one of each kind of
        ``traffic["kinds"]`` in turn, ``traffic["requests_per_call"]`` of
        them.

        A request asks for the capacity of n nodes of one instance type of
        the catalog, n one of the collector's probed counts and the type
        drawn from the catalog, in vCPUs or GiB as its kind's ``axis``
        says, with the configuration's W and lambda.  Each name in its
        kind's ``filters`` (``region``, ``az``, ``category``, ``family``)
        restricts it to one value drawn from the catalog's; ``max_types``
        caps its pool.
        """
        rng = np.random.default_rng((seed, tag, call))
        kinds = self.traffic["kinds"]
        out = []
        for i in range(self.traffic["requests_per_call"]):
            kind = kinds[i % len(kinds)]
            n = float(self.nodes[rng.integers(len(self.nodes))])
            ty = self.types[int(rng.integers(len(self.types)))]
            req = dict(weight=self.config["weight"], lam=self.config["lam"])
            if kind["axis"] == "memory":
                req["memory_gb"] = n * ty[4]
            else:
                req["cpus"] = n * ty[3]
            for f in kind.get("filters", ()):
                pick = self.values[f]
                req[FILTERS[f]] = [pick[int(rng.integers(len(pick)))]]
            if kind.get("max_types") is not None:
                req["max_types"] = int(kind["max_types"])
            out.append(req)
        return out
