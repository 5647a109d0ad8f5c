"""Instance catalog: types, sizes, regions/AZs, spot prices.

Stands in for the vendor's offering catalog.  Deterministic given a seed, so
every experiment is reproducible.  Scale mirrors the paper's datasets
(~100-1000 instance types across up to 17 regions).

A copy of ``repro.cloudsim.catalog``: every draw is the reference's, bit
for bit.  The default tables (:data:`CATEGORIES`, :data:`DEFAULT_REGIONS`,
:data:`REGION_UTC_OFFSET`) model an AWS-like offering; a multi-vendor
scenario engine builds per-vendor catalogs by passing its own ``categories`` / ``regions`` / ``utc_offsets`` tables plus a
``vendor`` tag that salts every deterministic draw, so two vendors (or two
regions of one vendor) with structurally identical configs never share a
price or capacity trace.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

CATEGORIES = {
    "general": {"families": ["m5", "m5a", "m6i", "m7i", "t3"], "gb_per_vcpu": 4.0,
                "od_per_vcpu": 0.048},
    "compute": {"families": ["c5", "c5a", "c6i", "c7i"], "gb_per_vcpu": 2.0,
                "od_per_vcpu": 0.0425},
    "memory": {"families": ["r5", "r5a", "r6i", "r7i"], "gb_per_vcpu": 8.0,
               "od_per_vcpu": 0.063},
    "accelerated": {"families": ["g4dn", "g5", "p3"], "gb_per_vcpu": 4.0,
                    "od_per_vcpu": 0.13},
}

SIZES = {
    "large": 2, "xlarge": 4, "2xlarge": 8, "4xlarge": 16,
    "8xlarge": 32, "12xlarge": 48, "16xlarge": 64, "24xlarge": 96,
}

DEFAULT_REGIONS = {
    "us-east-1": 6, "us-west-2": 4, "eu-west-1": 3, "eu-west-2": 3,
    "ap-northeast-1": 4, "ap-northeast-2": 3, "ap-southeast-1": 3,
    "sa-east-1": 2, "ca-central-1": 2, "eu-central-1": 3, "us-east-2": 3,
    "ap-south-1": 3, "eu-north-1": 2, "ap-southeast-2": 3, "us-west-1": 2,
    "eu-west-3": 2, "me-south-1": 2,
}

# Rough UTC offset (hours) per region — drives the local-nighttime capacity peak.
REGION_UTC_OFFSET = {
    "us-east-1": -5, "us-east-2": -5, "us-west-1": -8, "us-west-2": -8,
    "ca-central-1": -5, "sa-east-1": -3, "eu-west-1": 0, "eu-west-2": 0,
    "eu-west-3": 1, "eu-central-1": 1, "eu-north-1": 1, "me-south-1": 3,
    "ap-south-1": 5.5, "ap-southeast-1": 8, "ap-northeast-1": 9,
    "ap-northeast-2": 9, "ap-southeast-2": 10,
}


def _stable_unit(key: str) -> float:
    """Deterministic uniform(0,1) from a string key (seed-stable hashing)."""
    h = hashlib.blake2b(key.encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") / 2.0 ** 64


@dataclass(frozen=True)
class InstanceType:
    name: str            # e.g. "m5.2xlarge"
    family: str          # "m5"
    category: str        # "general"
    size: str            # "2xlarge"
    vcpus: int
    memory_gb: float


class Catalog:
    """Deterministic instance catalog + spot pricing.

    ``vendor`` (optional) salts every deterministic draw — with it set, two
    catalogs that differ only in vendor produce distinct price fields.
    ``categories`` / ``utc_offsets`` override the AWS-like default tables so
    a vendor profile can bring its own family names and region geography;
    unknown regions fall back to UTC offset 0 as before.  All three default
    to the historical behaviour, so existing seeds reproduce bit-for-bit.
    """

    def __init__(self, seed: int = 0, regions: dict[str, int] | None = None,
                 n_regions: int | None = None, *, vendor: str | None = None,
                 categories: dict | None = None,
                 utc_offsets: dict[str, float] | None = None):
        self.seed = seed
        self.vendor = vendor
        self.categories = dict(categories) if categories is not None \
            else CATEGORIES
        self._offsets = dict(REGION_UTC_OFFSET)
        if utc_offsets is not None:
            self._offsets.update(utc_offsets)
        # every deterministic draw hashes through this salt; vendor=None
        # keeps the pre-multicloud key shape (and therefore every committed
        # benchmark trace) bit-identical
        self._salt = str(seed) if vendor is None else f"{seed}:{vendor}"
        regions = dict(regions or DEFAULT_REGIONS)
        if n_regions is not None:
            regions = dict(list(regions.items())[:n_regions])
        self.regions = regions
        self.types: list[InstanceType] = []
        for cat, spec in self.categories.items():
            for fam in spec["families"]:
                for size, vcpus in SIZES.items():
                    self.types.append(InstanceType(
                        name=f"{fam}.{size}", family=fam, category=cat,
                        size=size, vcpus=vcpus,
                        memory_gb=vcpus * spec["gb_per_vcpu"],
                    ))
        self._by_name = {t.name: t for t in self.types}

    def __len__(self) -> int:
        return len(self.types)

    def get(self, name: str) -> InstanceType:
        return self._by_name[name]

    def azs(self, region: str) -> list[str]:
        return [f"{region}{chr(ord('a') + i)}" for i in range(self.regions[region])]

    def utc_offset(self, region: str) -> float:
        """UTC offset (hours) driving the region's local-nighttime peak."""
        return self._offsets.get(region, 0)

    def pools(self) -> list[tuple[InstanceType, str, str]]:
        """All (type, region, az) capacity pools."""
        out = []
        for r in self.regions:
            for az in self.azs(r):
                for t in self.types:
                    out.append((t, r, az))
        return out

    def spot_price(self, type_name: str, region: str) -> float:
        """$/hr.  Spot = on-demand * (1 - discount), discount in [0.55, 0.88],
        deterministic per (vendor, type, region, seed).  Static over time,
        mirroring the post-2017 low-volatility pricing regime the paper
        describes."""
        t = self._by_name[type_name]
        od = self.categories[t.category]["od_per_vcpu"] * t.vcpus
        u = _stable_unit(f"price:{self._salt}:{type_name}:{region}")
        discount = 0.55 + 0.33 * u
        region_mult = 1.0 + 0.25 * _stable_unit(f"regionprice:{self._salt}:{region}")
        return od * (1.0 - discount) * region_mult

    def on_demand_price(self, type_name: str, region: str) -> float:
        t = self._by_name[type_name]
        od = self.categories[t.category]["od_per_vcpu"] * t.vcpus
        region_mult = 1.0 + 0.25 * _stable_unit(f"regionprice:{self._salt}:{region}")
        return od * region_mult
