"""Vendor profiles: per-vendor catalogs, regions, markets, signal shapes.

SpotLake documents how differently the three big clouds expose spot
availability: AWS publishes 1-9 placement scores (SPS) behind a hard
distinct-scenario quota; Azure publishes coarse eviction-rate bands and
sometimes simply fails to answer; GCP publishes preemption statistics with
no per-query limit worth modelling.  A :class:`VendorProfile` bundles
everything one vendor contributes to a scenario — its instance-family
tables, its region geography (with UTC offsets for the local-nighttime
capacity peak), its market process profile, its raw signal shape, and its
per-region probe limits — and :func:`build_region` turns (vendor, region,
seed) into a self-contained ``(Catalog, SpotMarket)`` world whose every
deterministic draw is salted by the vendor tag, so no two regions replay
the same trace.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from types import MappingProxyType

from ..cloudsim.catalog import CATEGORIES, Catalog, DEFAULT_REGIONS, \
    REGION_UTC_OFFSET
from ..cloudsim.market import SpotMarket

# Azure-like offering: Dsv5/Fsv2/Esv5/NCasT4 family shapes, slightly richer
# memory pricing, leaner accelerated tier.
AZURE_CATEGORIES = {
    "general": {"families": ["Dsv5", "Dasv5", "Dv4"], "gb_per_vcpu": 4.0,
                "od_per_vcpu": 0.050},
    "compute": {"families": ["Fsv2", "FXmds"], "gb_per_vcpu": 2.0,
                "od_per_vcpu": 0.0435},
    "memory": {"families": ["Esv5", "Easv5", "Ev4"], "gb_per_vcpu": 8.0,
               "od_per_vcpu": 0.066},
    "accelerated": {"families": ["NCasT4", "NVadsA10"], "gb_per_vcpu": 4.0,
                    "od_per_vcpu": 0.14},
}

AZURE_REGIONS = {
    "eastus": 3, "eastus2": 3, "westus2": 3, "centralus": 2,
    "westeurope": 3, "northeurope": 2, "uksouth": 2, "francecentral": 2,
    "southeastasia": 2, "japaneast": 2, "australiaeast": 3, "brazilsouth": 2,
}

AZURE_UTC_OFFSET = {
    "eastus": -5, "eastus2": -5, "westus2": -8, "centralus": -6,
    "westeurope": 1, "northeurope": 0, "uksouth": 0, "francecentral": 1,
    "southeastasia": 8, "japaneast": 9, "australiaeast": 10,
    "brazilsouth": -3,
}

# GCP-like offering: n2/c2/m1/a2 family shapes.
GCP_CATEGORIES = {
    "general": {"families": ["n2", "n2d", "e2", "t2d"], "gb_per_vcpu": 4.0,
                "od_per_vcpu": 0.044},
    "compute": {"families": ["c2", "c2d", "c3"], "gb_per_vcpu": 2.0,
                "od_per_vcpu": 0.041},
    "memory": {"families": ["m1", "m2"], "gb_per_vcpu": 8.0,
               "od_per_vcpu": 0.060},
    "accelerated": {"families": ["g2", "a2"], "gb_per_vcpu": 4.0,
                    "od_per_vcpu": 0.12},
}

GCP_REGIONS = {
    "us-central1": 4, "us-east1": 3, "us-west1": 3, "europe-west1": 3,
    "europe-west4": 3, "asia-east1": 3, "asia-northeast1": 2,
    "australia-southeast1": 2, "southamerica-east1": 2,
}

GCP_UTC_OFFSET = {
    "us-central1": -6, "us-east1": -5, "us-west1": -8, "europe-west1": 1,
    "europe-west4": 1, "asia-east1": 8, "asia-northeast1": 9,
    "australia-southeast1": 10, "southamerica-east1": -3,
}


@dataclass(frozen=True)
class VendorProfile:
    """Everything one vendor contributes to a multicloud scenario.

    ``signal`` names the raw availability-signal shape the vendor's
    :mod:`adapter <repro_torch.multicloud.adapters>` consumes: ``"sps"`` (AWS
    1-9 placement scores), ``"eviction"`` (Azure 0-4 eviction-rate bands
    with missing responses), ``"preemption"`` (GCP preemption fractions).
    ``region_query_limit`` is the per-region distinct-scenario/24h cap the
    probe scheduler must respect (``None`` = account quota only).
    """

    name: str
    market_profile: str            # SpotMarket capacity-process profile
    signal: str                    # "sps" | "eviction" | "preemption"
    categories: MappingProxyType = field(repr=False)
    regions: MappingProxyType = field(repr=False)
    utc_offsets: MappingProxyType = field(repr=False)
    region_query_limit: int | None = None

    def region_names(self, n: int | None = None) -> list[str]:
        names = list(self.regions)
        return names if n is None else names[:n]


VENDORS: dict[str, VendorProfile] = {
    "aws": VendorProfile(
        name="aws", market_profile="aws", signal="sps",
        categories=MappingProxyType(CATEGORIES),
        regions=MappingProxyType(DEFAULT_REGIONS),
        utc_offsets=MappingProxyType(REGION_UTC_OFFSET),
        region_query_limit=None),        # AWS limits per account, not region
    "azure": VendorProfile(
        name="azure", market_profile="azure", signal="eviction",
        categories=MappingProxyType(AZURE_CATEGORIES),
        regions=MappingProxyType(AZURE_REGIONS),
        utc_offsets=MappingProxyType(AZURE_UTC_OFFSET),
        region_query_limit=200),
    "gcp": VendorProfile(
        name="gcp", market_profile="gcp", signal="preemption",
        categories=MappingProxyType(GCP_CATEGORIES),
        regions=MappingProxyType(GCP_REGIONS),
        utc_offsets=MappingProxyType(GCP_UTC_OFFSET),
        region_query_limit=400),
}


def get_vendor(vendor: str | VendorProfile) -> VendorProfile:
    if isinstance(vendor, VendorProfile):
        return vendor
    try:
        return VENDORS[vendor]
    except KeyError:
        raise KeyError(
            f"unknown vendor {vendor!r}; registered: {sorted(VENDORS)}"
        ) from None


def build_region(vendor: str | VendorProfile, region: str,
                 seed: int = 0) -> tuple[Catalog, SpotMarket]:
    """One self-contained (Catalog, SpotMarket) world for (vendor, region).

    Seeding derives from ``(seed, vendor, region)``: the vendor tag salts
    every catalog price draw and market process parameter, and the region
    name reaches every per-pool hash through its AZ strings — so two
    regions built from structurally identical configs (same AZ count, same
    families) still replay distinct capacity traces, and the same
    ``(vendor, region, seed)`` triple always replays the same one.
    """
    vp = get_vendor(vendor)
    if region not in vp.regions:
        raise KeyError(f"{vp.name} has no region {region!r}; "
                       f"known: {sorted(vp.regions)}")
    catalog = Catalog(
        seed=seed, regions={region: vp.regions[region]}, vendor=vp.name,
        categories=dict(vp.categories), utc_offsets=dict(vp.utc_offsets))
    market = SpotMarket(catalog, seed=seed, profile=vp.market_profile,
                        vendor=vp.name)
    return catalog, market
