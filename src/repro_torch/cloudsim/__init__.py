"""Spot-market simulator substrate standing in for the vendor cloud APIs.

A copy of ``repro.cloudsim``: the catalog, the market, the probes and the
collector are the reference's numpy code (every draw and archive bit-equal
to it); the rate-limited SPS service routes every query as the reference
does through a quota book whose cost does not grow with the accounts.
"""
from .catalog import Catalog, InstanceType, CATEGORIES, SIZES, DEFAULT_REGIONS  # noqa: F401
from .market import SpotMarket, SPS_CAP, MINUTES_PER_DAY, MINUTES_PER_WEEK  # noqa: F401
from .sps import SPSQueryService, QueryLimitExceeded  # noqa: F401
from .probes import probe_real_availability, run_interruption_experiment, LifetimeData  # noqa: F401
from .collector import DataCollector, CollectorConfig  # noqa: F401
