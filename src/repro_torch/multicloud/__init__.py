"""Multi-vendor, multi-region scenario engine.

Layers a vendor/region scenario world over :mod:`repro_torch.cloudsim`:

- :mod:`vendors <repro_torch.multicloud.vendors>`: per-vendor profiles (aws /
  azure / gcp) — family tables, region geography, market process, signal
  shape — and ``build_region`` turning (vendor, region, seed) into a
  self-contained, vendor-salted ``(Catalog, SpotMarket)`` world.
- :mod:`adapters <repro_torch.multicloud.adapters>`: normalizing signal adapters
  mapping each vendor's raw availability signal (1-9 placement scores,
  eviction bands with gaps, preemption fractions) onto the T3-like integer
  grid the engine already scores.
- :mod:`scenario <repro_torch.multicloud.scenario>`: the scenario engine —
  region-contiguous global target list, budget-aware probe scheduling
  (:class:`~repro_torch.core.usqs.BudgetedProbeScheduler`), an int8 host ring,
  and region-sharded serving via ``shard_bounds = region_bounds``.
- :mod:`federation <repro_torch.multicloud.federation>`: one operator-facing
  market surface over every region world (federated node ids, merged
  catalog, lockstep clock).
- :mod:`compare <repro_torch.multicloud.compare>`: the paper's §6.4
  SpotVista-vs-SpotFleet/SpotVerse availability/cost comparison, replayed
  through the chaos harness.

PyTorch counterpart of ``repro.multicloud``: vendors, adapters, federation
and collector are the reference's numpy code (every draw, column and id
bit-equal to it) over the port's ``cloudsim``.  Region-sharded serving
runs the port's K-sharded pipeline: on the card, kernel ``score_fuse``'s
phase 0 and its emit once a region shard, ``pool_scan`` once a batch and
``stats_update`` once a shard and tick.  ``build_ingestor``,
``replay_spotvista`` and ``compare_setup`` take ``device=`` (CUDA unless
``"cpu"``).
"""
from .adapters import (AwsSpsAdapter, AzureEvictionAdapter,
                       GcpPreemptionAdapter, SignalAdapter, adapter_for)
from .compare import (POLICIES, SETUPS, PolicyResult, budget_scaling,
                      compare_setup, replay_baseline, replay_spotvista)
from .federation import MarketFederation, MergedCatalog
from .scenario import (MultiCloudCollector, RegionWorld, ScenarioConfig,
                       ScenarioEngine)
from .vendors import VENDORS, VendorProfile, build_region, get_vendor

__all__ = [
    "AwsSpsAdapter",
    "AzureEvictionAdapter",
    "GcpPreemptionAdapter",
    "MarketFederation",
    "MergedCatalog",
    "MultiCloudCollector",
    "POLICIES",
    "PolicyResult",
    "RegionWorld",
    "SETUPS",
    "ScenarioConfig",
    "ScenarioEngine",
    "SignalAdapter",
    "VENDORS",
    "VendorProfile",
    "adapter_for",
    "budget_scaling",
    "build_region",
    "compare_setup",
    "get_vendor",
    "replay_baseline",
    "replay_spotvista",
]
