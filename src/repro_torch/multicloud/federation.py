"""Cross-vendor market federation: one operator surface over many regions.

The closed-loop operator (:mod:`repro_torch.operator`) drives exactly one narrow
market surface — ``now`` / ``catalog`` / ``request_spot`` / ``terminate``
/ ``node`` / ``advance`` / ``reclaim`` / ``events_since`` — and the CMDB
reads node truth through ``market.node(id).alive``.  This module gives a
multi-vendor world that same surface:

- :class:`MergedCatalog` routes catalog lookups by *region* to the owning
  region world (region names are globally unique across vendor profiles)
  and answers ``get(name)`` from any world that lists the type — instance
  definitions are identical across regions of one vendor, and family names
  never collide across vendors.
- :class:`MarketFederation` routes spot requests / reclaims by region,
  remaps per-market node ids into one federated id space (the CMDB must
  never confuse azure node 7 with gcp node 7), and advances every region
  market in lockstep so ``now`` stays a single clock.

Nothing here re-implements market dynamics: every capacity trace,
interruption, and missing response is produced by the underlying
per-region :class:`~repro_torch.cloudsim.market.SpotMarket` processes.
"""
from __future__ import annotations

import numpy as np

from ..cloudsim.market import NodeRecord


class MergedCatalog:
    """Catalog facade over the per-region catalogs of many vendors."""

    def __init__(self, worlds):
        self.worlds = list(worlds)
        self._by_region = {}
        for w in self.worlds:
            for r in w.catalog.regions:
                if r in self._by_region:
                    raise ValueError(
                        f"region {r!r} appears in more than one world — "
                        f"region names must be globally unique")
                self._by_region[r] = w

    @property
    def regions(self) -> dict[str, int]:
        return {r: w.catalog.regions[r] for r, w in self._by_region.items()}

    def _world(self, region: str):
        try:
            return self._by_region[region]
        except KeyError:
            raise KeyError(f"no federated world owns region {region!r}"
                           ) from None

    def get(self, name: str):
        for w in self.worlds:
            it = w.catalog._by_name.get(name)
            if it is not None:
                return it
        raise KeyError(f"no federated catalog lists instance type {name!r}")

    def azs(self, region: str) -> list[str]:
        return self._world(region).catalog.azs(region)

    def utc_offset(self, region: str) -> float:
        return self._world(region).catalog.utc_offset(region)

    def spot_price(self, type_name: str, region: str) -> float:
        return self._world(region).catalog.spot_price(type_name, region)

    def on_demand_price(self, type_name: str, region: str) -> float:
        return self._world(region).catalog.on_demand_price(type_name, region)

    def pools(self):
        out = []
        for w in self.worlds:
            out.extend(w.catalog.pools())
        return out


class MarketFederation:
    """The operator-facing spot-market surface over many region markets.

    Node ids returned by :meth:`request_spot` are *federated*: index into
    one shared table of ``(region market, local NodeRecord)`` pairs.
    :meth:`node` hands back the underlying live record (the CMDB only
    reads ``alive`` / ``end_t`` / ``reason``), so market truth needs no
    mirroring — a reclaim inside any region world is visible through the
    federation the instant it happens.
    """

    def __init__(self, worlds):
        if not worlds:
            raise ValueError("federation needs at least one region world")
        self.worlds = list(worlds)
        self.catalog = MergedCatalog(self.worlds)
        self._by_region = self.catalog._by_region
        self.now = 0.0
        self._records: list[NodeRecord] = []       # fed id -> record
        self._markets: list = []                   # fed id -> owning market
        #: append-only federated interruption log (events_since contract);
        #: fed by :meth:`advance` and :meth:`reclaim`, which are the only
        #: paths that move any federated market's state
        self.interruptions: list[NodeRecord] = []

    def _market(self, region: str):
        return self._by_region[region].market

    # -- vendor APIs -------------------------------------------------------

    def sps(self, type_name, region, az, n, *, t=None):
        return self._market(region).sps(type_name, region, az, n, t=t)

    def t3_true(self, type_name, region, az, **kw):
        return self._market(region).t3_true(type_name, region, az, **kw)

    def interruption_free_score(self, type_name, region, **kw):
        return self._market(region).interruption_free_score(
            type_name, region, **kw)

    def request_spot(self, type_name, region, az, n, *,
                     launch: bool = True):
        market = self._market(region)
        ok, local_ids = market.request_spot(type_name, region, az, n,
                                            launch=launch)
        if not ok or not launch:
            return ok, []
        fed_ids = []
        for lid in local_ids:
            fed_ids.append(len(self._records))
            self._records.append(market.node(lid))
            self._markets.append(market)
        return ok, fed_ids

    def terminate(self, node_ids) -> None:
        for fid in node_ids:
            rec = self._records[fid]
            self._markets[fid].terminate([rec.node_id])

    def node(self, node_id: int) -> NodeRecord:
        return self._records[node_id]

    # -- time + interruptions ---------------------------------------------

    def advance(self, to_t: float, check_every: float = 5.0):
        """Advance every region market to ``to_t`` (one shared clock)."""
        events = []
        for w in self.worlds:
            events.extend(w.market.advance(to_t, check_every))
        self.now = to_t
        self.interruptions.extend(events)
        return events

    def reclaim(self, type_name, region, az, n):
        events = self._market(region).reclaim(type_name, region, az, n)
        self.interruptions.extend(events)
        return events

    def events_since(self, cursor: int):
        return self.interruptions[cursor:], len(self.interruptions)

    # -- debug/metrics surface --------------------------------------------

    def free(self, type_name, region, az, *, t=None) -> float:
        m = self._market(region)
        idx = np.array([m.pool_index[(type_name, region, az)]])
        return float(m.free(self.now if t is None else t, idx)[0])

    @property
    def records(self) -> list[NodeRecord]:
        return self._records
