"""Rate-limited SPS query service (paper §3: 50 distinct scenarios / 24h / account).

Models the vendor-side constraint that makes USQS/TSTP necessary: each account
may register at most ``scenario_limit`` *distinct* query scenarios per rolling
24 hours, where a scenario is the full (type, region, az, node-count) tuple —
"queries for the same configuration with different node counts are treated as
separate requests".

Routing is ``repro.cloudsim.sps``'s: a query goes to the lowest-index account
that already holds its scenario in its window or has room for one more, and
raises :class:`QueryLimitExceeded` when there is none.  The reference finds
that account by rebuilding each account's window from the first one on, so a
query's cost grows with the accounts walked.  Here the windows are kept
incrementally (:class:`QuotaBook`): one time-ordered expiry queue for all
accounts, each account's in-window set and size, each scenario's holders,
and a heap of the accounts with room.  A query inspects a bounded number of
accounts, amortised, whatever the number of accounts or scenarios.  The
market's clock never runs backwards (``SpotMarket.advance`` moves it
forward), so expiring every window at once gives each window the reference's
contents at every query.
"""
from __future__ import annotations

import heapq
from collections import deque

from .market import SpotMarket, MINUTES_PER_DAY


class QueryLimitExceeded(RuntimeError):
    pass


class QuotaBook:
    """The accounts' rolling windows, kept incrementally.

    A scenario is filed in an account's window only while no account of a
    lower index holds it, so its holders, in filing order, have falling
    indices: the lowest is the newest (``_holders[key][-1]``), and the
    oldest expires first.  ``inspected`` counts the accounts a lookup
    examines (one holder, and each heap top tried), the cost the reference
    pays by walking the accounts from the first.
    """

    def __init__(self, n_accounts: int, limit: int):
        self.n_accounts = n_accounts
        self.limit = limit
        self._keys: list[set] = [set() for _ in range(n_accounts)]
        self._holders: dict = {}           # key -> deque of account indices
        self._expiry: deque = deque()      # (t, account, key), filing order
        self._room = list(range(n_accounts))   # heap; a sorted list is one
        self._in_room = [True] * n_accounts
        #: scenarios held in all windows together
        self.filed = 0
        #: accounts examined by :meth:`route` over its lifetime
        self.inspected = 0

    def expire(self, now: float) -> None:
        """Drop every filing made at or before ``now`` - 24 h."""
        while self._expiry and self._expiry[0][0] <= now - MINUTES_PER_DAY:
            _, acct, key = self._expiry.popleft()
            keys = self._keys[acct]
            keys.discard(key)
            holders = self._holders[key]
            holders.popleft()
            if not holders:
                del self._holders[key]
            self.filed -= 1
            if not self._in_room[acct] and len(keys) < self.limit:
                heapq.heappush(self._room, acct)
                self._in_room[acct] = True

    def _first_with_room(self) -> int | None:
        while self._room:
            self.inspected += 1
            acct = self._room[0]
            if len(self._keys[acct]) < self.limit:
                return acct
            heapq.heappop(self._room)
            self._in_room[acct] = False
        return None

    def route(self, key, now: float) -> int | None:
        """The account that takes ``key`` at ``now`` (filing it there if it
        is new to that account), or None when every account is full."""
        self.expire(now)
        holders = self._holders.get(key)
        holder = None
        if holders:
            self.inspected += 1
            holder = holders[-1]
        room = self._first_with_room()
        if room is not None and (holder is None or room < holder):
            self._keys[room].add(key)
            if holders is None:
                holders = self._holders[key] = deque()
            holders.append(room)
            self._expiry.append((now, room, key))
            self.filed += 1
            return room
        return holder

    def in_window(self, account: int) -> frozenset:
        """The scenarios in ``account``'s window as of the last expiry."""
        return frozenset(self._keys[account])

    def accounts_holding(self) -> int:
        """Accounts whose window holds at least one scenario."""
        return sum(1 for keys in self._keys if keys)


class SPSQueryService:
    """Front door to :meth:`SpotMarket.sps`, enforcing account scenario quotas."""

    def __init__(self, market: SpotMarket, n_accounts: int = 66,
                 scenario_limit: int = 50,
                 region_limits: dict[str, int] | None = None):
        self.market = market
        self.scenario_limit = scenario_limit
        #: optional per-region cap on distinct scenarios per rolling 24h,
        #: pooled across accounts — models vendors that rate-limit the
        #: *endpoint* per region rather than per account (Azure/GCP style)
        self.region_limits = dict(region_limits or {})
        # a region's log is the windows of one account with its own limit
        self._region_log = {r: QuotaBook(1, lim)
                            for r, lim in self.region_limits.items()}
        self.book = QuotaBook(n_accounts, scenario_limit)
        self.total_queries = 0

    @property
    def n_accounts(self) -> int:
        return self.book.n_accounts

    def query(self, type_name: str, region: str, az: str, n: int) -> int | None:
        """Route the query to any account with quota; raise if all exhausted."""
        key = (type_name, region, az, n)
        now = self.market.now
        log = self._region_log.get(region)
        if log is not None and log.route(key, now) is None:
            raise QueryLimitExceeded(
                f"region {region} exhausted its "
                f"{self.region_limits[region]}-scenario/24h quota")
        if self.book.route(key, now) is None:
            raise QueryLimitExceeded(
                f"all {self.n_accounts} accounts exhausted their "
                f"{self.scenario_limit}-scenario/24h quota")
        self.total_queries += 1
        return self.market.sps(type_name, region, az, n)

    def in_window(self, account: int) -> frozenset:
        """Account ``account``'s distinct scenarios in the window ending now
        (the reference's ``accounts[account].distinct_in_window(now)``)."""
        self.book.expire(self.market.now)
        return self.book.in_window(account)

    def region_in_window(self, region: str) -> frozenset:
        """The region log's distinct scenarios in the window ending now."""
        log = self._region_log[region]
        log.expire(self.market.now)
        return log.in_window(0)

    def capacity_remaining(self) -> int:
        self.book.expire(self.market.now)
        return self.scenario_limit * self.n_accounts - self.book.filed
