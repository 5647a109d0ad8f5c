"""Archive storage tiers (``compression``); sharding arrives with a later slice."""
