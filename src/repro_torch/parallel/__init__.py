"""Archive storage tiers (``compression``); the mesh half of the reference's
``parallel`` (``sharding``) is not ported yet (ROADMAP A.9c)."""
