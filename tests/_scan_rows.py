"""Seeded adversarial rows for kernel B2, Algorithm 1's termination scan.

With every score and capacity 1 and R = 2e9, the prefix sums are the exact
integers k + 1 and top[k] = ceil(2e9 / (k + 1)) falls by more than one at
every lane below 44,000, so the scan never stops.  A zero score at lane k
stops it exactly there (newest[k] = 0, and top repeats).  Beside those:
sorted random scores with a zero tail, with a negative tail (clamped prefix
sums), and all equal.  Float32 numpy arrays.
"""
import numpy as np

NEVER_R = 2e9


def stop_lanes(K: int, cluster: int, tile: int) -> list[int]:
    """Lanes on the kernel's edges: 0 and 1, the last lane of the first
    tile and the first of the second, the last lane of the first step and
    the first two of the second, a lane in the third step, and K - 1."""
    step = cluster * tile
    lanes = (0, 1, 7, tile - 1, tile, 2 * tile - 1, step - 1, step, step + 1,
             2 * step + 5, K - 1)
    return sorted({k for k in lanes if 0 <= k < K})


def scan_rows(K: int, stops, seed: int):
    """``(s, c, required, n_stop)``: row i stops at ``stops[i]``, row
    ``n_stop`` never stops, then four seeded rows (zero tail, negative
    tail, all equal, plain)."""
    rng = np.random.default_rng(seed)
    s = np.ones((len(stops) + 1, K), np.float32)
    for i, k in enumerate(stops):
        s[i, k] = 0.0
    c = np.ones_like(s)
    req = [NEVER_R] * len(s)
    tail = np.sort(rng.uniform(0.0, 50.0, (4, K)), axis=1)[:, ::-1]
    tail = tail.astype(np.float32)
    tail[0, K // 3:] = 0.0
    tail[1, K // 5:] = -1.0
    tail[2, :] = tail[2, 0]
    s = np.concatenate([s, tail])
    caps = rng.choice([2, 4, 8, 16], (4, K)).astype(np.float32)
    c = np.concatenate([c, caps])
    req = np.array(req + [64.0, 4096.0, 96.0, 1e5], np.float32)
    return s, c, req, len(stops)
