"""The schedules of kernels B6 (``csrc/rglru_scan.cu``), B1
(``csrc/score_fuse.cu``) and B2 (``csrc/pool_scan.cu``), mirrored in
PyTorch on the CPU, and B3's bf16 columns.

B6 runs the Pallas body's doubling with a chunk's 128 rows spread over a
warp, lane l holding rows l, l + 32, l + 64, l + 96: offsets 1-16 move values
between lanes (a shuffle from lane (l - off) mod 32; a lane below the
offset takes the register one slot down), offsets 32 and 64 between a
lane's own registers.  :func:`rglru_walk` takes that walk on (B, 4, 32, R)
tiles and must equal the plain version ``_rglru_scan_torch`` bit for bit,
and, given XLA's exp and a fused multiply-add, the Pallas body in interpret
mode, as ``tests/test_torch_rglru.py`` holds the plain version.

B1 reduces over K-slices of ``score_plan``: each (row, slice) gets a partial
from its 4 rows a warp, 4 lanes a thread, and a butterfly over the warp's
lanes; the emit merges a row's partials, a thread taking slices t, t + 256,
then a butterfly, then the 8 warps in order.  :func:`score_walk` takes that
order with the kernel's NaN-propagating min and max; its extrema and C_min
must equal the plain version's and the reference's ``stat_extrema`` /
``cost_min`` under ``same_bits`` (equal values, NaN with NaN, -0 with +0),
with NaN, +-0, a one-lane mask and an all-but-one-lane mask among the
inputs.

B2 gives each block of a request's cluster every cluster-th tile of
``pool_scan_plan``, 4 adjacent lanes a thread, each lane taking ``prev``
from the lane before it (its own registers, the thread before it by a
shuffle, or, for a warp's first thread, csc[k - 1]); a block keeps its
warps' ballot-first lowest terminating lane (and csc of the lane before
it, the winning prefix's sum).  Every block scans tile 0; if the stop lies
there, that is the answer.  Else each block walks its tiles in order
(block 0 from its second) until it finds a terminating lane or runs out,
and the blocks' firsts merge by a min.  Every block then writes the counts
row over its own tiles.  :func:`pool_walk` takes that order and must equal
the plain version ``_pool_scan_torch`` bit for bit, and the JAX
reference's ``_pool_scan_lax`` up to counted F1 prefix-sum ties, on rows
that stop at k = 0, at tile edges and never, with zero and negative tails
and all-equal scores.

B3's plain version must give bf16 columns the bits of their float32 casts,
and the wrapper must refuse bf16 columns that come with an int8 scale.

Seeded numpy inputs; no hypothesis.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _scan_rows import scan_rows, stop_lanes
from repro.kernels import pool_scan as jps
from repro.kernels import rglru_scan as jrg
from repro.kernels import score_fuse as jsf
from repro_torch.core import pool as tpool
from repro_torch.kernels import pool_scan as tps
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import score_fuse as tsf
from repro_torch.kernels import stats_update as tsu

H100_SMS = 132
INF = float("inf")


def same_bits(a, b) -> bool:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


# ---------------------------------------------------------------------------
# B6
# ---------------------------------------------------------------------------

def _exp64(t: torch.Tensor) -> torch.Tensor:
    """float32 exp through float64: the same bits for a value wherever it
    sits in a tensor (PyTorch's float32 CPU exp may take another path for a
    strided or tail element)."""
    return torch.exp(t.double()).float()


def _two_roundings(a, b, c):
    return a * b + c


def _xla_exp(t: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.array(jax.jit(jnp.exp)(t.numpy())))


def _fused(a, b, c):
    """One rounding of a * b + c: the float32 product is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def rglru_walk(log_a, x_in, h0, *, exp=_exp64, mul_add=_two_roundings):
    """Kernel B6's lane and register order on the CPU: (hs, h_last)."""
    B, S, R = log_a.shape
    C = trg.CHUNK
    n = -(-S // C)
    pad = n * C - S
    la_all = torch.nn.functional.pad(log_a, (0, 0, 0, pad))
    x_all = torch.nn.functional.pad(x_in, (0, 0, 0, pad))
    last = S - 1 if S < C else C - 1
    lane = torch.arange(32)[None, :, None]
    h = h0
    outs = []
    for ch in range(n):
        # [b, j, l, r] holds row l + 32 j of the chunk
        a = la_all[:, ch * C:(ch + 1) * C].reshape(B, 4, 32, R).clone()
        v = x_all[:, ch * C:(ch + 1) * C].reshape(B, 4, 32, R).clone()
        # the carry into row 0 (lane 0, slot 0); every other row adds +0
        v = v + 0.0
        v[:, 0, 0] = mul_add(exp(a[:, 0, 0]), h, x_all[:, ch * C])
        for d in range(5):
            off = 1 << d
            vy = torch.roll(v, off, dims=2)      # from lane (l - off) mod 32
            ay = torch.roll(a, off, dims=2)
            up = lane >= off
            nv, na = v.clone(), a.clone()
            for j in range(4):
                vs = torch.where(up, vy[:, j], vy[:, j - 1] if j else vy[:, 0])
                as_ = torch.where(up, ay[:, j], ay[:, j - 1] if j else ay[:, 0])
                valid = up if j == 0 else torch.ones_like(up)
                nv[:, j] = torch.where(valid, mul_add(exp(a[:, j]), vs, v[:, j]),
                                       v[:, j])
                na[:, j] = torch.where(valid, a[:, j] + as_, a[:, j])
            v, a = nv, na
        for j in (3, 2, 1):                      # offset 32, in registers
            v[:, j] = mul_add(exp(a[:, j]), v[:, j - 1], v[:, j])
            a[:, j] = a[:, j] + a[:, j - 1]
        for j in (3, 2):                         # offset 64
            v[:, j] = mul_add(exp(a[:, j]), v[:, j - 2], v[:, j])
        rows = v.reshape(B, C, R)
        h = rows[:, last]
        outs.append(rows)
    return torch.cat(outs, 1)[:, :S], h


def _rglru_inputs(B, S, R, seed):
    rng = np.random.default_rng(seed)
    la = -rng.uniform(0.0, 2.0, (B, S, R)).astype(np.float32)
    la[:, rng.integers(0, S, max(1, S // 9))] = 0.0
    x = rng.standard_normal((B, S, R)).astype(np.float32)
    x.reshape(-1)[rng.integers(0, x.size, max(1, x.size // 31))] = -0.0
    h0 = rng.standard_normal((B, R)).astype(np.float32)
    h0[:, ::3] = -0.0
    return la, x, h0


@pytest.mark.parametrize("S", [1, 77, 128, 129, 300])
def test_b6_walk_equals_plain_version_bit_for_bit(S):
    la, x, h0 = (torch.from_numpy(a) for a in _rglru_inputs(2, S, 5, S))
    hs, h_last = rglru_walk(la, x, h0)
    p_hs, p_last = trg._rglru_scan_torch(la, x, h0, exp=_exp64,
                                         mul_add=_two_roundings)
    assert torch.equal(hs, p_hs) and torch.equal(h_last, p_last)
    # -0 survives exactly where the plain version keeps it
    assert torch.equal(torch.signbit(hs), torch.signbit(p_hs))


@pytest.mark.parametrize("S", [1, 77, 129])
def test_b6_walk_equals_pallas_body_with_xla_exp_and_fma(S):
    la, x, h0 = _rglru_inputs(1, S, 4, 100 + S)
    hs, h_last = rglru_walk(*(torch.from_numpy(a) for a in (la, x, h0)),
                            exp=_xla_exp, mul_add=_fused)
    p_hs, p_last = jrg.rglru_scan(la, x, h0, interpret=True)
    np.testing.assert_array_equal(hs.numpy(), np.asarray(p_hs))
    np.testing.assert_array_equal(h_last.numpy(), np.asarray(p_last))


# ---------------------------------------------------------------------------
# B1
# ---------------------------------------------------------------------------

def _min_nan(a, b):
    """``min.NaN.f32``: NaN if either is NaN, else the smaller."""
    return torch.where(torch.isnan(a) | torch.isnan(b),
                       torch.full_like(a, float("nan")), torch.minimum(a, b))


def _max_nan(a, b):
    return -_min_nan(-a, -b)


def _butterfly(v, op):
    """A warp's xor-shuffle reduction over the last axis (32 lanes)."""
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = op(v, v[..., idx ^ o])
    return v[..., 0]


def _slice_partials(vals, on, plan, K, op, fill):
    """Each slice's partial of ``vals`` (rows, K) where ``on``: a thread
    folds its 4-lane groups in order, then the warp's butterfly.  Returns
    (rows, slices)."""
    rows = vals.shape[0]
    per = -(-plan.slice // (tsf.LANES * 32))       # groups a lane
    width = per * tsf.LANES * 32
    parts = []
    for g in range(plan.slices):
        k0, k1 = g * plan.slice, min(K, (g + 1) * plan.slice)
        x = torch.full((rows, width), fill)
        x[:, :k1 - k0] = torch.where(on[:, k0:k1], vals[:, k0:k1],
                                     torch.tensor(fill))
        # lane l's groups: k0 + 4 l + 128 n, lanes 4 apart inside a group
        x = x.reshape(rows, per, 32, tsf.LANES)
        acc = torch.full((rows, 32), fill)
        for n in range(per):
            for i in range(tsf.LANES):
                acc = op(acc, x[:, n, :, i])
        parts.append(_butterfly(acc, op))
    return torch.stack(parts, 1)


def _merge(parts, op, fill):
    """The emit's merge of (rows, G) partials: thread t folds slices t,
    t + 256, ...; a butterfly in each of 8 warps; the warps in order."""
    rows, G = parts.shape
    T = tsf.EMIT_THREADS
    acc = torch.full((rows, T), fill)
    for g0 in range(0, G, T):
        chunk = parts[:, g0:g0 + T]
        acc[:, :chunk.shape[1]] = op(acc[:, :chunk.shape[1]], chunk)
    warps = [_butterfly(acc[:, w * 32:(w + 1) * 32], op) for w in range(T // 32)]
    out = warps[0]
    for w in warps[1:]:
        out = op(out, w)
    return out


def score_walk(stats, prices, vcpus, memory_gb, masks, use_cpus, amount,
               uniq_masks, sms=H100_SMS):
    """B1's K-split extrema (U, 6) and C_min (B,) in the kernel's order."""
    K = stats.shape[1]
    U, B = uniq_masks.shape[0], masks.shape[0]
    plan = tsf.score_plan(K, U + B, sms, K % 4 == 0)
    ext = []
    on_u = uniq_masks.bool()
    for s in range(3):
        vals = stats[s].expand(U, K)
        lo = _merge(_slice_partials(vals, on_u, plan, K, _min_nan, INF),
                    _min_nan, INF)
        hi = _merge(_slice_partials(vals, on_u, plan, K, _max_nan, -INF),
                    _max_nan, -INF)
        ext += [lo, hi]
    total = tsf._tile_total(prices, vcpus, memory_gb, use_cpus[:, None].bool(),
                            amount[:, None])
    cmin = _merge(_slice_partials(total, masks.bool(), plan, K, _min_nan, INF),
                  _min_nan, INF)
    return torch.stack(ext, -1), cmin, plan


def _score_inputs(K, B, seed):
    rng = np.random.default_rng(seed)
    stats = rng.standard_normal((3, K)).astype(np.float32)
    stats.reshape(-1)[rng.integers(0, 3 * K, max(1, K // 17))] = -0.0
    stats[:, rng.integers(0, K, max(1, K // 13))] = 0.0
    nan_lanes = rng.integers(0, K, 2)
    stats[0, nan_lanes[0]] = stats[2, nan_lanes[1]] = np.nan
    masks = rng.random((B, K)) < 0.5
    masks[1:, nan_lanes] = False
    masks[0] = True                                  # sees the NaN lanes
    one = np.zeros(K, bool)
    one[rng.integers(0, K)] = True
    masks[1 % B] = one                               # one lane
    if B > 2:
        masks[2] = True                              # all but one lane
        masks[2, rng.integers(0, K)] = False
    if B > 3:
        masks[3] = False                             # none
    prices = rng.uniform(0.01, 5.0, K).astype(np.float32)
    prices[rng.integers(0, K)] = 0.0
    vcpus = rng.choice([2, 4, 8, 96], K).astype(np.float32)
    mem = rng.choice([4, 16, 384], K).astype(np.float32)
    use = rng.random(B) < 0.5
    amount = rng.choice([64, 100, 1000], B).astype(np.float32)
    return stats, prices, vcpus, mem, masks, use, amount


@pytest.mark.parametrize("K,B", [(1, 1), (3, 2), (255, 5), (1001, 4),
                                 (4099, 6), (32768, 3)])
def test_b1_k_split_equals_plain_extrema_and_c_min(K, B):
    stats, prices, vcpus, mem, masks, use, amount = (
        torch.from_numpy(a) for a in _score_inputs(K, B, K + B))
    ext, cmin, plan = score_walk(stats, prices, vcpus, mem, masks, use,
                                 amount, masks)
    if K == 32768:
        assert plan.slices >= H100_SMS
    plain = tsf._score_fuse_torch(
        stats, prices, vcpus, mem, masks, use, amount,
        torch.ones(B), torch.ones(B), masks, torch.arange(B), None, None)
    assert same_bits(ext, plain.extrema)
    assert same_bits(cmin, plain.c_min)
    # the all-masked request: C_min +inf, extrema (+inf, -inf)
    if B > 3:
        assert cmin[3] == INF and (ext[3, ::2] == INF).all()


@pytest.mark.parametrize("K,B", [(3, 2), (1001, 4), (4099, 6)])
def test_b1_k_split_equals_reference_extrema_and_cost_min(K, B):
    stats, prices, vcpus, mem, masks, use, amount = _score_inputs(K, B, 7 * K)
    ext, cmin, _ = score_walk(*(torch.from_numpy(a) for a in (
        stats, prices, vcpus, mem, masks, use, amount)), torch.from_numpy(masks))
    for b in range(B):
        lo, hi = jsf.stat_extrema(*(jnp.asarray(stats[s]) for s in range(3)),
                                  jnp.asarray(masks[b]), tile=16)
        ref = np.stack([np.asarray(lo), np.asarray(hi)], -1).reshape(6)
        assert same_bits(ext[b], torch.from_numpy(ref))
        c = jsf.cost_min(prices, vcpus, mem, masks[b], bool(use[b]),
                         np.float32(amount[b]))
        assert same_bits(cmin[b], torch.tensor(float(c)))


# ---------------------------------------------------------------------------
# B2
# ---------------------------------------------------------------------------

NONE = 2 ** 31 - 1


def _ceil_i32(x):
    return torch.ceil(x).to(torch.int32)


def _scan_tile(s, c, csc, R, c0, s0R, K, plan, e, r):
    """Block r's e-th tile of one row: its first terminating lane (its
    warps' ballot-first lanes, the least of them; NONE) and csc of the lane
    before it."""
    W = plan.threads // 32
    k0 = (e * plan.cluster + r) * plan.tile
    k = k0 + torch.arange(plan.tile).reshape(W, 32, plan.lanes)
    inb = k < K
    kc = k.clamp(max=K - 1)
    sv = torch.where(inb, s[kc], 0.0)
    cv = torch.where(inb, c[kc], 1.0)
    cs = torch.where(inb, csc[kc], 1.0)
    top = _ceil_i32(s0R / (cs * c0))
    # lane j > 0: the thread's own registers; j = 0: __shfl_up_sync of the
    # thread before's last top (lane 0 of a warp keeps its own, then
    # computes it from csc[k - 1])
    last, cs_last = top[:, :, -1], cs[:, :, -1]
    up = torch.cat([last[:, :1], last[:, :-1]], 1)
    cs_up = torch.cat([cs_last[:, :1], cs_last[:, :-1]], 1)
    first = k[:, 0, 0]
    cs_prev = csc[(first - 1).clamp(0, K - 1)]
    own = (first > 0) & (first < K)
    up[:, 0] = torch.where(own, _ceil_i32(s0R / (cs_prev * c0)), up[:, 0])
    cs_up[:, 0] = torch.where(own, cs_prev, cs_up[:, 0])
    prev = torch.cat([up[..., None], top[..., :-1]], -1)
    cs_before = torch.cat([cs_up[..., None], cs[..., :-1]], -1)
    newest = _ceil_i32(sv * R / (cs * cv))
    term = torch.where(k == 0, newest == 0,
                       (top >= prev) | (newest == 0)) & inb
    has = term.any(-1)                                   # (W, 32)
    j = term.int().argmax(-1)                            # lowest lane
    mine = k[..., 0] + j
    mine_cs = cs_before.gather(-1, j[..., None])[..., 0]
    best, best_cs = NONE, 0.0
    for w in range(W):
        if has[w].any():                                 # the ballot
            t = int(has[w].int().argmax())
            if int(mine[w, t]) < best:                   # the block's min
                best, best_cs = int(mine[w, t]), mine_cs[w, t]
    return best, best_cs


def pool_walk(s, c, csc, required):
    """Kernel B2's cluster schedule on (B, K) rows: (counts, k_stop,
    any_term) and the tiles each block scanned, (B, cluster)."""
    B, K = s.shape
    plan = tps.pool_scan_plan(B, K)
    counts = torch.zeros((B, K), dtype=torch.int32)
    k_stop = torch.zeros(B, dtype=torch.int32)
    any_term = torch.zeros(B, dtype=torch.bool)
    scanned = np.zeros((B, plan.cluster), np.int64)
    for b in range(B):
        R, c0 = required[b], c[b, 0]
        s0R = s[b, 0] * R
        # tile 0, every block alike: the answer when the stop lies there
        tile0 = _scan_tile(s[b], c[b], csc[b], R, c0, s0R, K, plan, 0, 0)
        scanned[b] += 1
        firsts = [tile0] * plan.cluster
        if tile0[0] == NONE:
            for r in range(plan.cluster):     # the walk: block 0 from tile 1
                for e in range(1 if r == 0 else 0, plan.tiles):
                    firsts[r] = _scan_tile(s[b], c[b], csc[b], R, c0, s0R, K,
                                           plan, e, r)
                    scanned[b, r] += 1
                    if firsts[r][0] != NONE:
                        break
        found, stot = min(firsts, key=lambda x: x[0])   # the merge
        hit = found != NONE
        if not hit:
            stot = csc[b, K - 1]
        ks = found if hit else 0
        kb = max(ks - 1, 0) if hit else K - 1
        deg = hit and ks == 0
        if not deg:                   # the merge carried the winning sum
            assert stot == csc[b, kb]
        for e, r in itertools.product(range(plan.tiles), range(plan.cluster)):
            lanes = tps.block_lanes(plan, K, e, r)
            k = torch.arange(lanes.start, lanes.stop)
            if deg:
                v = torch.where(k == 0, _ceil_i32(R / c0), 0)
            else:
                v = torch.where(k <= kb,
                                _ceil_i32(s[b, k] * R / (stot * c[b, k])), 0)
            counts[b, k] = v.to(torch.int32)
        k_stop[b], any_term[b] = ks, hit
    return (counts, k_stop, any_term), scanned


def _b2_rows(K):
    plan = tps.pool_scan_plan(1, K)
    stops = stop_lanes(K, plan.cluster, plan.tile)
    s, c, req, n = scan_rows(K, stops, seed=K)
    return s, c, req, stops, plan


@pytest.mark.parametrize("K", [1, 3, 1023, 1025, 8193, 32768])
def test_b2_cluster_walk_equals_plain_version_bit_for_bit(K):
    s, c, req, stops, plan = _b2_rows(K)
    st, ct, rt = (torch.from_numpy(x) for x in (s, c, req))
    csc = tps._clamped_prefix_sums(st)
    want = tps._pool_scan_torch(st, ct, csc, rt)
    n = len(stops)
    got, scanned = pool_walk(st, ct, csc, rt)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[1][:n].tolist() == stops and bool(got[2][:n].all())
    assert not bool(got[2][n])
    # scanned counts tile 0, which every block scans, and then the block's
    # own tiles: block 0 from its second
    own = np.array([plan.tiles] + [plan.tiles + 1] * (plan.cluster - 1))
    # the row that never stops: every block walks all its tiles
    assert (scanned[n] == own).all()
    for i, k in enumerate(stops):
        e, r = divmod(k // plan.tile, plan.cluster)
        if k < plan.tile:            # tile 0 answers for every block
            assert (scanned[i] == 1).all()
        else:                        # the block holding the stop ends there,
            assert scanned[i, r] == e + 1 + (r > 0)
            # and a block without one walks all its tiles (top keeps
            # falling past a zero score)
            q = (r + 1) % plan.cluster
            assert scanned[i, q] == own[q]


def test_b2_first_stop_wins_over_a_later_block_s_earlier_tile():
    """Two stops: x in block 0's fifth tile, p > x in block 1's fifth, and
    one in block 2's second tile, which lies before both.  Each block ends
    at its own stop; the merge must give the least."""
    K = 40960
    plan = tps.pool_scan_plan(1, K)
    assert plan.tiles == 5
    x = 4 * plan.cluster * plan.tile + 10
    p = (4 * plan.cluster + 1) * plan.tile + 3
    y = (plan.cluster + 2) * plan.tile + 7
    for stops, first in (((x, p), x), ((x, p, y), y)):
        s = torch.ones(1, K)
        s[0, list(stops)] = 0.0
        c, req = torch.ones(1, K), torch.tensor([2e9])
        csc = tps._clamped_prefix_sums(s)
        got, scanned = pool_walk(s, c, csc, req)
        assert int(got[1][0]) == first
        assert scanned[0, 0] == 5 and scanned[0, 1] == 6
        for a, b in zip(got, tps._pool_scan_torch(s, c, csc, req)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("K", [3, 1025, 8193])
def test_b2_cluster_walk_equals_reference_scan(K):
    s, c, req, _, _ = _b2_rows(K)
    st, ct, rt = (torch.from_numpy(x) for x in (s, c, req))
    csc_t = tps._clamped_prefix_sums(st)
    got, _ = pool_walk(st, ct, csc_t, rt)
    lax = jax.jit(jps._pool_scan_lax)
    ties = 0
    for b in range(s.shape[0]):
        ref = [np.asarray(x) for x in lax(jnp.asarray(s[b]), jnp.asarray(c[b]),
                                          jnp.float32(req[b]))]
        row = (got[0][b].numpy(), int(got[1][b]), bool(got[2][b]))
        if (np.array_equal(row[0], ref[0]) and row[1] == int(ref[1])
                and row[2] == bool(ref[2])):
            continue
        csc_j = np.asarray(jps._clamped_prefix_sums(jnp.asarray(s[b])))
        tie, margin, budget = tpool.prefix_sum_tie(
            s[b], c[b], float(req[b]), csc_t[b].numpy(), csc_j,
            [(row[1], row[2]), (int(ref[1]), bool(ref[2]))])
        assert tie, f"row {b}: margin {margin} > budget {budget}"
        ties += 1
    assert ties <= 1, f"{ties} F1 ties in {s.shape[0]} rows"


# ---------------------------------------------------------------------------
# B3's bf16 tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("evict", [False, True])
def test_b3_bf16_columns_give_their_float32_casts_bits(evict):
    rng = np.random.default_rng(11 + evict)
    K = 1001
    win = rng.uniform(0.0, 50.0, (K, 12)).astype(np.float32)
    m = tsu.moments_from_window(win)
    cols = [torch.from_numpy(rng.uniform(-5.0, 60.0, K).astype(np.float32))
            .to(torch.bfloat16) for _ in range(4)]
    cols[0][::97] = -0.0
    got = tsu.stats_update(m, *cols, 12, evict)
    want = tsu.stats_update(m, *(y.float() for y in cols), 12, evict)
    for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert same_bits(a, b)
        assert torch.equal(torch.signbit(a), torch.signbit(b))


def test_b3_refuses_bf16_columns_with_a_scale():
    K = 8
    m = tsu.moments_from_window(np.ones((K, 4), np.float32))
    col = torch.ones(K, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        tsu.stats_update(m, col, col, col, col, 5, False,
                         scale=torch.ones(K))
