"""The schedules of kernels B6 (``csrc/rglru_scan.cu``) and B1
(``csrc/score_fuse.cu``), mirrored in PyTorch on the CPU.

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

Seeded numpy inputs; no hypothesis.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rglru_scan as jrg
from repro.kernels import score_fuse as jsf
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import score_fuse as tsf

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
