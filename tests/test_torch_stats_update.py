"""Kernel B3's module, ``repro_torch.kernels.stats_update``, and the archive
tiers of ``repro_torch.parallel.compression``, against the JAX reference.

The same numpy-seeded windows and columns go through both packages; the
JAX side runs ``backend="vec"`` (and the Pallas kernel in interpret mode at
a small tile).  What is held, and why:

- ``moments_from_window`` is the same float64 numpy code in both: its seven
  outputs are bit-equal.  So are S0, its compensation and ``ref`` after any
  number of ticks (their updates hold no product), and the area.
- S1, Q and their compensations, the slope and the std agree within 1e-5
  of each quantity's range over the candidates, not bit for bit: XLA on the
  CPU contracts ``s + a * b`` into fused multiply-adds inside the jitted
  update, which PyTorch's eager ops never do.  On the int8 tier the same
  holds for S0 and the area, since S0's addend is the decode
  ``code * scale``.  The resolved moments
  ``sum + comp`` are compared, since the two packages may split one value
  differently between its halves.
- Quantized codes, scales and clip counts are bit-equal.

Inside the port, the statistics track ``candidate_stats`` of the
materialized window at the scoring suites' RTOL 1e-5 / ATOL 1e-4.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import scoring as jsc
from repro.kernels import stats_update as jsu
from repro.parallel import compression as jcomp
from repro_torch.core import scoring as tsc
from repro_torch.kernels import stats_update as tsu
from repro_torch.parallel import compression as tcomp

from _score_helpers import ATOL, RTOL

#: cross-package budget, relative to each quantity's range over candidates
RANGE_TOL = 1e-5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _within_range(got, want, name):
    """|got - want| <= RANGE_TOL * the range of ``want`` over candidates
    (its largest magnitude when there is one candidate)."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    span = float(np.ptp(want)) if want.size > 1 else float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= RANGE_TOL * span, f"{name}: {err} > {RANGE_TOL} * {span}"


def _assert_matches_reference(tm, ts, jm, js, quantized=False):
    """On the int8 tier the decode ``code * scale`` feeds the S0 sum, which
    XLA contracts too, so S0 and the area are held to the range budget
    there."""
    exact = ("ref",) if quantized else ("s0", "s0c", "ref")
    for name in exact:
        np.testing.assert_array_equal(_np(getattr(tm, name)),
                                      _np(getattr(jm, name)), err_msg=name)
    for name in ("s1", "q") + (("s0",) if quantized else ()):
        resolved = lambda m: (_np(getattr(m, name)).astype(np.float64)  # noqa: E731
                              + _np(getattr(m, name + "c")))
        _within_range(resolved(tm), resolved(jm), name)
    if quantized:
        _within_range(ts.area, js.area, "area")
    else:
        np.testing.assert_array_equal(_np(ts.area), _np(js.area))
    _within_range(ts.slope, js.slope, "slope")
    _within_range(ts.std, js.std, "std")


def _assert_tracks_recompute(stats, window):
    want = tsc.candidate_stats(torch.as_tensor(np.asarray(window, np.float32)))
    for name, a, b in zip(("area", "slope", "std"), stats, want):
        np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def _slide(win, col):
    return np.concatenate([win[:, 1:], np.asarray(col)[:, None]], axis=1)


# ---------------------------------------------------------------------------
# seeding and the derivation tail
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["float32", "int8", "bfloat16"])
def test_moments_from_window_bit_equal(tier):
    rng = np.random.default_rng(11)
    win = rng.uniform(0.0, 50.0, (70, 37))
    scale = jcomp.candidate_scales(win, tier)
    if tier == "float32":
        jm, tm = jsu.moments_from_window(win), tsu.moments_from_window(win)
    else:
        jcodes = jcomp.quantize_window(win, scale, tier)
        tcodes = tcomp.quantize_window(win, scale, tier)
        s = scale if tier == "int8" else None
        jm = jsu.moments_from_window(jcodes, scale=s)
        tm = tsu.moments_from_window(tcodes, scale=s)
    for name, a, b in zip(tsu.StreamMoments._fields, tm, jm):
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)
    assert tm.nbytes == 7 * 4 * 70


def test_stats_from_moments_matches_reference():
    rng = np.random.default_rng(12)
    K, T = 300, 45
    win = rng.uniform(0.0, 50.0, (K, T)).astype(np.float32)
    m = jsu.moments_from_window(win)
    res = [np.array(a, np.float32) for a in
           (m.s0 + m.s0c, m.s1 + m.s1c, m.q + m.qc)]
    args = (*res, win[:, 0], win[:, -1])
    js = jsc.stats_from_moments(*(jnp.asarray(a) for a in args), float(T),
                                jnp.asarray(m.ref))
    ts = tsc.stats_from_moments(*(torch.as_tensor(a) for a in args), T,
                                torch.as_tensor(np.array(m.ref)))
    for a, b in zip(ts, js):         # eager JAX contracts nothing
        np.testing.assert_array_equal(_np(a), _np(b))
    _assert_tracks_recompute(ts, win)


def test_std_root_is_correctly_rounded():
    """The root is IEEE float32 sqrt (numpy's, and ``sqrtf`` in kernel B3),
    which PyTorch's vectorized float32 sqrt on the CPU is not always."""
    rng = np.random.default_rng(14)
    var = rng.uniform(0.0, 400.0, 100000).astype(np.float32)
    ones = torch.ones(var.size)
    got = tsc.stats_from_moments(ones, ones, torch.from_numpy(var), ones,
                                 ones, 1.0, 1.0).std
    np.testing.assert_array_equal(got.numpy(), np.sqrt(var))


def test_single_column_window_conventions():
    """T == 1: area is the half-weighted sample, slope 0, std 0."""
    y = np.array([[4.0], [0.0], [36.0]])
    one = tsc.stats_from_moments(
        torch.tensor(y[:, 0], dtype=torch.float32), torch.zeros(3),
        torch.zeros(3), torch.tensor(y[:, 0], dtype=torch.float32),
        torch.tensor(y[:, 0], dtype=torch.float32), 1.0,
        torch.tensor(y[:, 0], dtype=torch.float32))
    np.testing.assert_array_equal(_np(one.area), 0.5 * y[:, 0])
    np.testing.assert_array_equal(_np(one.slope), np.zeros(3))
    np.testing.assert_array_equal(_np(one.std), np.zeros(3))
    m = tsu.moments_from_window(y)
    col = np.array([8.0, 2.0, 6.0])
    win = np.concatenate([y, col[:, None]], axis=1)
    m, stats = tsu.stats_update(m, col, col, win[:, 0], win[:, -1], 2, False)
    _assert_tracks_recompute(stats, win)


# ---------------------------------------------------------------------------
# the plain version against the JAX reference, over long streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 127, 1030])
def test_sliding_stream_matches_reference(K):
    """320 sliding ticks through both packages, compared at every 40th."""
    rng = np.random.default_rng(K)
    T = 101
    win = rng.uniform(0.0, 50.0, (K, T))
    jm, tm = jsu.moments_from_window(win), tsu.moments_from_window(win)
    for i in range(320):
        col = rng.uniform(0.0, 50.0, K)
        y_old = win[:, 0]
        win = _slide(win, col)
        args = (col, y_old, win[:, 0], win[:, -1], T, True)
        jm, js = jsu.stats_update(jm, *args, backend="vec")
        tm, ts = tsu.stats_update(tm, *args)
        if i % 40 == 39:
            _assert_matches_reference(tm, ts, jm, js)
    _assert_tracks_recompute(ts, win)


def test_growing_then_sliding_matches_reference():
    """From one column up to a full ring of 48, then 300 slides; ``y_old``
    is garbage while the window grows and must be ignored."""
    rng = np.random.default_rng(4)
    K, C = 65, 48
    series = rng.uniform(0.0, 50.0, (K, C + 300))
    win = series[:, :1]
    jm, tm = jsu.moments_from_window(win), tsu.moments_from_window(win)
    for t in range(1, series.shape[1]):
        col = series[:, t]
        evict = win.shape[1] == C
        y_old = win[:, 0] if evict else col * 17.0 + 3.0
        win = _slide(win, col) if evict else np.concatenate(
            [win, col[:, None]], axis=1)
        args = (col, y_old, win[:, 0], win[:, -1], win.shape[1], evict)
        jm, js = jsu.stats_update(jm, *args, backend="vec")
        tm, ts = tsu.stats_update(tm, *args)
        if t in (2, C - 1, C, series.shape[1] - 1):
            _assert_matches_reference(tm, ts, jm, js)
            _assert_tracks_recompute(ts, win)


def test_int8_stream_matches_reference():
    """The quantized variant: 300 sliding ticks of int8 codes decoded with
    a scale row, through both packages; codes and clip counts bit-equal."""
    rng = np.random.default_rng(6)
    K, T = 97, 101
    scale = jcomp.candidate_scales(np.full((K, 1), 50.0), "int8")
    win = rng.uniform(0.0, 50.0, (K, T))
    codes = jcomp.quantize_window(win, scale, "int8")
    np.testing.assert_array_equal(
        tcomp.quantize_window(win, scale, "int8").numpy(), codes)
    jm = jsu.moments_from_window(codes, scale=scale)
    tm = tsu.moments_from_window(torch.as_tensor(codes), scale=scale)
    tscale = torch.as_tensor(scale)
    for i in range(300):
        col = rng.uniform(0.0, 50.0, K).astype(np.float32)
        jnew, jclip = jcomp.quantize_column(jnp.asarray(col),
                                            jnp.asarray(scale), "int8")
        tnew, tclip = tcomp.quantize_column(torch.as_tensor(col), tscale,
                                            "int8")
        np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
        assert int(tclip) == int(jclip) == 0
        y_old = codes[:, 0]
        codes = _slide(codes, tnew.numpy())
        args = (y_old, codes[:, 0], codes[:, -1], T, True)
        jm, js = jsu.stats_update(jm, jnew, *args, scale=scale,
                                  backend="vec")
        tm, ts = tsu.stats_update(tm, tnew, *args, scale=tscale)
    _assert_matches_reference(tm, ts, jm, js, quantized=True)
    deq = tcomp.dequantize_window(torch.as_tensor(codes), tscale, "int8")
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jcomp.dequantize_window(codes, scale, "int8")))
    _assert_tracks_recompute(ts, deq.numpy())


@pytest.mark.parametrize("K,quantized", [(5, False), (96, False), (100, False),
                                         (100, True)])
def test_matches_pallas_interpret(K, quantized):
    """One tick against the Pallas kernel itself (interpret mode, tile 32)."""
    rng = np.random.default_rng(K + 1)
    T = 17
    win = rng.uniform(0.0, 50.0, (K, T))
    scale = None
    if quantized:
        scale = jcomp.candidate_scales(win, "int8")
        win = jcomp.quantize_window(win, scale, "int8")
    jm = jsu.moments_from_window(win, scale=scale)
    tm = tsu.moments_from_window(win, scale=scale)
    col = win[:, 0] if quantized else rng.uniform(0.0, 50.0, K)
    slid = _slide(win, col)
    args = (col, win[:, 0], slid[:, 0], slid[:, -1])
    jm, js = jsu.stats_update(jm, *args, T, True, scale=scale,
                              backend="pallas", interpret=True, tile=32)
    tm, ts = tsu.stats_update(tm, *args, T, True, scale=scale)
    _assert_matches_reference(tm, ts, jm, js, quantized)


# ---------------------------------------------------------------------------
# the port on its own
# ---------------------------------------------------------------------------

def test_long_stream_no_drift():
    """2000 sliding ticks: the compensated moments stay within 1e-6 of exact
    float64 sums, and the statistics track a recompute."""
    rng = np.random.default_rng(5)
    K, T = 37, 101
    win = rng.uniform(0.0, 50.0, (K, T))
    m = tsu.moments_from_window(win)
    for _ in range(2000):
        col = rng.uniform(0.0, 50.0, K)
        y_old = win[:, 0]
        win = _slide(win, col)
        m, stats = tsu.stats_update(m, col, y_old, win[:, 0], win[:, -1],
                                    T, True)
    _assert_tracks_recompute(stats, win)
    win64 = win.astype(np.float32).astype(np.float64)
    idx = np.arange(T, dtype=np.float64)
    d64 = win64 - _np(m.ref).astype(np.float64)[:, None]
    for got, want in ((m.s0.double() + m.s0c.double(), win64.sum(-1)),
                      (m.s1.double() + m.s1c.double(), win64 @ idx),
                      (m.q.double() + m.qc.double(), (d64 * d64).sum(-1))):
        np.testing.assert_allclose(_np(got), want, rtol=1e-6)


def test_integer_valued_t3_keeps_exact_area():
    rng = np.random.default_rng(9)
    K, T = 50, 40
    win = rng.integers(0, 51, (K, T)).astype(np.float64)
    m = tsu.moments_from_window(win)
    for _ in range(50):
        col = rng.integers(0, 51, K).astype(np.float64)
        y_old = win[:, 0]
        win = _slide(win, col)
        m, stats = tsu.stats_update(m, col, y_old, win[:, 0], win[:, -1],
                                    T, True)
    want = tsc.candidate_stats(torch.as_tensor(win))
    np.testing.assert_array_equal(_np(stats.area), _np(want.area))
    _assert_tracks_recompute(stats, win)


def test_flat_rows_keep_exact_zero_std():
    K, T = 8, 50
    win = np.full((K, T), 7.0)
    m = tsu.moments_from_window(win)
    for _ in range(25):
        m, stats = tsu.stats_update(m, win[:, 0], win[:, 0], win[:, 0],
                                    win[:, 0], T, True)
        np.testing.assert_array_equal(_np(stats.std), np.zeros(K))
        np.testing.assert_array_equal(_np(stats.slope), np.zeros(K))


def test_float64_inputs_are_pinned_to_float32():
    rng = np.random.default_rng(2)
    win = rng.uniform(0.0, 50.0, (9, 11))
    col = rng.uniform(0.0, 50.0, 9)
    slid = _slide(win, col)
    m = tsu.StreamMoments(*(t.double() for t in tsu.moments_from_window(win)))
    m, stats = tsu.stats_update(
        m, *(torch.as_tensor(a) for a in (col, win[:, 0], slid[:, 0],
                                          slid[:, -1])), 11, True)
    assert all(a.dtype == torch.float32 for a in (*m, *stats))
    _assert_tracks_recompute(stats, slid)


def test_inputs_are_not_written():
    rng = np.random.default_rng(3)
    win = rng.uniform(0.0, 50.0, (6, 5))
    m = tsu.moments_from_window(win)
    before = [t.clone() for t in m]
    m2, _ = tsu.stats_update(m, win[:, 0], win[:, 0], win[:, 1], win[:, 0],
                             5, True)
    for a, b in zip(m, before):
        assert torch.equal(a, b)
    assert m2.ref is m.ref


def test_wrapper_validation():
    m = tsu.moments_from_window(np.ones((4, 3)))
    col = np.ones(4)
    with pytest.raises(ValueError, match="backend"):
        tsu.stats_update(m, col, col, col, col, 3, True, backend="vec")
    with pytest.raises(ValueError, match="shape"):
        tsu.stats_update(m, np.ones(5), col, col, col, 3, True)
    with pytest.raises(TypeError, match="int8"):
        tsu.stats_update(m, col, col, col, col, 3, True, scale=np.ones(4))
    with pytest.raises(ValueError, match="K >= 1"):
        tsu.stats_update(tsu.moments_from_window(np.ones((0, 3))),
                         *(np.ones(0),) * 4, 3, True)
    launches = tsu.stats_update.launches
    tsu.stats_update(m, col, col, col, col, 3, True)
    assert tsu.stats_update.launches == launches      # the CPU never launches


# ---------------------------------------------------------------------------
# archive tiers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier,headroom", [("float32", 1.0), ("bfloat16", 1.0),
                                           ("int8", 1.0), ("int8", 1.5)])
def test_window_codes_bit_equal(tier, headroom):
    rng = np.random.default_rng(21)
    win = rng.uniform(-3.0, 50.0, (130, 29))
    win[3] = 0.0                                  # an all-zero row
    scale = tcomp.candidate_scales(win, tier, headroom=headroom, chunk=64)
    np.testing.assert_array_equal(
        scale, jcomp.candidate_scales(win, tier, headroom=headroom))
    got = tcomp.quantize_window(win, scale, tier, chunk=64)
    want = jcomp.quantize_window(win, scale, tier)
    assert got.dtype == tcomp.storage_dtype(tier)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want, np.float32))
    deq = tcomp.dequantize_window(got, scale, tier)
    assert deq.dtype == torch.float32
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jcomp.dequantize_window(want, scale, tier)))


@pytest.mark.parametrize("tier", ["float32", "bfloat16", "int8"])
def test_column_codes_and_clip_counts_bit_equal(tier):
    """Half-way values round to even in both; out-of-range samples clip and
    are counted."""
    rng = np.random.default_rng(22)
    K = 257
    scale = np.full(K, 0.5, np.float32)
    col = rng.uniform(-90.0, 90.0, K).astype(np.float32)
    col[:6] = [0.25, 0.75, -0.25, 1.25, 63.75, -63.25]   # exact halves
    jcodes, jclip = jcomp.quantize_column(jnp.asarray(col), jnp.asarray(scale),
                                          tier)
    tcodes, tclip = tcomp.quantize_column(torch.as_tensor(col),
                                          torch.as_tensor(scale), tier)
    np.testing.assert_array_equal(tcodes.to(torch.float32).numpy(),
                                  np.asarray(jcodes, np.float32))
    assert tclip.dtype == torch.int32
    assert int(tclip) == int(jclip)
    if tier == "int8":
        assert int(tclip) > 0
        np.testing.assert_array_equal(tcodes[:6].numpy(),
                                      [0, 2, 0, 2, 127, -126])


def test_tier_validation():
    with pytest.raises(ValueError, match="archive precision"):
        tcomp.resolve_precision("fp8")
    with pytest.raises(ValueError, match="headroom"):
        tcomp.candidate_scales(np.ones((2, 2)), "int8", headroom=0.5)
    assert tcomp.storage_dtype("int8") is torch.int8
    np.testing.assert_array_equal(
        tcomp.candidate_scales(np.ones((3, 2)), "float32"), np.zeros(3))
