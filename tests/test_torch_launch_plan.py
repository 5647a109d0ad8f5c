"""Launch geometry of the Hopper kernels B4, B7 and B8, and of the
persistent RG-LRU scan B6 and the K-split scoring kernel B1, checked on the
CPU.

The kernels take their grid from the wrappers' plans
(``flash_attention.launch_plan``, ``moe_gmm.gmm_plan``) and index their
blocks as ``block_work`` / ``gmm_block_work`` describe.  Every (batch,
head, query row) of B4 and every (expert, row, column) of B7 and B8 must
be stored by exactly one block, at ragged S, C, F and D, and each weight
byte of B7 and B8 loaded once per row group (once a launch at C <= 256);
B4's key tiles must hold every key a row attends to; the TMA boxes and
alignment rules must match what the kernels load; B7's epilogue must pair
w1's and w3's accumulators of one column.  Also: a change to a shared
header ``csrc/*.cuh`` must change the name of every library built from the
sources.  B6 (``rglru_scan.launch_plan`` / ``block_work``) must scan every
(batch, channel) exactly once; B1 (``score_fuse.score_plan``) must reduce
every (row, lane) and emit every (request, lane) exactly once, run at least
one reduce block an SM at the serving shape, and take its 16-byte path only
on 16-byte-aligned rows.  B2 (``pool_scan.pool_scan_plan``) must scan and
emit every lane of a request exactly once, on a grid whose x extent is one
cluster, and take 4 lanes at a time only where ``_build.rows_aligned``
allows; B3 (``stats_update.stats_update_plan``) must update every candidate
once on at least one block an SM at K = 32768.
"""
import shutil

import numpy as np
import pytest
import torch

import repro_torch.core  # noqa: F401  (imports the kernels in package order)
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import pool_scan as tps
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import rwkv6_scan as twkv
from repro_torch.kernels import score_fuse as tsf
from repro_torch.kernels import stats_update as tsu

SMEM_LIMIT = 232448          # a block's shared memory on an H100 (227 KB)
H100_SMS = 132


@pytest.mark.parametrize("B,S,H,KV,D", [
    (8, 4096, 14, 2, 64),      # qwen2-0.5b's forward
    (1, 4000, 7, 1, 128),
    (2, 77, 8, 8, 128),
    (2, 300, 14, 2, 64),
    (1, 128, 2, 1, 64),
    (3, 129, 4, 2, 64),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plan_covers_every_row_once(B, S, H, KV, D, causal):
    plan = tfa.launch_plan(B, S, H, D)
    assert plan.grid == (B * H, -(-S // tfa.QUERY_TILE))
    assert plan.stages == tfa.STAGES[D]
    assert plan.box == (64, 1, tfa.QUERY_TILE, 1) == tfa.TMA_BOX
    assert D % plan.box[0] == 0 and tfa.KEY_TILE == plan.box[2]
    assert plan.smem_bytes == (1024 + 2 * D * (tfa.QUERY_TILE + 2 * plan.stages
                                                * tfa.KEY_TILE)
                               + 8 * (1 + 2 * plan.stages)) <= 232448
    seen = np.zeros((B, H, S), np.int64)
    first_rows = []
    for x in range(plan.grid[0]):
        for y in range(plan.grid[1]):
            b, h, g, rows, keys = tfa.block_work(plan, S, S, H, KV, causal, x, y)
            assert g == h // (H // KV)
            assert keys.start == 0 and len(keys) % tfa.KEY_TILE in (0, S % tfa.KEY_TILE)
            for rr in rows:
                seen[b, h, rr.start:rr.stop] += 1
            last = max((rr.stop - 1 for rr in rows if len(rr)), default=-1)
            # every key the last row attends to is loaded; causal: no tile
            # wholly above the diagonal
            need = last + 1 if causal else S
            assert keys.stop >= need
            if causal:
                assert keys.stop - need < tfa.KEY_TILE
            if y == 0:
                first_rows.append(len(keys))
    assert (seen == 1).all()
    # the first row of blocks holds the heaviest tiles
    assert min(first_rows) == max(
        len(tfa.block_work(plan, S, S, H, KV, causal, x, y)[4])
        for x in range(plan.grid[0]) for y in range(plan.grid[1]))


def _check_gmm_plan(E, C, K, N, sms, up):
    plan = tgmm.gmm_plan(E, C, K, N, sms, up=up)
    assert plan.row_tiles in (1, 2, 4)
    rows = plan.row_tiles * tgmm.GMM_ROW_TILE
    assert rows * plan.row_groups >= C > rows * (plan.row_groups - 1)
    if plan.row_groups == 1:       # no more tiles than the rows need
        assert rows // 2 < max(C, 64)
    assert plan.cols == (tgmm.UP_COLS if up else tgmm.DOWN_COLS)
    assert plan.col_tiles == -(-N // plan.cols)
    assert plan.tiles == E * plan.col_tiles
    assert plan.blocks == min(plan.tiles, sms)
    assert plan.stages == tgmm.GMM_STAGES[plan.row_tiles]
    assert plan.a_box == (tgmm.GMM_DEPTH, rows, 1)
    assert plan.w_box == (64, tgmm.GMM_DEPTH, 1)
    # two weight boxes a stage: B8's 128 columns, or w1's and w3's 64
    assert (1 if up else 2) * plan.w_box[0] == plan.cols and rows <= 256
    # the ring, its barriers and the alignment slack fit a block's 227 KB
    stage = 2 * (rows * tgmm.GMM_DEPTH + 2 * tgmm.GMM_DEPTH * plan.w_box[0])
    assert plan.smem_bytes == plan.stages * stage + 1024 + 16 * plan.stages
    assert plan.smem_bytes <= 232448
    seen = np.zeros((E, C, N), np.int64)
    weight_loads = np.zeros((E, plan.col_tiles), np.int64)
    per_block = []
    for x in range(plan.blocks):
        work = tgmm.gmm_block_work(plan, C, N, x)
        per_block.append(len(work))
        for e, tiles, cols in work:
            # the producer loads the tile's weight boxes once a row group
            weight_loads[e, cols.start // plan.cols] += plan.row_groups
            assert all(len(t) <= tgmm.GMM_ROW_TILE for t in tiles)
            for t in tiles:
                seen[e, t.start:t.stop, cols.start:cols.stop] += 1
    assert (seen == 1).all()
    assert (weight_loads == plan.row_groups).all()
    if C <= 256:                   # every weight byte leaves memory once
        assert (weight_loads == 1).all()
    assert max(per_block) - min(per_block) <= 1      # balanced over blocks


_GMM_CASES = [
    (64, 240, 1408, 2048),     # DeepSeek-V2-Lite prefill (B8's F, D)
    (64, 8, 1408, 2048),       # its decode
    (3, 17, 1416, 200),
    (3, 300, 200, 1416),
    (2, 64, 64, 128),
    (2, 129, 72, 40),
    (1, 513, 8, 8),
]


@pytest.mark.parametrize("E,C,F,D", _GMM_CASES)
@pytest.mark.parametrize("sms", [132, 7])
def test_down_plan_covers_every_output_once(E, C, F, D, sms):
    _check_gmm_plan(E, C, F, D, sms, up=False)


@pytest.mark.parametrize("E,C,D,F", _GMM_CASES + [
    (64, 8, 2048, 1408),       # DeepSeek-V2-Lite's decode (B7's D, F)
    (64, 240, 2048, 1408),     # its prefill
    (64, 300, 2048, 1408),     # two row groups
])
@pytest.mark.parametrize("sms", [132, 7])
def test_up_plan_covers_every_output_once(E, C, D, F, sms):
    _check_gmm_plan(E, C, D, F, sms, up=True)


def test_up_epilogue_pairs_w1_and_w3_columns():
    # B7's one m64n128 product holds x @ w1 in columns 0-63 and x @ w3 in
    # columns 64-127; each thread must find column c of both in its own
    # registers, 32 apart, and the 128 threads store the 64 x 64 tile once
    stored = np.zeros((64, tgmm.UP_COLS), np.int64)
    for t in range(128):
        owned = {tgmm.acc_position(t, i) for i in range(64)}
        assert len(owned) == 64
        for row, col, a, b in tgmm.up_epilogue(t):
            assert b - a == 32
            assert tgmm.acc_position(t, a) == (row, col)
            assert tgmm.acc_position(t, b) == (row, col + tgmm.UP_COLS)
            stored[row, col] += 1
    assert (stored == 1).all()


def test_wkv_blocks_fit_two_to_an_sm():
    # B5 asks for two 256-thread blocks an SM (__launch_bounds__(256, 2)):
    # each block's dynamic shared memory plus the 1 KB the card reserves
    # for it must fit the SM's 228 KB twice, and one block the 227 KB limit
    for D in twkv.CUDA_HEAD_DIMS:
        assert 2 * (twkv.smem_bytes(D) + 1024) <= 233472
        assert twkv.smem_bytes(D) <= 232448
    assert twkv.smem_bytes(64) == 100352


def test_tma_alignment_rules():
    t = torch.zeros(2, 5, 16, dtype=torch.bfloat16)
    assert _build.tma_ready(t)
    assert not _build.tma_ready(torch.zeros(2, 5, 12, dtype=torch.bfloat16))
    off = torch.zeros(2 * 5 * 16 + 1, dtype=torch.bfloat16)[1:].view(2, 5, 16)
    assert not _build.tma_ready(off)
    assert not _build.tma_ready(torch.zeros(1, 4, 3, 4, dtype=torch.bfloat16))
    # qwen2-0.5b's q, k and v (D = 64) are ready as they are
    assert _build.tma_ready(torch.zeros(1, 7, 14, 64, dtype=torch.bfloat16))


def test_padded_down_projection_adds_only_zeros():
    # the wrapper's zero padding for TMA changes no sum: the plain version
    # on the padded operands, cut back, equals it on the originals
    g = torch.Generator().manual_seed(3)
    h = torch.randn(2, 5, 13, generator=g).to(torch.bfloat16)
    w2 = torch.randn(2, 13, 11, generator=g).to(torch.bfloat16)
    hp = tgmm._pad_last(h, 16)
    wp = tgmm._pad_last(torch.nn.functional.pad(w2, (0, 0, 0, 3)), 16)
    assert hp.shape == (2, 5, 16) and wp.shape == (2, 16, 16)
    assert _build.tma_ready(hp) and _build.tma_ready(wp)
    assert torch.equal(tgmm._moe_gmm_down_torch(hp, wp)[..., :11],
                       tgmm._moe_gmm_down_torch(h, w2))


def test_padded_up_projection_adds_only_zeros():
    # as for B8: zero rows of w1 / w3 and zero columns of x add nothing, and
    # the padded output columns (silu(0) * 0) are cut off
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 5, 13, generator=g).to(torch.bfloat16)
    w1, w3 = (torch.randn(2, 13, 11, generator=g).to(torch.bfloat16)
              for _ in range(2))
    xp = tgmm._pad_last(x, 16)
    w1p, w3p = (tgmm._pad_last(torch.nn.functional.pad(w, (0, 0, 0, 3)), 16)
                for w in (w1, w3))
    assert xp.shape == (2, 5, 16) and w1p.shape == w3p.shape == (2, 16, 16)
    assert all(_build.tma_ready(t) for t in (xp, w1p, w3p))
    padded = tgmm._moe_gmm_torch(xp, w1p, w3p)
    assert torch.equal(padded[..., :11], tgmm._moe_gmm_torch(x, w1, w3))
    assert not padded[..., 11:].any()


def test_header_change_renames_every_library(tmp_path, monkeypatch):
    for src in ("moe_gmm.cu", "flash_attention.cu", "rwkv6_scan.cu",
                "score_fuse.cu", "hopper.cuh"):
        shutil.copy(_build.CSRC / src, tmp_path / src)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = ("moe_gmm", "flash_attention", "rwkv6_scan", "score_fuse")
    before = {n: _build._output(n) for n in names}
    assert {n: _build._output(n) for n in names} == before      # stable
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// touched\n")
    after = {n: _build._output(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    assert all(after[n].parent == _build.BUILD_DIR for n in names)
    (tmp_path / "extra.cuh").write_text("// a new header\n")
    assert all(_build._output(n) != after[n] for n in names)
    assert "--fmad=false" in _build.NVCC_FLAGS


# ---------------------------------------------------------------------------
# B6: the persistent RG-LRU scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,R", [
    (16, 128, 2560),     # recurrentgemma-2b's prefill
    (16, 300, 2561),     # channel tail, three chunks
    (3, 77, 33), (1, 1, 1), (2, 129, 16), (5, 128, 4000),
])
@pytest.mark.parametrize("blocks_per_sm", [1, 4, 6])
def test_rglru_plan_covers_every_channel_once(B, S, R, blocks_per_sm):
    plan = trg.launch_plan(B, R, H100_SMS, blocks_per_sm)
    assert plan.tiles == B * -(-R // trg.TILE_CHANNELS)
    assert 1 <= plan.grid <= min(plan.tiles, H100_SMS * blocks_per_sm)
    assert plan.waves == plan.tiles / (H100_SMS * blocks_per_sm)
    assert plan.smem_bytes == trg.SMEM_BYTES <= SMEM_LIMIT
    seen = np.zeros((B, R), np.int64)
    loads = []
    for x in range(plan.grid):
        work = trg.block_work(plan, R, x)
        loads.append(len(work))
        for b, chans in work:
            assert len(chans) <= trg.TILE_CHANNELS
            seen[b, chans.start:chans.stop] += 1
    assert (seen == 1).all()
    # a persistent grid: the blocks' tile counts differ by at most one
    assert max(loads) - min(loads) <= 1 and min(loads) >= 1


def test_rglru_smem_fits_with_room_for_blocks():
    # two buffers of log_a and x (16 channels padded to 17) and of h0, the
    # carries; small enough for several blocks an SM
    assert trg.SMEM_BYTES == 4 * (4 * trg.CHUNK * 17 + 3 * 16) == 35008
    assert 6 * trg.SMEM_BYTES <= SMEM_LIMIT


# ---------------------------------------------------------------------------
# B1: the K-split reduction and the emit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 3, 255, 1001, 32768, 32771, 1 << 20])
@pytest.mark.parametrize("U,B,ext,cmin", [
    (1, 1, True, True), (4, 16, True, True), (16, 16, True, True),
    (16, 64, True, True), (3, 64, False, True), (7, 9, True, False),
    (40, 65535, True, True),
])
def test_score_plan_covers_every_row_and_lane_once(K, U, B, ext, cmin):
    rows = (U if ext else 0) + (B if cmin else 0)
    plan = tsf.score_plan(K, rows, H100_SMS, K % 4 == 0)
    assert plan.slice % tsf.LANES == 0
    assert plan.slices == -(-K // plan.slice)
    assert plan.slices <= tsf.SLICES_PER_SM * H100_SMS   # partials to merge
    assert plan.row_groups == max(1, -(-rows // tsf.REDUCE_ROWS))
    assert plan.row_groups <= 65535 and B <= 65535       # grid y limits
    # every (row, lane) reduced once: lanes by slice, rows by group
    lanes = np.zeros(K, np.int64)
    for x in range(plan.slices):
        ln, rw = tsf.reduce_block_work(plan, K, rows, x, 0)
        lanes[ln.start:ln.stop] += 1
    assert (lanes == 1).all()
    row_seen = np.zeros(max(rows, 1), np.int64)
    for y in range(plan.row_groups):
        _, rw = tsf.reduce_block_work(plan, K, rows, 0, y)
        row_seen[rw.start:rw.stop] += 1
    assert (row_seen[:rows] == 1).all()
    # every (request, lane) emitted once
    if K * B <= 1 << 22:
        emitted = np.zeros((B, K), np.int64)
        for y in range(B):
            for x in range(plan.emit_blocks):
                b, ln = tsf.emit_block_work(plan, K, x, y)
                emitted[b, ln.start:ln.stop] += 1
        assert (emitted == 1).all()
    assert plan.emit_blocks == -(-K // tsf.EMIT_LANES)


@pytest.mark.parametrize("U", [1, 2, 16])
def test_score_reduce_fills_the_card_at_the_serving_shape(U):
    # B = 16 requests, K = 32768 candidates: at least one block an SM,
    # every block scanning every row over its slice
    plan = tsf.score_plan(32768, U + 16, H100_SMS, True)
    assert plan.row_groups == 1
    assert plan.slices * plan.row_groups >= H100_SMS
    assert plan.slice == 128 and plan.slices == 256


def test_score_vector_path_only_on_aligned_rows():
    K = 64
    floats = [torch.zeros(3, K), torch.zeros(K), torch.zeros(2, K)]
    masks = [torch.zeros(5, K, dtype=torch.bool)]
    assert tsf.vec_ok(K, floats, masks)
    # K not a multiple of 4: rows 1 and 2 of stats (and odd request rows)
    # start off a 16-byte boundary
    assert not tsf.vec_ok(K - 1, [torch.zeros(3, K - 1)], masks)
    assert not tsf.vec_ok(K + 2, [torch.zeros(3, K + 2)], masks)
    # a float array whose first element is off a 16-byte boundary
    off = torch.zeros(K + 1)[1:]
    assert off.data_ptr() % 16 != 0
    assert not tsf.vec_ok(K, floats + [off], masks)
    # a mask array off a 4-byte boundary
    moff = torch.zeros(5 * K + 1, dtype=torch.bool)[1:].view(5, K)
    assert not tsf.vec_ok(K, floats, [moff])
    # and the plan records the decision it was given
    assert tsf.score_plan(K, 2, H100_SMS, False).vec is False


# ---------------------------------------------------------------------------
# B2: one cluster a request, each block walking every cluster-th tile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 3, 4, 1023, 1025, 8192, 8193, 32768, 32771,
                               1 << 20])
@pytest.mark.parametrize("B", [1, 16, 65535])
def test_pool_scan_plan_covers_every_lane_once(B, K):
    plan = tps.pool_scan_plan(B, K)
    assert plan.grid == (plan.cluster, B)
    assert plan.grid[0] % plan.cluster == 0 and plan.grid[1] <= 65535
    assert 1 <= plan.cluster <= 8                        # portable cluster
    assert plan.tile == plan.threads * plan.lanes
    assert plan.tile % 4 == 0                            # 16-byte accesses
    # every lane scanned (and emitted: the same tiles) once; a block's
    # tiles, and the e-th tiles across the cluster, in lane order
    seen = np.zeros(K, np.int64)
    starts = []
    for e in range(plan.tiles):
        for r in range(plan.cluster):
            lanes = tps.block_lanes(plan, K, e, r)
            seen[lanes.start:lanes.stop] += 1
            starts += [lanes.start]
    assert (seen == 1).all()
    assert starts == sorted(starts)
    # a block's last tile is the first to hold no lane for some block
    assert (plan.tiles - 1) * plan.cluster * plan.tile < K


def test_pool_scan_plan_refuses_grids_the_card_cannot_launch():
    for B in (0, 65536):
        with pytest.raises(ValueError):
            tps.pool_scan_plan(B, 16)
    # the serving shape: the blocks' first tiles hold the first 8192
    # lanes, 4 tiles a block all
    plan = tps.pool_scan_plan(16, 32768)
    assert plan.cluster * plan.tile == 8192 and plan.tiles == 4


def test_pool_scan_16_byte_path_only_on_aligned_rows():
    K = 64
    f32, i32 = torch.zeros(9, K), torch.zeros(3, K, dtype=torch.int32)
    assert _build.rows_aligned(K, [f32, f32[3], i32, i32[1]])
    # K not a multiple of 4: row 1 of a (9, K) tensor is off the boundary
    assert not _build.rows_aligned(K - 1, [torch.zeros(9, K - 1)])
    assert not _build.rows_aligned(K + 2, [torch.zeros(9, K + 2)])
    # first elements off a boundary of 4 elements
    assert not _build.rows_aligned(K, [torch.zeros(K + 1)[1:]])
    assert not _build.rows_aligned(
        K, [f32, torch.zeros(K + 2, dtype=torch.int32)[2:]])
    assert _build.rows_aligned(K, [torch.zeros(K + 4)[4:]])


# ---------------------------------------------------------------------------
# B3: a candidate a thread, at least one block an SM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 3, 255, 3001, 4096, 32768, 32771, 270336,
                               1 << 20, (1 << 20) + 3])
def test_stats_update_plan_covers_every_candidate_once(K):
    plan = tsu.stats_update_plan(K, H100_SMS)
    assert plan.threads % 32 == 0 and plan.threads <= tsu.MAX_THREADS
    assert plan.blocks * plan.threads >= K               # thread i, candidate i
    assert plan.blocks == -(-K // plan.threads)          # no idle block


def test_stats_update_fills_the_card_at_the_serving_shape():
    plan = tsu.stats_update_plan(32768, H100_SMS)
    assert plan.blocks >= H100_SMS and plan.threads == 128
    # the widest block once every SM gets two
    wide = tsu.stats_update_plan(1 << 20, H100_SMS)
    assert wide.threads == tsu.MAX_THREADS and wide.blocks >= 2 * H100_SMS
    # a small K still spreads over the SMs, on blocks of one warp
    small = tsu.stats_update_plan(3001, H100_SMS)
    assert small.threads == 32 and small.blocks == 94
