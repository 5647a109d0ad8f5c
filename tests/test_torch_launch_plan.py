"""Launch geometry of the Hopper kernels B4 and B8, checked on the CPU.

The kernels take their grid from the wrappers' plans
(``flash_attention.launch_plan``, ``moe_gmm.down_plan``) and index their
blocks as ``block_work`` / ``down_block_work`` describe.  Every (batch,
head, query row) of B4 and every (expert, row, column) of B8 must be
stored by exactly one block, at ragged S, C and D; B4's key tiles must hold
every key a row attends to; the TMA boxes and alignment rules must match
what the kernels load.  Also: a change to a shared header ``csrc/*.cuh``
must change the name of every library built from the sources.
"""
import shutil

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import moe_gmm as tgmm


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


@pytest.mark.parametrize("E,C,F,D", [
    (64, 240, 1408, 2048),     # DeepSeek-V2-Lite prefill
    (64, 8, 1408, 2048),       # its decode
    (3, 17, 1416, 200),
    (3, 300, 200, 1416),
    (2, 64, 64, 128),
    (2, 129, 72, 40),
    (1, 513, 8, 8),
])
@pytest.mark.parametrize("sms", [132, 7])
def test_down_plan_covers_every_output_once(E, C, F, D, sms):
    plan = tgmm.down_plan(E, C, F, D, sms)
    assert plan.row_tiles in (1, 2, 4)
    rows = plan.row_tiles * tgmm.DOWN_ROW_TILE
    assert rows * plan.row_groups >= C > rows * (plan.row_groups - 1)
    if plan.row_groups == 1:       # no more tiles than the rows need
        assert rows // 2 < max(C, 64)
    assert plan.col_tiles == -(-D // tgmm.DOWN_COLS)
    assert plan.tiles == E * plan.col_tiles
    assert plan.blocks == min(plan.tiles, sms)
    assert plan.stages == tgmm.DOWN_STAGES[plan.row_tiles]
    assert plan.h_box == (tgmm.DOWN_DEPTH, rows, 1)
    assert plan.w_box == (64, tgmm.DOWN_DEPTH, 1)
    assert 2 * plan.w_box[0] == tgmm.DOWN_COLS and rows <= 256
    # the ring, its barriers and the alignment slack fit a block's 227 KB
    stage = 2 * (rows * tgmm.DOWN_DEPTH + tgmm.DOWN_DEPTH * tgmm.DOWN_COLS)
    assert plan.smem_bytes == plan.stages * stage + 1024 + 16 * plan.stages
    assert plan.smem_bytes <= 232448
    seen = np.zeros((E, C, D), np.int64)
    per_block = []
    for x in range(plan.blocks):
        work = tgmm.down_block_work(plan, C, D, x)
        per_block.append(len(work))
        for e, tiles, cols in work:
            assert all(len(t) <= tgmm.DOWN_ROW_TILE for t in tiles)
            for t in tiles:
                seen[e, t.start:t.stop, cols.start:cols.stop] += 1
    assert (seen == 1).all()
    assert max(per_block) - min(per_block) <= 1      # balanced over blocks


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


def test_header_change_renames_every_library(tmp_path, monkeypatch):
    for src in ("moe_gmm.cu", "flash_attention.cu", "score_fuse.cu", "hopper.cuh"):
        shutil.copy(_build.CSRC / src, tmp_path / src)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = ("moe_gmm", "flash_attention", "score_fuse")
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
