"""MoE grouped expert matmuls over dense (E, C, D) capacity buffers.

PyTorch counterpart of ``repro.kernels.moe_gmm``:

    up   (B7):  silu(x @ w1) * (x @ w3)   (E, C, D) x (E, D, F) -> (E, C, F)
    down (B8):  h @ w2                    (E, C, F) x (E, F, D) -> (E, C, D)

Both products accumulate in float32; the up kernel takes
``silu(acc1) * acc3`` in float32; each result is cast once to the input
dtype.  Two versions of each, one contract:

- the plain PyTorch version (:func:`_moe_gmm_torch`,
  :func:`_moe_gmm_down_torch`): upcast to float32, ``torch.einsum``, silu
  and multiply, one cast.  CPU tensors take it and ``backend="torch"``
  forces it;
- the CUDA kernels B7/B8, ``csrc/moe_gmm.cu``, which CUDA tensors take.
  B7: bf16 tiles in shared memory through cp.async, ``mma.sync`` bf16
  products with float32 accumulators.  B8 (Hopper): each (expert, 128
  output columns) tile is owned by one block with all its rows, so each w2
  byte is read once; the grid is persistent (one block an SM); a producer
  thread keeps a ring of TMA loads in flight and two consumer warpgroups
  run ``wgmma``.  Its launch geometry is planned here
  (:func:`down_plan`), where the CPU tests can check it.

They agree to float32 summation order: the kernel adds its products in
another order than the float32 einsum, so an element can land one bf16
ulp apart after the final cast.

Neither has a backward (nor has the reference's Pallas call): under
autograd the wrappers raise.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F_

from . import _build

_SIGNATURES = {"moe_gmm_up_launch": (4, 4), "moe_gmm_down_launch": (3, 6)}

# B8's launch geometry (csrc/moe_gmm.cu, namespace ``down``)
DOWN_COLS = 128          # output columns a block
DOWN_DEPTH = 64          # contraction steps a ring stage (one swizzle row)
DOWN_ROW_TILE = 64       # rows of one wgmma tile
DOWN_MAX_TILES = 4       # m64 tiles a row group: two per consumer warpgroup
DOWN_STAGES = {1: 8, 2: 6, 4: 4}   # ring depth by m64 tiles a row group


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _moe_gmm_torch(x, w1, w3):
    xf = x.float()
    h1 = torch.einsum("ecd,edf->ecf", xf, w1.float())
    h3 = torch.einsum("ecd,edf->ecf", xf, w3.float())
    return (h1 * torch.sigmoid(h1) * h3).to(x.dtype)


def _moe_gmm_down_torch(h, w2):
    return torch.einsum("ecf,efd->ecd", h.float(), w2.float()).to(h.dtype)


# ---------------------------------------------------------------------------
# B8's launch plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DownPlan:
    """Where B8's blocks go for (E, C, F) x (E, F, D).

    The output falls into ``tiles`` = E x ``col_tiles`` tiles of
    ``DOWN_COLS`` columns of one expert, all C rows each (tile t: expert
    t // col_tiles, columns ``DOWN_COLS * (t % col_tiles)``).  The grid is
    persistent: ``blocks`` blocks, at most one an SM, block x taking tiles
    x, x + blocks, ...  A tile's rows run in ``row_groups`` groups of
    ``row_tiles`` m64 tiles, its contraction in ``DOWN_DEPTH`` steps through
    a ring of ``stages``.  ``h_box`` and ``w_box`` are the TMA boxes,
    innermost first, over h as (F, C, E) and w2 as (D, F, E) (w2's 128
    columns take two boxes); ``smem_bytes`` the dynamic shared memory a
    block asks for (the ring, its barriers, 1024 bytes of alignment).
    """

    blocks: int
    col_tiles: int
    tiles: int
    row_tiles: int
    row_groups: int
    stages: int
    h_box: tuple[int, int, int]
    w_box: tuple[int, int, int]
    smem_bytes: int


def down_plan(E: int, C: int, F: int, D: int, sms: int) -> DownPlan:
    """B8's grid on a card of ``sms`` SMs, its row tiling, ring depth and
    TMA boxes (see :class:`DownPlan`)."""
    tiles = min(DOWN_MAX_TILES, max(1, math.ceil(C / DOWN_ROW_TILE)))
    tiles = 1 << (tiles - 1).bit_length()            # 1, 2 or 4
    rows = tiles * DOWN_ROW_TILE
    stages = DOWN_STAGES[tiles]
    stage = 2 * DOWN_DEPTH * (rows + DOWN_COLS)
    col_tiles = math.ceil(D / DOWN_COLS)
    return DownPlan(blocks=max(1, min(E * col_tiles, sms)),
                    col_tiles=col_tiles, tiles=E * col_tiles, row_tiles=tiles,
                    row_groups=math.ceil(C / rows), stages=stages,
                    h_box=(DOWN_DEPTH, rows, 1), w_box=(64, DOWN_DEPTH, 1),
                    smem_bytes=1024 + stages * stage + 2 * stages * 8)


def down_block_work(plan: DownPlan, C: int, D: int, x: int):
    """What block x of ``plan`` stores, indexed as the kernel does: one
    ``(expert, row ranges, column range)`` per output tile it takes, with
    one row range per m64 tile that a consumer warpgroup holds (consumer c
    takes tiles c and c + 2 of each row group), clipped to C, and the
    columns clipped to D."""
    rows = plan.row_tiles * DOWN_ROW_TILE
    consumers = min(2, plan.row_tiles)
    work = []
    for tile in range(x, plan.tiles, plan.blocks):
        e, col = divmod(tile, plan.col_tiles)
        row_tiles = []
        for rg in range(plan.row_groups):
            for c in range(consumers):
                for i in range((plan.row_tiles + 1) // 2):
                    r0 = rg * rows + (c + 2 * i) * DOWN_ROW_TILE
                    row_tiles.append(range(min(r0, C),
                                           min(r0 + DOWN_ROW_TILE, C)))
        n0 = col * DOWN_COLS
        work.append((e, row_tiles, range(min(n0, D), min(n0 + DOWN_COLS, D))))
    return work


def _pad_last(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` with its last dim zero-padded to ``n``, in a fresh buffer."""
    return F_.pad(t, (0, n - t.shape[-1])).contiguous()


# ---------------------------------------------------------------------------
# CUDA kernels B7 and B8
# ---------------------------------------------------------------------------

def _launch(fn_name: str, out, ptrs, dims) -> None:
    lib = _build.library("moe_gmm", _SIGNATURES)
    dev = out.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(getattr(lib, fn_name)(
            *(t.data_ptr() for t in ptrs), out.data_ptr(), *dims, stream),
            fn_name)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(x, ws, names, x_shape, w_shape, device, cuda: bool):
    dtypes = (torch.bfloat16,) if cuda else (x.dtype,)
    if not cuda and not x.dtype.is_floating_point:
        raise TypeError(f"{names[0]} must be a floating tensor, got {x.dtype}")
    _build.expect(x, names[0], x_shape, dtypes, device)
    for name, w in zip(names[1:], ws):
        _build.expect(w, name, w_shape, dtypes, device)


def moe_gmm(x, w1, w3, *, backend: str | None = None):
    """Gated expert up-projection (kernel B7).

    ``x``: (E, C, D); ``w1``, ``w3``: (E, D, F), all one dtype on one device
    and contiguous -> ``silu(x @ w1) * (x @ w3)``: (E, C, F) in that dtype.
    CPU tensors take the plain version, CUDA tensors launch the kernel
    (bf16 only) or raise; ``backend="torch"`` forces the plain version.
    """
    _build.forbid_autograd("moe_gmm (B7)", x, w1, w3)
    E, C, D = x.shape
    Fh = w1.shape[-1]
    dev = x.device
    cuda = _build.route(backend, dev) == "cuda"
    _check(x, (w1, w3), ("x", "w1", "w3"), (E, C, D), (E, D, Fh), dev, cuda)
    if not cuda:
        return _moe_gmm_torch(x, w1, w3)
    out = torch.empty((E, C, Fh), dtype=x.dtype, device=dev)
    if out.numel():
        _launch("moe_gmm_up_launch", out, (x, w1, w3), (E, C, D, Fh))
        moe_gmm.launches += 1
    return out


def moe_gmm_down(h, w2, *, backend: str | None = None):
    """Expert down-projection (kernel B8).

    ``h``: (E, C, F); ``w2``: (E, F, D) -> ``h @ w2``: (E, C, D), routed as
    :func:`moe_gmm`.  TMA reads rows of 16-byte multiples from 16-byte
    boundaries: other shapes (F or D not a multiple of 8) or offsets are
    zero-padded into fresh buffers first, which adds zeros to every sum.
    """
    _build.forbid_autograd("moe_gmm_down (B8)", h, w2)
    E, C, Fh = h.shape
    D = w2.shape[-1]
    dev = h.device
    cuda = _build.route(backend, dev) == "cuda"
    _check(h, (w2,), ("h", "w2"), (E, C, Fh), (E, Fh, D), dev, cuda)
    if not cuda:
        return _moe_gmm_down_torch(h, w2)
    out = torch.empty((E, C, D), dtype=h.dtype, device=dev)
    if not out.numel():
        return out
    if Fh == 0:                       # no contraction: the empty sum
        return out.zero_()
    Fp, Dp = -(-Fh // 8) * 8, -(-D // 8) * 8
    if not _build.tma_ready(h):
        h = _pad_last(h, Fp)
    if not _build.tma_ready(w2) or Fp != Fh:
        w2 = _pad_last(F_.pad(w2, (0, 0, 0, Fp - Fh)), Dp)
    res = out if Dp == D else torch.empty((E, C, Dp), dtype=h.dtype, device=dev)
    plan = down_plan(E, C, Fp, Dp, _sm_count(dev))
    _launch("moe_gmm_down_launch", res, (h, w2),
            (E, C, Fp, Dp, plan.row_tiles, plan.blocks))
    moe_gmm_down.launches += 1
    if res is not out:
        out.copy_(res[..., :D])
    return out


#: kernel launches by :func:`moe_gmm` and :func:`moe_gmm_down` (one per call
#: that ran a kernel)
moe_gmm.launches = 0
moe_gmm_down.launches = 0
