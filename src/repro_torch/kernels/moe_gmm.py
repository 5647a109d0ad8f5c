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
- the CUDA kernels B7/B8, ``csrc/moe_gmm.cu``, which CUDA tensors take:
  one Hopper template for both.  Both are bound by bytes (B7 moves 844 MB
  at DeepSeek-V2-Lite's prefill, C = 240, and 742 MB at decode, C = 8), so
  each output tile (one expert's ``UP_COLS`` = 64 columns of w1 and of w3
  for B7, ``DOWN_COLS`` = 128 columns of w2 for B8) is owned by one block
  with all its rows and each weight byte is read once; the grid is
  persistent (one block an SM); a producer thread keeps a ring of TMA
  loads in flight and two consumer warpgroups run ``wgmma``, B7 computing
  ``[x @ w1 | x @ w3]`` side by side in one product.  The launch geometry
  is planned here (:func:`gmm_plan`), where the CPU tests can check it.

They agree to float32 summation order: the kernel adds its products in
another order than the float32 einsum, so an element can land one bf16
ulp apart after the final cast.

Neither has a backward (nor has the reference's Pallas call): under
autograd the wrappers raise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F_

from . import _build

_SIGNATURES = {"moe_gmm_up_launch": (4, 6), "moe_gmm_down_launch": (3, 6)}

# B7's and B8's launch geometry (csrc/moe_gmm.cu)
GMM_DEPTH = 64           # contraction steps a ring stage (one swizzle row)
GMM_ROW_TILE = 64        # rows of one wgmma tile
GMM_MAX_TILES = 4        # m64 tiles a row group: two per consumer warpgroup
GMM_STAGES = {1: 8, 2: 6, 4: 4}   # ring depth by m64 tiles a row group
UP_COLS = 64             # B7: output columns a tile (w1's box beside w3's)
DOWN_COLS = 128          # B8: output columns a tile (two boxes of w2)


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
# B7's and B8's launch plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GmmPlan:
    """Where B7's or B8's blocks go for (E, C, K) x (E, K, N).

    The output falls into ``tiles`` = E x ``col_tiles`` tiles of ``cols``
    columns of one expert, all C rows each (tile t: expert t // col_tiles,
    columns ``cols * (t % col_tiles)``).  The grid is persistent: ``blocks``
    blocks, at most one an SM, block x taking tiles x, x + blocks, ...  A
    tile's rows run in ``row_groups`` groups of ``row_tiles`` m64 tiles,
    its contraction in ``GMM_DEPTH`` steps through a ring of ``stages``.
    ``a_box`` and ``w_box`` are the TMA boxes, innermost first, over the
    activations as (K, C, E) and each weight as (N, K, E); a stage holds
    one activation box and two weight boxes (B8: w2's columns n0 and n0 +
    64; B7: w1's and w3's columns n0).  ``smem_bytes`` is the dynamic
    shared memory a block asks for (the ring, its barriers, 1024 bytes of
    alignment).
    """

    blocks: int
    cols: int
    col_tiles: int
    tiles: int
    row_tiles: int
    row_groups: int
    stages: int
    a_box: tuple[int, int, int]
    w_box: tuple[int, int, int]
    smem_bytes: int


def gmm_plan(E: int, C: int, K: int, N: int, sms: int, *, up: bool) -> GmmPlan:
    """B7's (``up``) or B8's grid on a card of ``sms`` SMs, its row tiling,
    ring depth and TMA boxes (see :class:`GmmPlan`)."""
    tiles = min(GMM_MAX_TILES, max(1, math.ceil(C / GMM_ROW_TILE)))
    tiles = 1 << (tiles - 1).bit_length()            # 1, 2 or 4
    rows = tiles * GMM_ROW_TILE
    stages = GMM_STAGES[tiles]
    stage = 2 * GMM_DEPTH * (rows + 2 * 64)
    cols = UP_COLS if up else DOWN_COLS
    col_tiles = math.ceil(N / cols)
    return GmmPlan(blocks=max(1, min(E * col_tiles, sms)), cols=cols,
                   col_tiles=col_tiles, tiles=E * col_tiles, row_tiles=tiles,
                   row_groups=math.ceil(C / rows), stages=stages,
                   a_box=(GMM_DEPTH, rows, 1), w_box=(64, GMM_DEPTH, 1),
                   smem_bytes=1024 + stages * stage + 2 * stages * 8)


def gmm_block_work(plan: GmmPlan, C: int, N: int, x: int):
    """What block x of ``plan`` stores, indexed as the kernel does: one
    ``(expert, row ranges, column range)`` per output tile it takes, with
    one row range per m64 tile that a consumer warpgroup holds (consumer c
    takes tiles c and c + 2 of each row group), clipped to C, and the
    columns clipped to N."""
    rows = plan.row_tiles * GMM_ROW_TILE
    consumers = min(2, plan.row_tiles)
    work = []
    for tile in range(x, plan.tiles, plan.blocks):
        e, col = divmod(tile, plan.col_tiles)
        row_tiles = []
        for rg in range(plan.row_groups):
            for c in range(consumers):
                for i in range((plan.row_tiles + 1) // 2):
                    r0 = rg * rows + (c + 2 * i) * GMM_ROW_TILE
                    row_tiles.append(range(min(r0, C),
                                           min(r0 + GMM_ROW_TILE, C)))
        n0 = col * plan.cols
        work.append((e, row_tiles, range(min(n0, N), min(n0 + plan.cols, N))))
    return work


def acc_position(t: int, i: int) -> tuple[int, int]:
    """(row, column) in a 64 x 128 float32 wgmma tile of accumulator
    register ``i`` of thread ``t`` of the warpgroup (``hopper.cuh``)."""
    return (16 * (t // 32) + (t % 32) // 4 + 8 * ((i // 2) % 2),
            8 * (i // 4) + 2 * (t % 4) + i % 2)


def up_epilogue(t: int):
    """What B7's epilogue of thread ``t`` stores, in the kernel's order:
    ``(row, column, w1 register, w3 register)`` of a 64-row, 64-column
    output tile, the w1 product in columns 0-63 of the accumulator and the
    w3 product in columns 64-127."""
    row0 = 16 * (t // 32) + (t % 32) // 4
    for half in range(2):
        for j in range(UP_COLS // 8):
            for q in range(2):
                k = 4 * j + 2 * half + q
                yield row0 + 8 * half, 8 * j + 2 * (t % 4) + q, k, k + 32


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


def _check(x, ws, names, x_shape, w_shape, device, cuda: bool):
    dtypes = (torch.bfloat16,) if cuda else (x.dtype,)
    if not cuda and not x.dtype.is_floating_point:
        raise TypeError(f"{names[0]} must be a floating tensor, got {x.dtype}")
    _build.expect(x, names[0], x_shape, dtypes, device)
    for name, w in zip(names[1:], ws):
        _build.expect(w, name, w_shape, dtypes, device)


def _run_tiles(fn_name: str, out, a, ws, *, up: bool) -> bool:
    """Launch B7 (``up``) or B8 into ``out`` (E, C, N) from ``a`` (E, C, K)
    and the weights ``ws`` (E, K, N); False, with ``out`` zeroed and nothing
    launched, when K is 0 (the empty sum).  TMA reads rows of 16-byte multiples
    from 16-byte boundaries: other shapes (K or N not a multiple of 8) or
    offsets are zero-padded into fresh buffers first, which adds zeros to
    every sum (and silu(0) * 0 = 0 to B7's padded columns, cut off)."""
    E, C, K = a.shape
    N = out.shape[-1]
    if K == 0:
        out.zero_()
        return False
    Kp, Np = -(-K // 8) * 8, -(-N // 8) * 8
    if not _build.tma_ready(a):
        a = _pad_last(a, Kp)
    if Kp != K or not all(_build.tma_ready(w) for w in ws):
        ws = [_pad_last(F_.pad(w, (0, 0, 0, Kp - K)), Np) for w in ws]
    res = out if Np == N else torch.empty((E, C, Np), dtype=out.dtype,
                                          device=out.device)
    plan = gmm_plan(E, C, Kp, Np, _build.sm_count(out.device), up=up)
    _launch(fn_name, res, (a, *ws), (E, C, Kp, Np, plan.row_tiles, plan.blocks))
    if res is not out:
        out.copy_(res[..., :N])
    return True


def moe_gmm(x, w1, w3, *, backend: str | None = None):
    """Gated expert up-projection (kernel B7).

    ``x``: (E, C, D); ``w1``, ``w3``: (E, D, F), all one dtype on one device
    and contiguous -> ``silu(x @ w1) * (x @ w3)``: (E, C, F) in that dtype.
    CPU tensors take the plain version, CUDA tensors launch the kernel
    (bf16 only) or raise; ``backend="torch"`` forces the plain version.
    D or F not a multiple of 8, or misaligned operands, are zero-padded
    into fresh buffers first (see :func:`_run_tiles`).
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
    if out.numel() and _run_tiles("moe_gmm_up_launch", out, x, (w1, w3),
                                  up=True):
        moe_gmm.launches += 1
    return out


def moe_gmm_down(h, w2, *, backend: str | None = None):
    """Expert down-projection (kernel B8).

    ``h``: (E, C, F); ``w2``: (E, F, D) -> ``h @ w2``: (E, C, D), routed and
    padded as :func:`moe_gmm`.
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
    if out.numel() and _run_tiles("moe_gmm_down_launch", out, h, (w2,),
                                  up=False):
        moe_gmm_down.launches += 1
    return out


#: kernel launches by :func:`moe_gmm` and :func:`moe_gmm_down` (one per call
#: that ran a kernel)
moe_gmm.launches = 0
moe_gmm_down.launches = 0
