"""Chunked RG-LRU diagonal recurrence h_t = exp(log_a_t) * h_{t-1} + x_t.

PyTorch counterpart of ``repro.kernels.rglru_scan``.  Channels are
independent; the sequence runs in chunks of ``CHUNK`` = 128 steps with the
carry folded into step 0 of each chunk, and inside a chunk the affine
recurrence is composed by log-depth doubling:

    for off = 1, 2, 4, ...:   (rows t >= off, from the values before the step)
        x_t  <- exp(la_t) * x_{t-off} + x_t
        la_t <- la_t + la_{t-off}

Two versions, one contract:

- the plain PyTorch version (:func:`_rglru_scan_torch`), which follows the
  Pallas body (``_rglru_kernel``) op for op on whole (B, chunk, R) tiles.
  CPU tensors take it and ``backend="torch"`` forces it;
- the CUDA kernel B6, ``csrc/rglru_scan.cu``, which CUDA tensors take:
  persistent blocks walk tiles of 16 channels of one batch row
  (:func:`launch_plan`, :func:`block_work`), the next chunk arriving by
  ``cp.async`` while one is scanned; a warp runs the same doubling
  steps on one channel's chunk in registers, lane l holding rows l, l + 32,
  l + 64, l + 96, offsets 1-16 by warp shuffles and 32 and 64 between a
  lane's own registers (mirrored on the CPU in
  ``tests/test_torch_schedules.py``).  Built with ``--fmad=false`` (no
  fused multiply-add), it equals the plain version on the card bit for
  bit.

Against the JAX reference on the CPU the two differ at the last float32
bit: XLA's float32 ``exp`` is its own approximation, and XLA contracts the
multiply-add into one fused operation.  Given the same ``exp`` and a fused
multiply-add (the ``exp`` and ``mul_add`` arguments of the plain version),
the plain version equals the Pallas body bit for bit
(``tests/test_torch_rglru.py``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import _build

CHUNK = 128                     # the Pallas kernel's chunk (``ops.rglru_scan``)
TILE_CHANNELS = 16              # channels a tile
THREADS = 256                   # a block: 8 warps of 2 channels a tile
# two buffers of (CHUNK x TILE_CHANNELS + 1) float32 tiles of log_a and x
# and of a tile's h0, and the carries
SMEM_BYTES = 4 * (4 * CHUNK * (TILE_CHANNELS + 1) + 3 * TILE_CHANNELS)

_SIGNATURES = {"rglru_scan_launch": (5, 4)}


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _mul_add(a, b, c):
    """``a * b + c`` with two roundings, as the kernel computes it."""
    return a * b + c


def _rglru_scan_torch(log_a, x_in, h0, chunk: int = CHUNK, *,
                      exp=torch.exp, mul_add=_mul_add):
    """The Pallas body on whole (B, chunk, R) tiles, chunk by chunk."""
    B, S, R = log_a.shape
    c = min(chunk, S)
    nc = -(-S // c)
    pad = nc * c - S
    if pad:
        log_a = torch.nn.functional.pad(log_a, (0, 0, 0, pad))
        x_in = torch.nn.functional.pad(x_in, (0, 0, 0, pad))
    steps = max(1, (c - 1).bit_length())
    row = torch.arange(c, device=log_a.device)[None, :, None]
    first = row == 0
    zero = torch.zeros((), dtype=torch.float32, device=log_a.device)
    h = h0[:, None, :]
    outs = []
    for ci in range(nc):
        la = log_a[:, ci * c:(ci + 1) * c]
        xi = x_in[:, ci * c:(ci + 1) * c]
        # fold the carry into step 0: h_1 = a_1 h_0 + x_1 (every other row
        # adds 0, as the Pallas body's ``xi + where(first, ..., 0)`` does)
        xi = torch.where(first, mul_add(exp(la), h, xi), xi + zero)
        for d in range(steps):
            off = 1 << d
            la_sh = torch.roll(la, off, dims=1)
            xi_sh = torch.roll(xi, off, dims=1)
            valid = row >= off
            xi = torch.where(valid, mul_add(exp(la), xi_sh, xi), xi)
            la = torch.where(valid, la + la_sh, la)
        outs.append(xi)
        h = xi[:, -1:]
    return torch.cat(outs, dim=1)[:, :S], h[:, 0]


# ---------------------------------------------------------------------------
# CUDA kernel B6
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LaunchPlan:
    """B6's persistent grid: ``tiles`` (batch row, 16-channel) tiles walked
    by ``grid`` blocks of ``THREADS`` threads, block x taking tiles x,
    x + grid, ...; ``waves`` is tiles over the blocks the card holds at
    once (``sms`` x ``blocks_per_sm``), ``smem_bytes`` a block's dynamic
    shared memory."""

    tiles: int
    grid: int
    waves: float
    smem_bytes: int


def launch_plan(B: int, R: int, sms: int, blocks_per_sm: int) -> LaunchPlan:
    """The grid that fills ``sms`` SMs of ``blocks_per_sm`` resident blocks
    each, and no more blocks than there are tiles (a block walks every
    chunk of its tiles, whatever the sequence length)."""
    tiles = B * -(-R // TILE_CHANNELS)
    slots = max(1, sms * blocks_per_sm)
    return LaunchPlan(tiles=tiles, grid=max(1, min(tiles, slots)),
                      waves=tiles / slots, smem_bytes=SMEM_BYTES)


def block_work(plan: LaunchPlan, R: int, x: int):
    """The (batch row, channel range) pairs block ``x`` scans, in order."""
    ctiles = -(-R // TILE_CHANNELS)
    out = []
    for tile in range(x, plan.tiles, plan.grid):
        b, c = divmod(tile, ctiles)
        r0 = c * TILE_CHANNELS
        out.append((b, range(r0, min(R, r0 + TILE_CHANNELS))))
    return out


def occupancy(device) -> tuple[int, int]:
    """(blocks of ``rglru_kernel`` an SM holds, its dynamic shared memory
    in bytes) on ``device``, as the CUDA runtime reports them."""
    return _occupancy(torch.device(device))


@functools.lru_cache(maxsize=None)
def _occupancy(device) -> tuple[int, int]:
    return _build.int_outputs(_build.library("rglru_scan", {}),
                              "rglru_scan_occupancy", 2, device)


def _rglru_scan_cuda(log_a, x_in, h0):
    B, S, R = log_a.shape
    dev = log_a.device
    hs = torch.empty((B, S, R), dtype=torch.float32, device=dev)
    if S == 0:                  # nothing to scan: the carry is h0
        return hs, h0.clone()
    h_last = torch.empty((B, R), dtype=torch.float32, device=dev)
    lib = _build.library("rglru_scan", _SIGNATURES)
    plan = launch_plan(B, R, _build.sm_count(dev), occupancy(dev)[0])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.rglru_scan_launch(
            *(t.data_ptr() for t in (log_a, x_in, h0, hs, h_last)),
            B, S, R, plan.grid, stream), "rglru_scan_launch")
    rglru_scan.launches += 1
    return hs, h_last


def rglru_scan(log_a, x_in, h0, *, backend: str | None = None):
    """Chunked RG-LRU recurrence (kernel B6).

    ``log_a``, ``x_in``: (B, S, R) float32 (``log_a`` <= 0); ``h0``: (B, R)
    float32, all contiguous on one device.  Returns ``(hs, h_last)``:
    (B, S, R) and (B, R) float32.  CPU tensors take the plain version, CUDA
    tensors launch the kernel or raise; ``backend="torch"`` forces the
    plain version.  Raises ``NotImplementedError`` under autograd: B6 has
    no backward.
    """
    _build.forbid_autograd("rglru_scan (B6)", log_a, x_in, h0)
    B, S, R = log_a.shape
    dev = log_a.device
    cuda = _build.route(backend, dev) == "cuda"
    _build.expect(log_a, "log_a", (B, S, R), (torch.float32,), dev)
    _build.expect(x_in, "x_in", (B, S, R), (torch.float32,), dev)
    _build.expect(h0, "h0", (B, R), (torch.float32,), dev)
    if not cuda:
        return _rglru_scan_torch(log_a, x_in, h0)
    return _rglru_scan_cuda(log_a, x_in, h0)


#: kernel launches by :func:`rglru_scan` (one per call that ran the kernel)
rglru_scan.launches = 0
