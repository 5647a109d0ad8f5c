"""The yardstick of the kernels' roofline shares: the H100's peaks and the
bytes and operations each hand-written kernel's call needs.

Frozen here so that a change to the program cannot move them.

- Peaks: NVIDIA's data sheet for one H100 SXM at its 700 W limit (dense
  rates), copied from ``src/repro_torch/launch/hw.py``.
- B1 (``score_fuse_batch``): ``chip_smoke.py`` ``kernel_phase``'s count at
  (B, K, U), as ``PERF.md``'s kernel table bounds B1.
- B2 (``pool_scan``): ``chip_smoke.py`` ``pool_scan_bound``.

A call's least time is the larger of its bytes at the HBM bandwidth and its
operations at the float32 rate; every input byte is counted read once and
every output byte written once.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # HBM3
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12


def least_s(nbytes: float, nops: float) -> float:
    """A call's least time on the card, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S)


def score_fuse_work(B: int, K: int, U: int) -> tuple[int, int]:
    """B1's bytes and operations for B requests over K candidates with U
    distinct filter masks: the three statistics and three catalog columns
    read, the B masks and U unique masks, the per-request scalars, three
    (B, K) float32 score rows written, the U extrema and B cost floors."""
    nbytes = (4 * 6 * K + B * K + U * K + 4 * 5 * B + 4 * 3 * B * K
              + 4 * 6 * U + 4 * B)
    nops = 24 * B * K + 6 * U * K + 4 * B * K
    return nbytes, nops


def pool_scan_work(B: int, K: int, scanned: int) -> tuple[int, int]:
    """B2's bytes and operations: the (B, K) int32 counts row written, s, c
    and the prefix sums read up to each request's stop (``scanned`` lanes
    over the batch), three words a request; a division pair and a few
    compares a scanned lane."""
    nbytes = 4 * B * K + 12 * scanned + 4 * 3 * B
    nops = 16 * scanned
    return nbytes, nops

