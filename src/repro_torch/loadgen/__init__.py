"""Latency-SLO load harness: traffic generation over the serving stack.

PyTorch counterpart of ``repro.loadgen``; the harness is host code and the
same as the reference's, over the port's ``serve`` and ``stream``:

- :mod:`arrivals` — Poisson / diurnal (thinned inhomogeneous Poisson) /
  bursty (2-state MMPP) arrival processes, deterministic per seed;
- :mod:`workload` — request mixes over discrete signature populations:
  the filterless mask-dedup fast path, the distinct-mask worst case, and
  blends;
- :mod:`harness` — a closed-loop virtual-time replay: arrivals run on a
  virtual clock, each drain's service time is the measured wall time of the
  real batched dispatch (on CUDA it ends in the device-to-host copies, so
  it holds the device's time), and every ticket's end-to-end latency
  streams into the lock-guarded histograms on ``AdmissionStats`` /
  ``ServeStats``.
"""
from .arrivals import MMPP2, Arrivals, Diurnal, Steady  # noqa: F401
from .harness import (LoadHarness, LoadReport, VirtualClock)  # noqa: F401
from .workload import (DEFAULT_AMOUNTS, DEFAULT_WEIGHTS, RequestMix,  # noqa: F401
                       distinct_mask_mix, filterless_mix, mixed_mix)
