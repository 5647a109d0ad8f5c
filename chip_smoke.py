#!/usr/bin/env python3
"""Drive the PyTorch port's serving, live-ingest, K-sharded and quantized
archive paths, the paper's simulated-cloud pipeline (collector, ingestion,
admission, baselines, load harness), LM serving (DeepSeek-V2-Lite,
RWKV6-7B, RecurrentGemma-2B), and qwen2-0.5b's full-sequence forward and
training step, on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all pass):

1. Print the card's name and power limit; build the CUDA kernels of
   ``src/repro_torch/csrc`` (one nvcc per source, started together).
2. Kernel phase: at the main path's shapes (K = 32768 candidates, B = 16
   requests), run kernel B1 ``score_fuse`` with one unique filter mask
   (U = 1) and with region/family filters (U > 1), and kernel B2
   ``pool_scan`` on the resulting sorted rows.  Each result must equal the
   kernel's plain PyTorch version on the same inputs bit for bit.  Times
   each kernel and its plain version, B1's ``score_reduce_kernel`` and
   ``score_emit_kernel`` also one by one, and prints B1's launch plan:
   blocks, blocks an SM and waves of each kernel, and B2's (clusters,
   tiles a block, clusters resident at once).  B2 also runs at B = 16,
   K = 32768 on rows built to stop at k = 0, at the last lane of its tile 0,
   at the first lane of its second step (the blocks' first tiles, 8192
   lanes, hold no stop) and never: bit-identical to the plain version, each
   timed beside its bound.
3. Main path: a seeded K = 32768, T = 1008 archive (132 MB of float32 T3 on
   the card) served through ``BatchServer.serve`` for 3 x 16 mixed
   requests, with the kernels' launch counters reset just before and read
   just after.  The same requests then run on the CPU (plain versions) on
   an archive holding the card's statistics: score rows must be
   bit-identical, and pools identical except where the decision-margin
   replay puts a decision within float32 rounding of the two devices'
   prefix sums (a tie, counted and printed).  Also counts the served
   single-type pools above ceil(R / c0) nodes (F5 in ROADMAP C; printed,
   not a gate).
4. Live-ingest path (float32, int8, then bfloat16): a seeded synthetic
   feed over the same K = 32768 catalog primes a rolling archive of
   capacity 1008 with 504 columns through ``EngineConfig.build_ingestor``,
   then absorbs 1512 ticks (504 growing, 1008 sliding: one wrap; 600 on
   int8 and bf16) through
   ``LiveIngestor.poll``, kernel B3 ``stats_update`` once per tick, with the
   launch counters reset just before and read just after.  Every tick is
   replayed through B3's plain version on the same inputs (bit-identical
   moments and statistics required).  At three versions 16 mixed requests
   are served through ``AdmissionQueue`` drains and compared with a CPU run
   on the snapshot's statistics as in phase 3; the final statistics are held
   against ``candidate_stats`` of the window at RTOL 1e-5 / ATOL 1e-4 and
   the window against the feed.  Prints append latency, B3's times and
   the kernels and copies the device runs a poll.
5. Shard phase (``shard_phase``): the generator at K = 2^20, T = 1008
   (T3 drawn in float32), staged as (a) a float32 archive, (b) a float32
   archive of 4 shards on the one card, (c) an int8 and (d) a bf16
   quantized archive, (e) an int8 archive of 4 shards; each tier's
   ``nbytes`` printed beside the growth of ``memory_allocated``.  16 mixed
   requests are served from (b) and (e) with the launch counters reset
   just before and read just after (B1's phase 0, ``score_fuse_phase0``,
   and its emit with given scalars once a shard and batch, B2 once a
   batch) and every launch's operands captured; each captured launch is
   then held against its plain version bit for bit and timed.  (b) must
   equal (a) and (e) equal (c) bit for bit (all seven batch arrays, the
   served pools, ``score_archive``'s rows); (c) and (d) must give (a)'s
   pools except where ``core.quantized`` flags a tie (counted, with the
   decision-margin quantiles); (c) and (e) are compared with a CPU run on
   their statistics as in phase 3.  Serve p50 / p90 over 20 calls for (a),
   (b), (c), (e) and a profiled (b) serve's idle share.  Then an int8
   ``LiveIngestor(shards=4)`` ring (capacity 1008, 504 primed) absorbs 100
   ticks: B3 once a shard and tick (400 launches), each replayed through
   its plain version bit for bit, the final statistics held against
   ``candidate_stats`` of each shard's window (RTOL 1e-5, ATOL 1e-4).
5b. Simulator phase (``sim_phase``): the paper's own pipeline through the
   port's ``cloudsim``, ``core`` and ``loadgen`` at the full default
   catalog (128 types x 50 AZs in 17 regions: K = 6400 pools, aws
   profile, seed 0).  A rate-limited ``SPSQueryService`` of 2000 accounts
   (50 scenarios / 24 h each) answers a USQS ``DataCollector`` whose
   ``BudgetedProbeScheduler`` probes 640 targets a cycle (int8 host ring of
   1008); 504 cycles (half a week; the quota window expires from cycle
   144 on) prime a float32 ``LiveIngestor`` ring of 1008 on the card, then
   48 more cycles each end in ``poll()`` (B3 once, every tick replayed
   through its plain version bit for bit), and at ticks 16, 32 and 48 16
   mixed requests go through an ``AdmissionQueue`` drain, held against a
   CPU run on the snapshot's statistics as in phase 3.  ``entropy_bits``
   on the card's histogram of the ring's T3 must equal the host's
   ``empirical_entropy`` within 1e-6 bits.  One window of
   ``benchmarks/fig18_19_recommendation.py``'s protocol on the contended
   pools: the card's single-type picks at W = 0, 0.5, 1 against SpotVerse
   (T = 4, 6), SpotFleet (LP, CO, PCO) and naive single-point picks, each
   probed for a day (``probe_real_availability``), and an interruption
   experiment on SpotVista's W = 0.5 pool with Kaplan-Meier and Cox on its
   lifetimes (printed as simulator outcomes, not card numbers).  Then
   ``benchmarks/latency_slo.py``'s load harness on the last snapshot
   (buckets 1, 8, 64; max wait 50 ms; rates calibrated to 0.6 of the
   measured capacity): Steady and MMPP2 on the filterless and 64-filter
   distinct-mask mixes, and the mixed mix at 2x capacity with shed depth
   128; every ledger must balance.  B1's and B2's counters are set to 0
   before each serving segment and read after it, every launch captured
   and held against its plain version bit for bit; the phase fails if any
   of B1, B2, B3 never launched.  Prints the phase's seconds against its
   120 s budget, seconds a cycle, queries and accounts holding scenarios.
6. LM phases, one per architecture, each through ``lm_phase``:
   DeepSeek-V2-Lite (27 layers, 15.7 B parameters), ``rwkv6-7b`` (32
   layers, 8.88 B) and ``recurrentgemma-2b`` (26 layers, 3.55 B) at full
   width and depth, bf16 weights from a seeded ``torch.Generator`` on the
   card, ``use_pallas=True``.  Each serves 16 prompts of 128 seeded tokens
   through ``Model.prefill`` and 31 greedy ``Model.decode_step``s, the
   launch counters of its kernels reset just before and read just after:
   B7/B8 (``moe_gmm``) must launch once per MoE layer and forward (832
   times); B5 ``rwkv6_scan`` (B6 ``rglru_scan``) once per rwkv (rglru)
   layer of the prefill, 32 (18) times, decode taking the reference's step
   functions.  On the operands captured from the first such layer, each
   kernel is held against its plain version: B7 and B8 at prefill and at a
   decode step (one bf16 ulp or 1e-3 * max); B5 as captured, with a seeded
   random ``u`` (the model's is drawn as zeros, which leaves the bonus term
   untested) and on a 77-step prefix from the state the first check ends
   in, each output within ``WKV_TOL`` of its own max|plain|; B6 as captured
   and on the 77-step prefix, bit for bit, and its persistent grid (tiles,
   blocks, blocks an SM, waves) printed.  The same weights then serve
   again through the reference's plain route (``use_pallas=False``) and
   greedy tokens are compared; for DeepSeek-V2-Lite a sequence may part from
   it only at a step whose top-1 / top-2 logit margin is under twice the
   prefill's max |delta logits|.  The random full-depth models amplify
   rounding to the size of their logits (printed: the logits' response to
   a one-ulp step of one embedding element), so the routes are also held
   layer by layer: on the same input, each layer's update through the
   kernels must lie within ``LAYER_TOL`` of its norm from the plain
   route's, at prefill and at a decode step.  Prints prefill and decode
   times, tokens/s, a profiled decode step, and the kernels' times and
   bounds.  Each model is freed before the next.
7. Forward phase: ``qwen2-0.5b`` at full width and depth (24 layers,
   d_model 896, 14 query heads over 2 KV heads of 64; 494 M parameters
   drawn on the card), ``Model.forward(train=False)`` with
   ``use_pallas=True`` on the first batch of ``make_pipeline(cfg, 4096,
   8)`` (train_4k's sequence length; its batch of 256 cut to 8 to fit one
   card).  B4 ``flash_attention`` must launch once per layer (24 times) at
   (8, 4096, 14, 64) with 2 KV heads; it is held against its plain version
   (one bf16 ulp or 2^-7 * max|v|) on the first layer's captured q, k, v, on
   prefixes of 4000 and 77 rows of them, and on seeded inputs with G = 1,
   D = 128, S = 1000; each layer's update against the plain route
   (``use_pallas=False``, the chunked attend) and against the same layer
   in float32, within ``FWD_LAYER_TOL`` (the random init's attention is
   nearly a hard max; see there).
   Prints forward p50 / p90 over 5 calls, tokens/s, a profiled forward's
   idle share, and B4's times, bound and
   ``scaled_dot_product_attention``'s time (timed only; the port never
   calls it).
8. Train phase: the same model and initial parameters through
   ``build_train_step`` on the reference's training route
   (``use_pallas=False``), ``TrainConfig(grad_accum=2)``, 3 steps of 8 x
   4096 tokens from ``make_pipeline``.  Loss and gradient norm finite and
   positive, the parameters moved, ``lr`` equal to ``lr_schedule``, B4 never
   launched, and the first loss within 1e-2 (relative) of the
   cross-entropy of the forward phase's B4 logits on the same batch.
   Prints step time, tokens/s, peak memory, the model-FLOP share and a
   profiled fourth step.
9. Print B4's time over SDPA's, B8's over ``torch.bmm``'s and B7's over
   ``torch.bmm(x, cat([w1, w3], -1))``'s (the two products alone, a
   yardstick, not ``library_ms``: no one call computes B7), prefill and
   decode, each pair from this run; the first versions' times of B5 and B7
   and the previous times of B1, B6, B2 and B3 (from PERF.md) beside this
   run's;
   the ``kernels`` JSON line, the card line, and last the ``ok`` line.

Kernel device times come from ``torch.profiler``, summed over the kernels
of the wrapper's own symbol (B4 ``flash_kernel``, B7 ``gmm_up_kernel``, B8
``gmm_down_kernel``, ...); a trace with device time but none under that
name fails, so a renamed kernel cannot pass as an event time; a trace that
lost device records is taken again (``profiled``).  The build
lines print each kernel's ptxas registers and spills and the dynamic
shared memory of B4, B7, B8 and B5.

Exits non-zero without printing a result when CUDA is unavailable or when
the ``src/repro_torch`` package is not beside this script.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
K_FULL = 32768
T_FULL = 1008          # 7 days of 10-minute samples
B_FULL = 16
N_CALLS = 3            # serve() calls of B_FULL requests on the main path
BUCKETS = (1, 8, 16, 64, 256)   # the default ladder plus 16: one batch a call
TIME_REPS = 50
LATENCY_CALLS = 100    # serve() calls timed for p50 / p90 (10 samples above)

# live-ingest phase: a ring of one week of 10-minute samples, primed with
# half of it, then one full wrap (504 growing ticks, 1008 sliding ones)
INGEST_WINDOW = 1008
INGEST_PRIME = 504
INGEST_TICKS = {"float32": 1512, "int8": 600, "bfloat16": 600}
INGEST_SERVE_AT = {"float32": (504, 1008, 1512), "int8": (600,),
                   "bfloat16": (600,)}
# bytes a stored sample of each ring tier
TIER_BYTES = {"float32": 4, "int8": 1, "bfloat16": 2}
# float operations of one candidate's tick in kernel B3: ten compensated
# adds of 4, the update's 7 products and differences, the derivation's 21
# (4 more decodes on the int8 tier)
B3_FLOPS = 68

# Shard phase: the same generator at K = 2^20 candidates (T3 drawn in
# float32, 65536 rows at a time), served from float32, int8 and bf16 static
# archives and from 4-shard float32 and int8 ones on the one card; then an
# int8 4-shard ring, capacity 1008, 504 columns primed and 100 ticks
K_BIG = 2 ** 20
BIG_CHUNK = 65536
BIG_SHARDS = 4
BIG_SERVE_CALLS = 20     # serve() calls timed for p50 / p90 on each archive
BIG_PRIME = 504
BIG_TICKS = 100

# Simulator phase: the paper's pipeline over the full default catalog (128
# types x 50 AZs in 17 regions = 6400 pools) with the quickstart's 2000
# accounts.  A budgeted scheduler probes 640 targets a cycle (each target
# about every 100 minutes); half a week is collected before the ring is
# primed, then ticks are absorbed one by one.
SIM_ACCOUNTS = 2000
SIM_BUDGET = 640
SIM_PRIME = 504
SIM_TICKS = 48
SIM_SERVE_AT = (16, 32, 48)
SIM_REGIONS = ("us-east-1", "eu-west-1", "ap-northeast-1")
SIM_BUDGET_S = 120.0
# one window of benchmarks/fig18_19_recommendation.py's protocol
SIM_NODES = 24
SIM_HORIZON = 1440.0
# the interruption experiment's request: 64 vCPUs a node, which the W = 0.5
# pool covers with several types (a 96-vCPU request takes one node)
SIM_POOL_CPUS = SIM_NODES * 64.0
# benchmarks/latency_slo.py's load harness settings
SLO_BUCKETS = (1, 8, 64)
MAX_WAIT_S = 0.05
UTILIZATION = 0.6
OVERLOAD = 2.0
SHED_DEPTH_BUCKETS = 2
SLO_HORIZON_S = 4.0
SLO_MARGIN = 3.0
# entropy_bits on the card against empirical_entropy on the host, in bits
ENTROPY_TOL = 1e-6

# LM phases: the serving paths of three architectures at their published
# widths and depths, the same batch, prompt and decode length for each
LM_ARCHS = ("deepseek-v2-lite-16b", "rwkv6-7b", "recurrentgemma-2b")
LM_BATCH = 16
LM_PROMPT = 128
LM_NEW = 32            # the prefill's token, then 31 decode steps
LM_SEED = 0
# a layer's update may differ between the kernel and plain routes by this
# share of its norm (bf16 rounding of the kernels' outputs)
LAYER_TOL = 2e-2
# B5 is held to its plain version within WKV_TOL of each output's max|plain|
# (the chunk's cumsum and contractions sum in another order), B6 bit for bit
WKV_TOL = 1e-4
RAGGED_S = 77          # a prompt length that is no multiple of either chunk

# forward and train phases: qwen2-0.5b at full width and depth over
# train_4k's sequence length; its global batch of 256 is cut to 8 to fit
# one card
FWD_ARCH = "qwen2-0.5b"
FWD_BATCH = 8
FWD_SEQ = 4096
FWD_CALLS = 5          # timed forwards for p50 / p90
FLASH_PREFIXES = (4000, RAGGED_S)   # B4 also held on these query lengths
# B4 against its plain version: the two sum the scores in another order,
# so an attention weight p can round to the neighbouring bf16 value before
# the P V product, which moves an output by up to one bf16 ulp of p (2^-7
# of p at most) times v, and so by at most 2^-7 * max|v| over the row.  On
# the model's peaked attention that exceeds the B7/B8 contract (one ulp or
# 1e-3 * max|out|) in a few dozen of the 29 M outputs (the forward report's
# ``beyond_b7_b8_contract``); seeded normal inputs meet it.
FLASH_P_ULP = 2.0 ** -7
TRAIN_STEPS = 3
TRAIN_ACCUM = 2
# A layer's update through B4 may differ from the plain route's, and from
# the same layer in float32, by this share of its norm.  The reference's
# init takes a 3-D weight's fan-in over its heads: 14 for wq, 2 for wk and
# wv, not the 896 inputs.  So q has a spread of 8, k and v of 21, the
# scores of ~170, and the softmax is nearly a hard max, where any bf16
# rounding moves the update by several percent: the plain route rounds
# the scores to bf16 (its einsum returns bf16), B4 keeps them in float32
# from bf16 q and k.  At full width (2-3 layers, S = 2048, on the CPU) the
# routes differ by 6.1-6.6% of the update, B4 lies 6.2-6.8% and the plain
# route 8.5-8.6% from float32; the forward report prints all three on the
# card.
FWD_LAYER_TOL = 0.1
# the first train loss (plain attention) against the cross-entropy of the
# B4 forward's logits on the same batch and parameters, relative
TRAIN_CE_TOL = 1e-2

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, float32
# rate outside the tensor cores, dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12

# the first versions' device times of the kernels rebuilt since, as
# recorded in PERF.md (measured on one NVIDIA H100 80GB HBM3, 700 W),
# printed beside this run's
FIRST_VERSION_MS = {"rwkv6_scan": 0.544,
                    "moe_gmm": {"prefill": 0.810, "decode": 0.260}}
# B1's, B6's, B2's and B3's device times before their rebuilds, as recorded
# in PERF.md (one NVIDIA H100 80GB HBM3, 700 W): B2's two kernels without
# the memset its launch issued before them, B3's float32 tier
PREVIOUS_MS = {"score_fuse": 0.0247, "rglru_scan": 0.0471,
               "pool_scan": 0.00769, "stats_update": 0.00165}
# B2's edge rows: all-ones scores and capacities with R = 2e9 never stop
# (top[k] = ceil(2e9 / (k + 1)) falls at every lane of K = 32768); a zero
# score stops the scan at its lane
NEVER_R = 2e9


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def candidates(K: int, T: int, seed: int = 0, *, t3_chunk: int | None = None):
    """The seeded archive generator of ``benchmarks/latency_slo.py``.  With
    ``t3_chunk`` the T3 window is drawn in float32, uniform on [0, 50), a
    ``t3_chunk``-row block from each generator seeded ``(seed, block)``, the
    blocks in threads: half the host memory of the float64 draw, and a
    fraction of its time at K = 2^20."""
    from repro_torch.core.types import CandidateSet
    rng = np.random.default_rng(seed)
    fams = rng.choice(["m5", "c5", "r5", "t3"], K)
    cols = dict(
        names=np.array([f"{fams[i]}.x{i}" for i in range(K)]),
        regions=rng.choice(["us-east-1", "eu-west-1", "ap-north-1"], K),
        azs=rng.choice(["a", "b", "c"], K),
        families=fams,
        categories=rng.choice(["general", "compute", "memory"], K),
        vcpus=rng.choice([2, 4, 8, 16, 32, 64, 96], K).astype(np.float64),
        memory_gb=rng.choice([4, 8, 16, 64, 128, 384], K).astype(np.float64),
        prices=rng.uniform(0.01, 5.0, K))
    if t3_chunk is None:
        return CandidateSet(**cols, t3=rng.uniform(0.0, 50.0, (K, T)))
    from concurrent.futures import ThreadPoolExecutor
    t3 = np.empty((K, T), np.float32)

    def block(a: int) -> None:
        out = t3[a:a + t3_chunk]
        np.random.default_rng((seed, a // t3_chunk)).random(
            out=out, dtype=np.float32)
        out *= np.float32(50.0)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(block, range(0, K, t3_chunk)))
    return CandidateSet(**cols, t3=t3)


def mixed_requests(rng, n: int, *, filtered: bool = True,
                   regions=("us-east-1", "eu-west-1", "ap-north-1")):
    """Filterless by CPU, region- and family-filtered, by memory, one with
    ``max_types``, one with W = 1; the region filters take ``regions``."""
    from repro_torch.core.types import ResourceRequest
    reqs = []
    for i in range(n):
        kw = dict(weight=float(rng.uniform(0.2, 0.8)),
                  lam=float(rng.uniform(0.05, 0.3)))
        kind = i % 8 if filtered else 0
        if kind == 5:
            kw["memory_gb"] = float(rng.choice([64, 256, 1024, 4096]))
        else:
            kw["cpus"] = float(rng.choice([64, 128, 256, 512, 1000, 4096]))
        if kind in (3, 4):
            kw["regions"] = [regions[i % 3]]
        if kind == 4:
            kw["families"] = ["c5", "m5"]
        if kind == 6:
            kw["max_types"] = 2
        if kind == 7:
            kw["weight"] = 1.0
        reqs.append(ResourceRequest(**kw))
    return reqs


def same_bits(a, b) -> bool:
    """Equal values, NaN where the other is NaN (``-0.0 == 0.0``)."""
    import torch
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def profiled(fn, calls: int, tries: int = 3) -> dict:
    """Every device item (kernel, memcpy, memset) of ``calls`` calls of
    ``fn`` from a ``torch.profiler`` trace: ``{name: (launches a call, device
    ms a call, share of its launches recorded)}``.  The profiler can lose
    device records (PERF.md, PR 22), which would read as a faster kernel:
    so a discarded warm-up step comes first, an item's launches a call are
    its recorded count over ``calls`` rounded (at least 1), its time the
    mean of its recorded launches times that, and a trace that holds no
    device item or lost a tenth of an item's launches is taken again, up to
    ``tries`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for n in (1, calls):     # the warm-up step, then the traced one
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        items = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or e.count == 0:
                continue
            n = max(1, round(e.count / calls))
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            items[e.key] = (n, us / e.count * n / 1e3, e.count / (n * calls))
        lost = [k for k, (_, _, kept) in items.items() if kept < 0.9]
        if items and not lost:
            break
        print(f"profiler trace {attempt + 1} of {calls} calls lost device "
              f"records: {lost[:3] or 'all'}")
    return items


def time_ms(fn, names: tuple[str, ...] | None, per_name: dict | None = None,
            matched: dict | None = None):
    """Median per-call CUDA-event time, and the per-call device time of the
    kernels whose names contain one of ``names`` (all kernels if ``None``)
    from a ``torch.profiler`` trace; the latter is ``None`` if the profiler
    records no device time.  ``per_name``, if given, receives each of
    ``names``' own per-call device time; ``matched`` the full name of every
    device item counted, with its launches and device ms a call and the
    share of its launches the trace recorded (``profiled``)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(TIME_REPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    call_ms = float(np.median([a.elapsed_time(b) for a, b in pairs]))
    prof_ms = None
    try:
        items = profiled(fn, TIME_REPS)
    except RuntimeError as err:   # no CUPTI on this machine: events only
        print(f"profiler unavailable ({err}); kernel time from events")
        return call_ms, None
    if not items:
        fail(f"the profiler recorded no device item of {names} in a trace")
    total_ms, seen = 0.0, []
    for key, (n, ms, kept) in items.items():
        if ms > 0:
            seen.append(key)
        if names is None or any(name in key for name in names):
            total_ms += ms
            if matched is not None and ms > 0:
                matched[key] = dict(launches=n, recorded=kept, ms=ms)
        for name in names or ():
            if per_name is not None and name in key:
                per_name[name] = per_name.get(name, 0.0) + ms
    if seen and total_ms == 0:
        # a renamed kernel must not turn a profiler time into an event time
        fail(f"the profiler recorded device time, but under no kernel named "
             f"{names}: {sorted(seen)[:8]}")
    prof_ms = total_ms if total_ms > 0 else None
    return call_ms, prof_ms


def kernel_time(torch, kfn, pfn, knames, nbytes: int, nops: int,
                matched: dict | None = None) -> dict:
    """A kernel's device time a call (``time_ms``: the profiler, else CUDA
    events; ``kernel_ms`` by kernel name, ``matched`` as there), its plain
    version's, and its bound: the larger of ``nbytes`` at 3.35 TB/s and
    ``nops`` at 67 TFLOP/s float32."""
    split = {}
    call_ms, dev_ms = time_ms(kfn, knames, split, matched)
    plain_call_ms, plain_dev_ms = time_ms(pfn, None)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return dict(ms=dev_ms if dev_ms is not None else call_ms,
                ms_source="profiler" if dev_ms is not None else "events",
                call_ms=call_ms,
                plain_ms=plain_dev_ms if plain_dev_ms is not None
                else plain_call_ms,
                plain_call_ms=plain_call_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=nops, kernel_ms=split)


def score_plan_line(torch, sf, K, rows, B, args) -> dict:
    """B1's grids at this call (``score_plan``), the blocks of each kernel
    an SM holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the
    waves they make on this card; printed and returned."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stats, prices, vcpus, memory_gb, masks = args[:5]
    uniq = args[9]
    vec = sf.vec_ok(K, (stats, prices, vcpus, memory_gb), (masks, uniq))
    plan = sf.score_plan(K, rows, sms, vec)
    per_sm = dict(zip(("reduce", "emit"), sf.occupancy(DEVICE)))
    blocks = dict(reduce=plan.slices * plan.row_groups,
                  emit=plan.emit_blocks * B)
    out = dict(sms=sms, slices=plan.slices, slice=plan.slice,
               row_groups=plan.row_groups, emit_blocks_x=plan.emit_blocks,
               vec=plan.vec, blocks=blocks, blocks_per_sm=per_sm,
               waves={k: blocks[k] / (per_sm[k] * sms) for k in blocks})
    print(f"B1 plan at K={K}, {rows} rows: reduce {blocks['reduce']} blocks "
          f"({plan.slices} slices of {plan.slice} lanes x {plan.row_groups}), "
          f"{per_sm['reduce']} an SM, {out['waves']['reduce']:.2f} waves; "
          f"emit {blocks['emit']} blocks, {per_sm['emit']} an SM, "
          f"{out['waves']['emit']:.2f} waves; 16-byte path {plan.vec}")
    return out


def rglru_plan_line(torch, B, S, R) -> dict:
    """B6's persistent grid at (B, S, R) (``launch_plan``) from the kernel's
    occupancy on this card; printed and returned."""
    from repro_torch.kernels import rglru_scan as rg
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm, smem = rg.occupancy(DEVICE)
    plan = rg.launch_plan(B, R, sms, per_sm)
    print(f"B6 plan at ({B}, {S}, {R}): {plan.tiles} tiles of "
          f"{rg.TILE_CHANNELS} channels on {plan.grid} persistent blocks, "
          f"{per_sm} an SM ({smem} B of shared memory each), "
          f"{plan.waves:.2f} waves of tiles")
    return dict(sms=sms, tiles=plan.tiles, grid=plan.grid,
                blocks_per_sm=per_sm, smem_bytes=smem, waves=plan.waves)


def pool_scan_bound(B: int, K: int, scanned: int) -> tuple[float, str, int, int]:
    """B2's bound (ms, what bounds it), bytes and operations: the counts
    row written, s, c and csc read up to each request's stop, a division
    pair and a few compares a scanned lane."""
    nbytes = 4 * B * K + 12 * scanned + 4 * 3 * B
    nops = 16 * scanned
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, nops)


def pool_scan_plan_line(torch, ps, B: int, K: int) -> dict:
    """B2's launch (``pool_scan_plan``) at (B, K), the kernel's compiled
    geometry and how many of its clusters the card holds; printed and
    returned."""
    plan = ps.pool_scan_plan(B, K)
    cluster, threads, lanes, resident = ps.geometry(DEVICE)
    if (cluster, threads, lanes) != (plan.cluster, plan.threads, plan.lanes):
        fail(f"pool_scan_plan {plan} disagrees with the kernel's "
             f"{(cluster, threads, lanes)}")
    print(f"B2 plan at B={B}, K={K}: {B} clusters of {cluster} blocks of "
          f"{threads} threads, tiles of {plan.tile} lanes, at most "
          f"{plan.tiles} a block; {resident} clusters resident at once")
    return dict(cluster=cluster, threads=threads, tile=plan.tile,
                tiles=plan.tiles,
                resident_clusters=resident)


def pool_scan_edges(torch, ps) -> dict:
    """B2 at the serving width on rows that stop at k = 0, at the last lane
    of tile 0 (every block scans it), at the first lane of the second step
    (past the cluster's first tiles: the blocks walk and merge), and never:
    bit-identical to the plain version, each timed beside its bound."""
    B, K = B_FULL, K_FULL
    plan = ps.pool_scan_plan(B, K)
    out = {}
    for name, stop in (("k0", 0), ("tile_end", plan.tile - 1),
                       ("second_step", plan.cluster * plan.tile),
                       ("never", None)):
        s = torch.ones((B, K), device=DEVICE)
        if stop is not None:
            s[:, stop] = 0.0
        c = torch.ones_like(s)
        req = torch.full((B,), NEVER_R, device=DEVICE)
        csc = ps._clamped_prefix_sums(s)
        got = ps.pool_scan(s, c, req, csc)
        want = ps.pool_scan(s, c, req, csc, backend="torch")
        torch.cuda.synchronize()
        for part, a, b in zip(("counts", "k_stop", "any_term"), got, want):
            if not torch.equal(a, b):
                fail(f"pool_scan on rows stopping at {name}: {part} differs "
                     f"from the plain version")
        stops = got[1].tolist() if bool(got[2].all()) else None
        if stops != (None if stop is None else [stop] * B):
            fail(f"pool_scan rows built to stop at {name} stopped at {stops}")
        scanned = B * (K if stop is None else stop + 1)
        bound, by, nbytes, _ = pool_scan_bound(B, K, scanned)
        call_ms, dev_ms = time_ms(lambda: ps.pool_scan(s, c, req, csc),
                                  ("pool_scan_kernel",))
        out[name] = dict(stop=stop, scanned_lanes=scanned,
                         ms=dev_ms if dev_ms is not None else call_ms,
                         call_ms=call_ms, bound_ms=bound, bound_by=by,
                         bytes=nbytes)
    print("B2 edge rows (B=16, K=32768), bit-identical; device ms / bound ms: "
          + "; ".join(f"{k} {v['ms']:.5f} / {v['bound_ms']:.6f}"
                      for k, v in out.items()))
    return out


def kernel_phase(torch, cands, archive):
    """B1 and B2 against their plain versions at the main path's shapes."""
    from repro_torch.core import pool as pool_lib
    from repro_torch.core.engine import _dedup_masks
    from repro_torch.core.types import RequestBatch
    from repro_torch.kernels import pool_scan as ps
    from repro_torch.kernels import score_fuse as sf

    dev = archive.device
    K = len(cands)
    stats = torch.stack(tuple(archive.score_stats()))
    rng = np.random.default_rng(1)
    timings = {}
    err = {"score_fuse": 0.0, "pool_scan": 0.0}
    for label, filtered in (("U=1", False), ("U>1", True)):
        batch = RequestBatch.from_requests(
            cands, mixed_requests(rng, B_FULL, filtered=filtered))
        uniq, inv = _dedup_masks(batch.masks)
        on = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        masks, use_cpus = on(batch.masks), on(batch.use_cpus)
        amounts, lams, weights = on(batch.amounts), on(batch.lams), on(batch.weights)
        args = (stats, archive.prices, archive.vcpus, archive.memory_gb,
                masks, use_cpus, amounts, lams, weights, on(uniq), inv)
        got = sf.score_fuse_batch(*args)
        want = sf.score_fuse_batch(*args, backend="torch")
        torch.cuda.synchronize()
        m = masks
        for name in ("comb", "avail", "cost"):
            if not same_bits(getattr(got, name)[m], getattr(want, name)[m]):
                fail(f"score_fuse {label}: {name} rows differ from the plain version")
        if not (same_bits(got.extrema, want.extrema)
                and same_bits(got.c_min, want.c_min)):
            fail(f"score_fuse {label}: extrema or C_min differ")
        for name in ("comb", "avail", "cost"):
            d = (getattr(got, name) - getattr(want, name))[m].abs()
            err["score_fuse"] = max(err["score_fuse"],
                                    float(d.nan_to_num(0.0).max()))
        U = uniq.shape[0]
        if (U == 1) != (label == "U=1"):
            fail(f"score_fuse {label}: expected that case, got U = {U}")

        caps = torch.where(use_cpus[:, None], archive.vcpus, archive.memory_gb)
        _, s, c = pool_lib._sort_masked(got.comb, caps, masks)
        csc = ps._clamped_prefix_sums(s)
        pk = ps.pool_scan(s, c, amounts, csc)
        pp = ps.pool_scan(s, c, amounts, csc, backend="torch")
        torch.cuda.synchronize()
        for name, a, b in zip(("counts", "k_stop", "any_term"), pk, pp):
            if not torch.equal(a, b):
                fail(f"pool_scan {label}: {name} differs from the plain version")
        err["pool_scan"] = max(err["pool_scan"],
                               float((pk[0] - pp[0]).abs().max()))
        print(f"kernel phase {label}: U={U} bit-identical "
              f"(score rows, extrema, C_min, counts, k_stop, any_term)")

        if label == "U>1":   # the main path's mix: time and bound here
            k_stop, any_term = pk[1].cpu().numpy(), pk[2].cpu().numpy()
            scanned = np.where(any_term, k_stop, K - 1) + 1
            B = B_FULL
            sf_bytes = (4 * 6 * K + B * K + U * K + 4 * 5 * B + 4 * 3 * B * K
                        + 4 * 6 * U + 4 * B)
            sf_ops = 24 * B * K + 6 * U * K + 4 * B * K
            _, _, ps_bytes, ps_ops = pool_scan_bound(B, K, int(scanned.sum()))
            for name, kfn, pfn, nbytes, nops, knames in (
                    ("score_fuse", lambda: sf.score_fuse_batch(*args),
                     lambda: sf.score_fuse_batch(*args, backend="torch"),
                     sf_bytes, sf_ops, ("score_reduce_kernel",
                                        "score_emit_kernel")),
                    ("pool_scan", lambda: ps.pool_scan(s, c, amounts, csc),
                     lambda: ps.pool_scan(s, c, amounts, csc, backend="torch"),
                     ps_bytes, ps_ops, ("pool_scan_kernel",))):
                t = timings[name] = kernel_time(torch, kfn, pfn, knames,
                                                nbytes, nops)
                print(f"{name} device ms: " + " + ".join(
                    f"{k} {v:.5f}" for k, v in t["kernel_ms"].items())
                    + f" = {t['ms']:.5f} ({t['ms_source']})")
            timings["pool_scan"]["scanned_lanes"] = int(scanned.sum())
            timings["pool_scan"]["plan"] = pool_scan_plan_line(torch, ps, B, K)
            timings["pool_scan"]["edges"] = pool_scan_edges(torch, ps)
            timings["score_fuse"]["plan"] = score_plan_line(
                torch, sf, K, U + B, B, args)
    for name, e in err.items():
        timings[name]["max_abs_err"] = e
    return timings


def check_pools(cands, calls, served, label: str) -> dict:
    """Algorithm 1's own invariants: a non-empty pool of positive counts,
    inside the request's filters, whose capacity covers the request.
    Returns how many pools hold one type, and how many of those exceed
    ``ceil(R / c0)`` nodes: the reference's float32 ``ceil(s0 R / (s0
    c0))`` can land one node above (F5, ROADMAP C), which the port keeps;
    a count, not a gate."""
    row_of = {k: i for i, k in enumerate(zip(cands.names, cands.regions,
                                             cands.azs))}
    single = over = 0
    for reqs, recs in zip(calls, served):
        for req, rec in zip(reqs, recs):
            rows = np.array([row_of[k] for k in zip(rec.names, rec.regions,
                                                    rec.azs)], np.int64)
            cap = req.capacity_of(cands)[rows] if rows.size else rows
            if not (rows.size and np.all(rec.counts > 0)
                    and req.filter_mask(cands)[rows].all()
                    and np.isfinite(rec.combined).all()
                    and np.isfinite(rec.hourly_cost)
                    and (rec.counts * cap).sum() >= req.amount):
                fail(f"{label}: malformed pool for {req}")
            if rows.size == 1:
                single += 1
                over += int(rec.counts[0] > np.ceil(req.amount / cap[0]))
    return dict(single_type_pools=single, single_type_over_ceil=over)


def host_stats(archive) -> list:
    """An archive's (area, slope, std) on the host; a sharded archive's
    concatenated over its shards."""
    if getattr(archive, "is_sharded", False):
        parts = [host_stats(s) for s in archive.shards]
        return [np.concatenate(x) for x in zip(*parts)]
    return [x.cpu().numpy() for x in archive.score_stats()]


def compare_with_cpu(torch, server, archive, cands, calls, served, label):
    """Serve ``calls`` again on the CPU, on an archive holding the card
    archive's statistics: score rows must be bit-identical, and pools
    identical except where ``prefix_sum_tie`` flags a tie (counted)."""
    from repro_torch import convert
    from repro_torch.core import pool as pool_lib
    from repro_torch.core.types import RequestBatch
    from repro_torch.kernels import pool_scan as ps
    from repro_torch.serve import BatchServer

    cpu_archive = convert.archive_from_numpy(cands, host_stats(archive),
                                             device="cpu", key="cpu")
    cpu_server = BatchServer(device="cpu", bucket_sizes=BUCKETS)
    cpu_served = [cpu_server.serve(cpu_archive, reqs) for reqs in calls]

    ties = mismatched = csc_rows_differ = 0
    csc_max_rel = 0.0
    for reqs, recs, cpu_recs in zip(calls, served, cpu_served):
        batch = RequestBatch.from_requests(cands, reqs)
        gpu = server.engine.batch_arrays(cands, batch, archive=archive)
        cpu = cpu_server.engine.batch_arrays(cands, batch, archive=cpu_archive)
        for name, a, b in zip(("comb", "avail", "cost"), gpu[:3], cpu[:3]):
            if not same_bits(a[batch.masks], b[batch.masks]):
                fail(f"{label}: {name} rows differ between card and CPU")
        comb = torch.as_tensor(cpu[0])
        caps_all = torch.where(torch.as_tensor(batch.use_cpus)[:, None],
                               cpu_archive.vcpus, cpu_archive.memory_gb)
        _, s, c = pool_lib._sort_masked(comb, caps_all,
                                        torch.as_tensor(batch.masks))
        csc_cpu = ps._clamped_prefix_sums(s).numpy()
        csc_gpu = ps._clamped_prefix_sums(s.to(DEVICE)).cpu().numpy()
        csc_rows_differ += int((csc_cpu != csc_gpu).any(axis=1).sum())
        csc_max_rel = max(csc_max_rel, float(
            (np.abs(csc_cpu - csc_gpu) / np.abs(csc_cpu)).max()))
        for b, (req, rg, rc) in enumerate(zip(reqs, recs, cpu_recs)):
            same_scan = (np.array_equal(gpu[3][b], cpu[3][b])
                         and np.array_equal(gpu[4][b], cpu[4][b])
                         and gpu[5][b] == cpu[5][b] and gpu[6][b] == cpu[6][b])
            same_pool = (list(rg.names) == list(rc.names)
                         and np.array_equal(rg.counts, rc.counts)
                         and rg.hourly_cost == rc.hourly_cost)
            runs = [(int(x[5][b]), bool(x[6][b])) for x in (gpu, cpu)]
            tie, margin, budget = pool_lib.prefix_sum_tie(
                s[b].numpy(), c[b].numpy(), float(batch.amounts[b]),
                csc_cpu[b], csc_gpu[b], runs)
            ties += tie
            if not (same_scan and same_pool):
                mismatched += 1
                if not tie:
                    fail(f"{label}: pool of {req} differs between card and "
                         f"CPU with margin {margin:.3g} > budget {budget:.3g}")
    return dict(ties=int(ties), tie_mismatches=int(mismatched),
                prefix_sum_rows_differ=csc_rows_differ,
                prefix_sum_max_rel_diff=csc_max_rel)


def main_path(torch, cands):
    """3 x 16 mixed requests through BatchServer.serve on the card, then on
    the CPU with the card's statistics; returns the counters and report."""
    from repro_torch.kernels import pool_scan as ps
    from repro_torch.kernels import score_fuse as sf
    from repro_torch.serve import BatchServer

    rng = np.random.default_rng(2)
    calls = [mixed_requests(rng, B_FULL) for _ in range(N_CALLS)]
    server = BatchServer(device=DEVICE, bucket_sizes=BUCKETS)
    archive = server.cache.get(cands)
    archive.score_stats()
    torch.cuda.synchronize()

    sf.score_fuse_batch.launches = 0
    ps.pool_scan.launches = 0
    served, serve_ms = [], []
    for reqs in calls:
        t0 = time.perf_counter()
        served.append(server.serve(archive, reqs))
        serve_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"score_fuse": sf.score_fuse_batch.launches,
                "pool_scan": ps.pool_scan.launches}
    for name, n in launches.items():
        if n == 0:
            fail(f"the main path never launched kernel {name}")

    f5 = check_pools(cands, calls, served, "main path")
    print(f"main path: {f5['single_type_pools']} single-type pools, "
          f"{f5['single_type_over_ceil']} above ceil(R / c0) nodes (F5)")
    report = compare_with_cpu(torch, server, archive, cands, calls, served,
                              "main path")
    return launches, dict(serve_ms=serve_ms, requests=N_CALLS * B_FULL,
                          f5=f5, **report)


class SyntheticFeed:
    """A seeded live collector over a fixed catalog: tick ``i`` is the (K,)
    column ``uniform(0, 50)`` drawn from ``(seed, i)``.  Has what the
    ingestor reads of a collector: ``ticks``, ``column(i)`` and
    ``to_candidate_set(window=)``.  :meth:`run` draws the next tick's column
    ahead, so an ingest reads it from memory as from a collector's ring."""

    def __init__(self, catalog, seed: int, ticks: int):
        self.catalog = catalog
        self.seed = seed
        self.ticks = ticks
        self._ahead = None

    def _draw(self, i: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, i))
        return rng.uniform(0.0, 50.0, len(self.catalog))

    def column(self, i: int) -> np.ndarray:
        if not 0 <= i < self.ticks:
            raise IndexError(f"tick {i} not collected yet")
        if self._ahead is not None and self._ahead[0] == i:
            return self._ahead[1]
        return self._draw(i)

    def window(self, n: int) -> np.ndarray:
        """The (K, n) window of the last ``n`` ticks, oldest first (the
        columns drawn in threads: each has its own generator)."""
        from concurrent.futures import ThreadPoolExecutor
        out = np.empty((len(self.catalog), n))

        def fill(j: int) -> None:
            out[:, j] = self.column(self.ticks - n + j)

        with ThreadPoolExecutor(8) as pool:
            list(pool.map(fill, range(n)))
        return out

    def to_candidate_set(self, window: int | None = None):
        from dataclasses import replace
        n = min(window or self.ticks, self.ticks)
        return replace(self.catalog, t3=self.window(n))

    def run(self, n: int = 1) -> None:
        self.ticks += n
        self._ahead = (self.ticks - 1, self._draw(self.ticks - 1))


def ingest_phase(torch, catalog, precision: str):
    """The live-ingest path at full width: prime a rolling archive of K
    candidates, absorb ``INGEST_TICKS[precision]`` ticks through
    ``LiveIngestor.poll`` (kernel B3 once per tick) and serve 16 mixed
    requests through ``AdmissionQueue`` drains at ``INGEST_SERVE_AT``.

    Every tick is replayed through B3's plain version on the same inputs
    (bit-identical moments and statistics required); the final statistics
    are held against ``candidate_stats`` of the materialized window, the
    window against the feed, and the served pools against a CPU run on the
    snapshots' statistics."""
    from repro_torch.core import scoring
    from repro_torch.core.config import EngineConfig
    from repro_torch.kernels import pool_scan as ps
    from repro_torch.kernels import score_fuse as sf
    from repro_torch.kernels import stats_update as su
    from repro_torch.parallel import compression
    from repro_torch.stream import AdmissionQueue

    n_ticks = INGEST_TICKS[precision]
    label = f"ingest {precision}"
    quantized = precision == "int8"
    feed = SyntheticFeed(catalog, seed=5, ticks=INGEST_PRIME)
    cfg = EngineConfig(archive_precision=precision)
    server = cfg.build_server(device=DEVICE, bucket_sizes=BUCKETS)
    rng = np.random.default_rng(4)
    calls, served, snaps, append_ms = [], [], [], []
    max_err = 0.0

    su.stats_update.launches = 0
    sf.score_fuse_batch.launches = 0
    ps.pool_scan.launches = 0
    t0 = time.perf_counter()
    ing = cfg.build_ingestor(feed, window=INGEST_WINDOW, name="live",
                             device=DEVICE)
    arch = ing.prime()
    torch.cuda.synchronize()
    prime_s = time.perf_counter() - t0
    queue = AdmissionQueue(server, lambda: ing.archive, max_wait_s=0.0)
    for tick in range(1, n_ticks + 1):
        feed.run(1)
        slot, prev = arch._pos, arch._moments
        y_old = arch._buf[slot].clone()
        evict = arch.window_len == arch.capacity
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ing.poll()
        torch.cuda.synchronize()
        append_ms.append((time.perf_counter() - t0) * 1e3)
        # the same tick through B3's plain version, on the same inputs
        y_new = arch._buf[slot]
        pm, pst = su.stats_update(
            prev, y_new, y_old, arch._buf[arch._start], y_new,
            arch.window_len, evict, scale=arch.scale if quantized else None,
            backend="torch")
        for a, b in zip((*arch._moments, *arch.score_stats()), (*pm, *pst)):
            if not same_bits(a, b):
                fail(f"{label}: B3 differs from its plain version at tick "
                     f"{tick}")
            max_err = max(max_err, float((a - b).abs().nan_to_num(0.0).max()))
        if tick in INGEST_SERVE_AT[precision]:
            reqs = mixed_requests(rng, B_FULL)
            tickets = [queue.submit(r) for r in reqs]
            queue.drain(force=True)
            recs = [t.result() for t in tickets]
            if any(r.diagnostics["archive_version"] != arch.version
                   for r in recs):
                fail(f"{label}: a drain served another version")
            calls.append(reqs)
            served.append(recs)
            snaps.append(arch.snapshot())
    launches = {"stats_update": su.stats_update.launches,
                "score_fuse": sf.score_fuse_batch.launches,
                "pool_scan": ps.pool_scan.launches}
    if launches["stats_update"] != n_ticks:
        fail(f"{label}: B3 launched {launches['stats_update']} times over "
             f"{n_ticks} ticks, not once per tick")
    for name, n in launches.items():
        if n == 0:
            fail(f"{label}: the ingest path never launched kernel {name}")

    # the stored window against the feed, the statistics against a recompute
    host = feed.window(arch.window_len)
    if precision != "float32":
        codes = compression.quantize_window(host, arch.scale.cpu().numpy(),
                                            precision)
        host = compression.dequantize_window(codes, arch.scale.cpu(),
                                             precision).numpy()
    if not np.array_equal(arch.materialize(), host.astype(np.float32)):
        fail(f"{label}: the ring's window differs from the feed's")
    want = scoring.candidate_stats(arch.t3)
    for name, a, b in zip(("area", "slope", "std"), arch.score_stats(), want):
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-4):
            fail(f"{label}: streamed {name} is off a recompute of the window")
    recompute = {name: float((a - b).abs().max()) for name, a, b in
                 zip(("area", "slope", "std"), arch.score_stats(), want)}

    serve = []
    for reqs, recs, snap in zip(calls, served, snaps):
        check_pools(snap.host, [reqs], [recs], f"{label} v{snap.version}")
        serve.append(dict(version=snap.version, **compare_with_cpu(
            torch, server, snap, snap.host, [reqs], [recs],
            f"{label} v{snap.version}")))

    profile = profile_ingest(torch, ing, feed)

    # B3 alone at this shape: one sliding tick of the final state
    K = len(arch)
    y_new = arch._buf[(arch._pos - 1) % arch.capacity]
    args = (arch._moments, y_new, arch._buf[arch._pos],
            arch._buf[arch._start], y_new, arch.window_len, True)
    kw = dict(scale=arch.scale if quantized else None)
    plan = su.stats_update_plan(K, torch.cuda.get_device_properties(0)
                                .multi_processor_count)
    matched = {}
    col_bytes = TIER_BYTES[precision] * 4 * K
    b3 = kernel_time(
        torch, lambda: su.stats_update(*args, **kw),
        lambda: su.stats_update(*args, **kw, backend="torch"),
        ("stats_update_kernel",),
        4 * 7 * K + col_bytes + (4 * K if quantized else 0) + 4 * 9 * K,
        (B3_FLOPS + (4 if quantized else 0)) * K, matched)
    b3.update(max_abs_err=max_err, kernels=matched,
              plan=dict(blocks=plan.blocks, threads=plan.threads))
    report = dict(
        K=K, capacity=INGEST_WINDOW, prime_columns=INGEST_PRIME,
        ticks=n_ticks, grow_ticks=INGEST_WINDOW - INGEST_PRIME,
        slide_ticks=n_ticks - (INGEST_WINDOW - INGEST_PRIME),
        prime_s=prime_s,
        append_ms={"p50": float(np.percentile(append_ms, 50)),
                   "p90": float(np.percentile(append_ms, 90)),
                   "max": float(np.max(append_ms))},
        b3_launches_per_tick=launches["stats_update"] / n_ticks,
        launches=launches, clipped_samples=arch.clipped_samples,
        recompute_max_abs_err=recompute, serve=serve, b3=b3,
        profile=profile)
    return launches, report


def profile_ingest(torch, ing, feed, n: int = 50):
    """``n`` more ticks under ``torch.profiler``: per poll, the wall time,
    the device's busy time and idle share, the kernels and the copies
    (memcpy, memset) the device ran, and the largest host and device items
    (self time, per poll)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            feed.run(1)
            ing.poll()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    host, dev = [], []
    items = {"kernels": 0, "copies": 0}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            dev.append((dev_us / 1e3 / n, evt.key[:60]))
        if evt.self_cpu_time_total > 0:
            host.append((evt.self_cpu_time_total / 1e3 / n, evt.key[:60]))
        if evt.device_type == DeviceType.CUDA:
            copy = evt.key.startswith(("Memcpy", "Memset"))
            items["copies" if copy else "kernels"] += evt.count
    dev.sort(reverse=True)
    host.sort(reverse=True)
    busy = sum(ms for ms, _ in dev)
    return dict(polls=n, wall_ms_per_poll=wall_ms, device_busy_ms_per_poll=busy,
                idle_share=1 - busy / wall_ms if wall_ms > 0 else None,
                kernels_per_poll=items["kernels"] / n,
                copies_per_poll=items["copies"] / n,
                device_top=[[round(ms, 5), k] for ms, k in dev[:6]],
                host_top=[[round(ms, 5), k] for ms, k in host[:10]])


def profile_serve(torch, cands):
    """Device busy time against wall time for one served batch, and the
    host-clock split of a batch into its three engine stages."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.types import RequestBatch
    from repro_torch.serve import BatchServer
    server = BatchServer(device=DEVICE, bucket_sizes=BUCKETS)
    reqs = mixed_requests(np.random.default_rng(3), B_FULL)
    archive = server.cache.get(cands)
    server.serve(archive, reqs)
    torch.cuda.synchronize()
    stages = {"assemble_ms": [], "device_pass_ms": [], "results_ms": []}
    for _ in range(5):
        t0 = time.perf_counter()
        batch = RequestBatch.from_requests(cands, reqs, pad_to=B_FULL)
        t1 = time.perf_counter()
        arrays = server.engine.batch_arrays(cands, batch, archive=archive)
        t2 = time.perf_counter()
        server.engine._build_recommendations(cands, batch, reqs,
                                             *arrays[:6], 0.0)
        t3 = time.perf_counter()
        for key, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
            stages[key].append(dt * 1e3)
    latency = []
    for _ in range(LATENCY_CALLS):
        t0 = time.perf_counter()
        server.serve(archive, reqs)
        latency.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.serve(archive, reqs)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, evt.key[:60]))
    rows.sort(reverse=True)
    busy = sum(ms for ms, _ in rows)
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=1 - busy / wall_ms if wall_ms > 0 else None,
                stages_median_ms={k: float(np.median(v))
                                  for k, v in stages.items()},
                serve_latency_ms={"n": LATENCY_CALLS,
                                  "p50": float(np.percentile(latency, 50)),
                                  "p90": float(np.percentile(latency, 90)),
                                  "max": float(np.max(latency))},
                top=[[round(ms, 4), k] for ms, k in rows[:8]])


ARRAYS = ("comb", "avail", "cost", "order", "counts", "k_stop", "any_term")


class capture:
    """Within the block, record every call of ``module.name`` (its args and
    keyword args) in ``into`` and pass it through."""

    def __init__(self, module, name: str, into: list):
        self.module, self.name, self.into = module, name, into

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def wrapper(*args, **kw):
            self.into.append((args, kw))
            return self.real(*args, **kw)
        # a wrapper that counts its launches through its own module's name
        # now counts them on this one: hand them back on exit
        wrapper.launches = 0
        self.wrapper = wrapper
        setattr(self.module, self.name, wrapper)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        if hasattr(self.real, "launches"):
            self.real.launches += self.wrapper.launches


def same_pools(recs_x, recs_y, label: str) -> None:
    from repro_torch.core.quantized import pools_identical
    for i, (a, b) in enumerate(zip(recs_x, recs_y)):
        if not (pools_identical(a, b)
                and same_bits(a.combined, b.combined)):
            fail(f"{label}: pool of request {i} differs")


def tier_parity(cands, reqs, batch, f32_arrays, f32_recs, q_arrays, q_recs,
                f32_stats, scale, label: str) -> dict:
    """A quantised tier's pools against the float32 tier's under the
    contract of ``core.quantized``: each pool (the scan's, before a
    ``max_types`` cap, and the served one where no cap applies) identical,
    or a tie flagged by a decision margin within the score bound."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core import quantized as qz
    from repro_torch.core.scoring import CandidateStats
    bounds = qz.stat_bounds(scale, cands.t3.shape[1])
    stats = CandidateStats(*f32_stats)

    def margin_of(b: int):
        req, mask = reqs[b], batch.masks[b]
        bound = qz.score_bound(stats, bounds, mask, req.lam, req.weight)
        return bound, qz.pool_decision_margin(
            f32_arrays[0][b], req.capacity_of(cands), req.amount, mask, bound)

    with ThreadPoolExecutor(8) as pool:        # numpy sorts off the GIL
        replays = list(pool.map(margin_of, range(len(reqs))))
    margins, flagged, diverged = [], 0, 0
    for b, (req, (bound, margin)) in enumerate(zip(reqs, replays)):
        scan = lambda arr: (arr[3][b][arr[4][b] > 0],  # noqa: E731
                            arr[4][b][arr[4][b] > 0])
        same = all(np.array_equal(u, v)
                   for u, v in zip(scan(f32_arrays), scan(q_arrays)))
        if req.max_types is None:
            same = same and qz.pools_identical(f32_recs[b], q_recs[b])
        p = qz.QuantizedParity(identical=same, tie=margin <= 1.0,
                               margin=margin, bound=bound)
        if not p.ok:
            fail(f"{label}: pool of {req} differs from float32 with margin "
                 f"{margin:.3g} > 1 (bound {bound:.3g})")
        flagged += p.tie
        diverged += not same
        margins.append(margin)
    quant = lambda x: [float(v) for v in np.quantile(  # noqa: E731
        np.asarray(x, np.float64), (0.0, 0.5, 0.9, 1.0))]
    return dict(requests=len(reqs), ties_flagged=flagged,
                pools_diverged=diverged,
                margin_quantiles_0_50_90_100=quant(margins),
                bound_quantiles_0_50_90_100=quant([b for b, _ in replays]))


def serve_latency(server, archive, reqs) -> dict:
    ms = []
    for _ in range(BIG_SERVE_CALLS):
        t0 = time.perf_counter()
        server.serve(archive, reqs)
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"n": BIG_SERVE_CALLS, "p50": float(np.percentile(ms, 50)),
            "p90": float(np.percentile(ms, 90))}


def hold_launches(torch, captured, label: str, *,
                  given_scalars: bool) -> dict:
    """Every captured B1 phase-0, B1 emit and B2 launch against its plain
    version on the same inputs, bit for bit; returns each one's max
    |kernel - plain|.  With ``given_scalars`` every emit must have run on
    merged extrema and cost floor (a shard's)."""
    from repro_torch.kernels import pool_scan as ps
    from repro_torch.kernels import score_fuse as sf
    err = {"phase0": 0.0, "emit": 0.0, "pool_scan": 0.0}
    for args, kw in captured.get("phase0", ()):
        got = sf.score_fuse_phase0(*args, **kw)
        want = sf.score_fuse_phase0(*args, **kw, backend="torch")
        torch.cuda.synchronize()
        for name, a, b in zip(("extrema", "cost_floor"), got, want):
            if not same_bits(a, b):
                fail(f"{label}: B1 phase 0 {name} differs from the plain "
                     f"version")
            err["phase0"] = max(err["phase0"], float(
                (a - b).abs().nan_to_num(0.0).max()))
    for args, kw in captured["emit"]:
        if given_scalars and (kw.get("extrema") is None
                              or kw.get("cost_floor") is None):
            fail(f"{label}: a shard's emit ran without given scalars")
        got = sf.score_fuse_batch(*args, **kw)
        want = sf.score_fuse_batch(*args, **kw, backend="torch")
        torch.cuda.synchronize()
        for name in ("comb", "avail", "cost"):
            a, b = getattr(got, name), getattr(want, name)
            if not same_bits(a, b):
                fail(f"{label}: B1 emit {name} differs from the plain version")
            err["emit"] = max(err["emit"], float(
                (a - b).abs().nan_to_num(0.0).max()))
    for args, kw in captured["pool_scan"]:
        got = ps.pool_scan(*args, **kw)
        want = ps.pool_scan(*args, **kw, backend="torch")
        torch.cuda.synchronize()
        for name, a, b in zip(("counts", "k_stop", "any_term"), got, want):
            if not torch.equal(a, b):
                fail(f"{label}: B2 {name} differs from the plain version")
        err["pool_scan"] = max(err["pool_scan"],
                               float((got[0] - want[0]).abs().max()))
    return err


def hold_sharded_kernels(torch, captured, label: str) -> dict:
    """Every B1 phase-0, B1 emit and B2 launch captured from a sharded
    serve against its plain version on the same inputs, bit for bit; then
    each timed on the first shard's (B2: the merge device's) inputs."""
    from repro_torch.kernels import pool_scan as ps
    from repro_torch.kernels import score_fuse as sf
    err = hold_launches(torch, captured, label, given_scalars=True)

    # time each at this shape: the first shard's phase 0 and emit, B2
    (args, kw), (eargs, ekw) = captured["phase0"][0], captured["emit"][0]
    (U, Ks), B = kw["uniq_masks"].shape, kw["masks"].shape[0]
    p0 = kernel_time(
        torch, lambda: sf.score_fuse_phase0(*args, **kw),
        lambda: sf.score_fuse_phase0(*args, **kw, backend="torch"),
        ("score_reduce_kernel", "score_merge_kernel"),
        4 * 6 * Ks + (B + U) * Ks + 4 * 2 * B + 4 * (6 * U + B),
        6 * U * Ks + 4 * B * Ks)
    emit = kernel_time(
        torch, lambda: sf.score_fuse_batch(*eargs, **ekw),
        lambda: sf.score_fuse_batch(*eargs, **ekw, backend="torch"),
        ("score_emit_kernel",),
        4 * 6 * Ks + 4 * 5 * B + 4 * 6 * U + 4 * 3 * B * Ks, 24 * B * Ks)
    (pargs, pkw) = captured["pool_scan"][0]
    out = ps.pool_scan(*pargs, **pkw)
    K = pargs[0].shape[1]
    scanned = int((np.where(out[2].cpu().numpy(), out[1].cpu().numpy(),
                            K - 1) + 1).sum())
    _, _, nbytes, nops = pool_scan_bound(B, K, scanned)
    b2 = kernel_time(torch, lambda: ps.pool_scan(*pargs, **pkw),
                     lambda: ps.pool_scan(*pargs, **pkw, backend="torch"),
                     ("pool_scan_kernel",), nbytes, nops)
    b2["scanned_lanes"] = scanned
    for name, t in (("phase0", p0), ("emit", emit), ("pool_scan", b2)):
        t["max_abs_err"] = err[name]
        t["checked_launches"] = len(captured[name])
    p0["shape"] = emit["shape"] = dict(B=B, U=U, K_shard=Ks)
    b2["shape"] = dict(B=B, K=K)
    return dict(phase0=p0, emit=emit, pool_scan=b2)


def resident(torch, make):
    """``make()`` on the card: the archive, its statistics computed, and
    the bytes ``torch.cuda.memory_allocated`` grew by."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    arch = make()
    for part in getattr(arch, "shards", (arch,)):
        part.score_stats()
    torch.cuda.synchronize()
    return arch, torch.cuda.memory_allocated() - before


def shard_phase(torch):
    """K = 2^20 candidates on one card: static float32, int8 and bf16
    archives and 4-shard float32 and int8 ones serve 16 mixed requests
    through B1 (phase 0 alone, and the emit with given scalars, a shard
    each) and B2; then an int8 4-shard ring absorbs ticks through B3, a
    launch a shard and tick.  See the module docstring for the checks."""
    from repro_torch.core import pool as pool_lib
    from repro_torch.core.types import RequestBatch
    from repro_torch.kernels import pool_scan as ps
    from repro_torch.kernels import score_fuse as sf
    from repro_torch.serve import BatchServer, DeviceArchive
    from repro_torch.shard import ShardedArchive

    t_start = time.perf_counter()
    laps, t_lap = {}, [t_start]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    cands = candidates(K_BIG, T_FULL, t3_chunk=BIG_CHUNK)
    lap("generate")
    dev = [DEVICE]
    makes = {
        "a": ("float32", lambda: DeviceArchive.stage(cands, key="big",
                                                     device=DEVICE)),
        "b": ("float32, 4 shards", lambda: ShardedArchive.stage(
            cands, n_shards=BIG_SHARDS, devices=dev, key="big")),
        "c": ("int8", lambda: DeviceArchive.stage(
            cands, key="big", device=DEVICE, precision="int8")),
        "d": ("bfloat16", lambda: DeviceArchive.stage(
            cands, key="big", device=DEVICE, precision="bfloat16")),
        "e": ("int8, 4 shards", lambda: ShardedArchive.stage(
            cands, n_shards=BIG_SHARDS, devices=dev, key="big",
            precision="int8"))}
    arch, tiers = {}, {}
    for x, (label, make) in makes.items():
        t1 = time.perf_counter()
        arch[x], grew = resident(torch, make)
        tiers[x] = dict(tier=label, nbytes=arch[x].nbytes, allocated=grew,
                        key=arch[x].key, stage_s=time.perf_counter() - t1)
    print("shard phase, resident bytes (nbytes / memory_allocated growth): "
          + "; ".join(f"({x}) {v['tier']} {v['nbytes']} / {v['allocated']}"
                      for x, v in tiers.items()))
    lap("stage")

    server = BatchServer(device=DEVICE, bucket_sizes=BUCKETS)
    eng = server.engine
    reqs = mixed_requests(np.random.default_rng(8), B_FULL)
    batch = RequestBatch.from_requests(cands, reqs)

    # the path: B1 phase 0 and emit once a shard, B2 once a batch; counted
    # from 0 and every launch's operands captured
    captured = {"phase0": [], "emit": [], "pool_scan": []}
    sf.score_fuse_phase0.launches = sf.score_fuse_batch.launches = 0
    ps.pool_scan.launches = 0
    with capture(sf, "score_fuse_phase0", captured["phase0"]), \
            capture(sf, "score_fuse_batch", captured["emit"]), \
            capture(pool_lib, "pool_scan", captured["pool_scan"]):
        recs = {x: server.serve(arch[x], reqs) for x in ("b", "e")}
    launches = {"score_fuse_phase0": sf.score_fuse_phase0.launches,
                "score_fuse": sf.score_fuse_batch.launches,
                "pool_scan": ps.pool_scan.launches}
    want = {"score_fuse_phase0": 2 * BIG_SHARDS,
            "score_fuse": 2 * BIG_SHARDS, "pool_scan": 2}
    if launches != want:
        fail(f"shard phase: launches {launches}, expected {want}")
    recs.update({x: server.serve(arch[x], reqs) for x in ("a", "c", "d")})
    arrays = {x: eng.batch_arrays(cands, batch, archive=arch[x])
              for x in arch}
    lap("serve")

    # 4 shards against one archive: rows and pools bit-identical
    for x, y in (("a", "b"), ("c", "e")):
        tag = f"shard phase ({y}) against ({x})"
        for name, u, v in zip(ARRAYS, arrays[x], arrays[y]):
            if not same_bits(u, v):
                fail(f"{tag}: {name} differs")
        same_pools(recs[x], recs[y], tag)
        for u, v in zip(eng.score_archive(arch[x]),
                        eng.score_archive(arch[y])):
            if not same_bits(u, v):
                fail(f"{tag}: score_archive rows differ")
    lap("bit_identity")

    # quantised tiers against float32 under the tier contract
    parity = {x: tier_parity(
        cands, reqs, batch, arrays["a"], recs["a"], arrays[x], recs[x],
        host_stats(arch["a"]), arch[x].scale.cpu().numpy(),
        f"shard phase ({x})") for x in ("c", "d")}
    arrays.clear()
    print("shard phase quantized parity: " + json.dumps(parity))
    lap("tier_parity")

    # the card against the CPU on the card's statistics
    cpu = {x: compare_with_cpu(torch, server, arch[x], cands, [reqs],
                               [recs[x]], f"shard phase ({x})")
           for x in ("c", "e")}
    lap("cpu")
    kernels = hold_sharded_kernels(torch, captured, "shard phase")
    del captured
    lap("kernels")

    latency = {x: serve_latency(server, arch[x], reqs)
               for x in ("a", "b", "c", "e")}
    prof = profile_call(torch, lambda: server.serve(arch["b"], reqs))
    arch.clear()
    torch.cuda.empty_cache()
    lap("latency")

    ring = sharded_ring_phase(torch, cands)
    if ring["launches"]["stats_update"] != BIG_SHARDS * BIG_TICKS:
        fail(f"shard phase ring: B3 launched {ring['launches']} times, not "
             f"once a shard and tick")
    launches.update(ring["launches"])
    lap("ring")
    report = dict(
        K=K_BIG, T=T_FULL, shards=BIG_SHARDS, requests=len(reqs),
        tiers=tiers, launches=launches, quantized_parity=parity, cpu=cpu,
        serve_latency_ms=latency,
        serve_profile_b=dict(wall_ms=prof["wall_ms"],
                             device_busy_ms=prof["device_busy_ms"],
                             idle_share=prof["idle_share"]),
        ring=ring, seconds=laps, phase_s=time.perf_counter() - t_start)
    return launches, kernels, report


def sharded_ring_phase(torch, cands) -> dict:
    """An int8 ``LiveIngestor(shards=4)`` over the K = 2^20 catalog: prime
    504 of a 1008 ring, absorb ``BIG_TICKS`` ticks (B3 once a shard and
    tick, counted), every shard's every tick replayed through B3's plain
    version (bit for bit), the final statistics against ``candidate_stats``
    of each shard's decoded window (RTOL 1e-5, ATOL 1e-4)."""
    from repro_torch.core import scoring
    from repro_torch.kernels import stats_update as su
    from repro_torch.stream import LiveIngestor

    feed = SyntheticFeed(cands, seed=6, ticks=BIG_PRIME)
    t0 = time.perf_counter()
    ing = LiveIngestor(feed, window=INGEST_WINDOW, name="big", device=DEVICE,
                       precision="int8", shards=BIG_SHARDS)
    arch = ing.prime()
    torch.cuda.synchronize()
    prime_s = time.perf_counter() - t0
    su.stats_update.launches = 0
    append_ms, max_err = [], 0.0
    for tick in range(1, BIG_TICKS + 1):
        feed.run(1)
        before = [(s._pos, s._moments, s._buf[s._pos].clone(),
                   s.window_len == s.capacity) for s in arch.shards]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ing.poll()
        torch.cuda.synchronize()
        append_ms.append((time.perf_counter() - t1) * 1e3)
        for i, (s, (slot, prev, y_old, evict)) in enumerate(
                zip(arch.shards, before)):
            y_new = s._buf[slot]
            pm, pst = su.stats_update(
                prev, y_new, y_old, s._buf[s._start], y_new, s.window_len,
                evict, scale=s.scale, backend="torch")
            for u, v in zip((*s._moments, *s.score_stats()), (*pm, *pst)):
                if not same_bits(u, v):
                    fail(f"shard phase ring: B3 differs from its plain "
                         f"version on shard {i} at tick {tick}")
                max_err = max(max_err, float(
                    (u - v).abs().nan_to_num(0.0).max()))
    launches = {"stats_update": su.stats_update.launches}
    recompute = {"area": 0.0, "slope": 0.0, "std": 0.0}
    for s in arch.shards:
        for name, u, v in zip(recompute, s.score_stats(),
                              scoring.candidate_stats(s.t3)):
            if not torch.allclose(u, v, rtol=1e-5, atol=1e-4):
                fail(f"shard phase ring: streamed {name} is off a recompute "
                     f"of the window")
            recompute[name] = max(recompute[name],
                                  float((u - v).abs().max()))
    return dict(capacity=INGEST_WINDOW, prime_columns=BIG_PRIME,
                ticks=BIG_TICKS, prime_s=prime_s, launches=launches,
                b3_max_abs_err=max_err, clipped_samples=arch.clipped_samples,
                nbytes=arch.nbytes, recompute_max_abs_err=recompute,
                append_ms={"p50": float(np.percentile(append_ms, 50)),
                           "p90": float(np.percentile(append_ms, 90)),
                           "max": float(np.max(append_ms))})


def launch_segment(torch, label: str, fn):
    """``fn()`` with B1's and B2's launch counters set to 0 just before and
    read just after, every call captured; then each captured launch held
    against its plain version bit for bit (those checks' own launches are
    not counted).  Returns ``(fn's result, launches, max abs errors)``."""
    from repro_torch.core import pool as pool_lib
    from repro_torch.kernels import pool_scan as ps
    from repro_torch.kernels import score_fuse as sf
    captured = {"emit": [], "pool_scan": []}
    sf.score_fuse_batch.launches = ps.pool_scan.launches = 0
    with capture(sf, "score_fuse_batch", captured["emit"]), \
            capture(pool_lib, "pool_scan", captured["pool_scan"]):
        out = fn()
    launches = {"score_fuse": sf.score_fuse_batch.launches,
                "pool_scan": ps.pool_scan.launches}
    if launches != {"score_fuse": len(captured["emit"]),
                    "pool_scan": len(captured["pool_scan"])}:
        fail(f"{label}: launches {launches} against "
             f"{len(captured['emit'])} / {len(captured['pool_scan'])} calls")
    err = hold_launches(torch, captured, label, given_scalars=False)
    return out, launches, {"score_fuse": err["emit"],
                           "pool_scan": err["pool_scan"]}


def bucket_service_s(server, archive, mix) -> dict:
    """``benchmarks/latency_slo.py``'s calibration: the best serve wall
    time per ladder bucket over half a second, after one warm serve."""
    rng = np.random.default_rng(99)
    out = {}
    for bucket in server.bucket_sizes:
        reqs = [mix.sample(rng) for _ in range(bucket)]
        server.serve(archive, reqs)
        best = float("inf")
        deadline = time.perf_counter() + 0.5
        while time.perf_counter() < deadline:
            t0 = time.perf_counter()
            server.serve(archive, reqs)
            best = min(best, time.perf_counter() - t0)
        out[bucket] = best
    return out


def stable_rate(server, svc: dict, utilization: float,
                max_wait_s: float) -> float:
    """``benchmarks/latency_slo.py``'s ``_stable_rate``: the arrival rate
    that loads the server at ``utilization``, iterated to the fixed point
    rate -> drain size it induces -> capacity at that size -> rate."""
    big = max(server.bucket_sizes)
    rate = utilization * big / svc[big]
    for _ in range(48):
        n = max(1, min(int(rate * max_wait_s) + 1, big))
        eff_cap = n / sum(svc[b] for _, b in server.plan_chunks(n))
        rate = 0.5 * rate + 0.5 * utilization * eff_cap
    return rate


def sim_world():
    """The full default catalog (6400 pools) on the aws profile, the
    quickstart's 2000 accounts, and a USQS collector over every pool with a
    640-probe budget a cycle and an int8 host ring of a week."""
    from repro_torch.cloudsim import (Catalog, CollectorConfig, DataCollector,
                                      SpotMarket, SPSQueryService)
    from repro_torch.core.usqs import BudgetedProbeScheduler
    market = SpotMarket(Catalog(seed=0), seed=0, profile="aws")
    service = SPSQueryService(market, n_accounts=SIM_ACCOUNTS)
    targets = [(t.name, r, az) for t, r, az in market.pool_keys]
    sched = BudgetedProbeScheduler([r for _, r, _ in targets], SIM_BUDGET)
    col = DataCollector(service, targets, CollectorConfig(
        ring_capacity=INGEST_WINDOW, ring_dtype="int8", scheduler=sched))
    return market, service, col


def sim_ingest(torch, col, add):
    """Prime a float32 ring of a week on the card from the collector, then
    ``SIM_TICKS`` cycles each followed by ``LiveIngestor.poll`` (B3, every
    tick replayed through its plain version) and, at ``SIM_SERVE_AT``, 16
    mixed requests through an ``AdmissionQueue`` drain."""
    from repro_torch.kernels import stats_update as su
    from repro_torch.serve import BatchServer
    from repro_torch.stream import AdmissionQueue, LiveIngestor

    t0 = time.perf_counter()
    ing = LiveIngestor(col, window=INGEST_WINDOW, name="sim", device=DEVICE)
    arch = ing.prime()
    torch.cuda.synchronize()
    prime_s = time.perf_counter() - t0
    server = BatchServer(device=DEVICE, bucket_sizes=BUCKETS)
    queue = AdmissionQueue(server, lambda: ing.archive, max_wait_s=0.0)
    rng = np.random.default_rng(9)
    # a first serve before the timed drains: the server's first call pays
    # one-off costs (about 0.2 s on the card) that no drain after it does
    add("sim phase warm serve", lambda: server.serve(
        arch.snapshot(), mixed_requests(rng, B_FULL, regions=SIM_REGIONS)))
    calls, served, snaps = [], [], []
    cycle_ms, append_ms, serve_ms, b3_err = [], [], [], 0.0
    for tick in range(1, SIM_TICKS + 1):
        t0 = time.perf_counter()
        col.run(1)
        cycle_ms.append((time.perf_counter() - t0) * 1e3)
        slot, prev = arch._pos, arch._moments
        y_old = arch._buf[slot].clone()
        evict = arch.window_len == arch.capacity
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ing.poll()
        torch.cuda.synchronize()
        append_ms.append((time.perf_counter() - t0) * 1e3)
        y_new = arch._buf[slot]
        pm, pst = su.stats_update(prev, y_new, y_old, arch._buf[arch._start],
                                  y_new, arch.window_len, evict,
                                  backend="torch")
        for a, b in zip((*arch._moments, *arch.score_stats()), (*pm, *pst)):
            if not same_bits(a, b):
                fail(f"sim phase: B3 differs from its plain version at tick "
                     f"{tick}")
            b3_err = max(b3_err, float((a - b).abs().nan_to_num(0.0).max()))
        if tick in SIM_SERVE_AT:
            reqs = mixed_requests(rng, B_FULL, regions=SIM_REGIONS)

            def drain():
                t1 = time.perf_counter()
                tickets = [queue.submit(r) for r in reqs]
                queue.drain(force=True)
                recs = [t.result() for t in tickets]
                serve_ms.append((time.perf_counter() - t1) * 1e3)
                return recs
            recs = add(f"sim phase drain at tick {tick}", drain)
            if any(r.diagnostics["archive_version"] != arch.version
                   for r in recs):
                fail("sim phase: a drain served another version")
            calls.append(reqs)
            served.append(recs)
            snaps.append(arch.snapshot())
    serve = []
    for reqs, recs, snap in zip(calls, served, snaps):
        label = f"sim phase v{snap.version}"
        check_pools(snap.host, [reqs], [recs], label)
        serve.append(dict(version=snap.version, **compare_with_cpu(
            torch, server, snap, snap.host, [reqs], [recs], label)))
    pct = lambda x: {"p50": float(np.percentile(x, 50)),  # noqa: E731
                     "p90": float(np.percentile(x, 90)),
                     "max": float(np.max(x))}
    return ing, dict(prime_s=prime_s, ticks=SIM_TICKS, cycle_ms=pct(cycle_ms),
                     append_ms=pct(append_ms), serve_ms=serve_ms,
                     b3_max_abs_err=b3_err, cpu=serve)


def sim_entropy(torch, col, arch) -> dict:
    """``entropy_bits`` of the card's histogram of the ring's T3 (grid
    values 0, 5, ..., 50) against ``empirical_entropy`` of the collector's
    window on the host; the two histograms must be equal."""
    from repro_torch.core.entropy import empirical_entropy, entropy_bits
    bins = torch.div(arch.t3, 5.0).round().to(torch.int64).flatten()
    counts = torch.bincount(bins, minlength=11)
    bits = entropy_bits(counts)
    if bits.device.type != "cuda":
        fail("sim phase: entropy_bits left the card")
    host = col.to_candidate_set(window=arch.window_len).t3
    host_counts = np.bincount((host // 5).astype(np.int64).ravel(),
                              minlength=11)
    if not np.array_equal(counts.cpu().numpy(), host_counts):
        fail("sim phase: the card's T3 histogram differs from the host's")
    want = empirical_entropy(host.ravel())
    diff = abs(float(bits) - want)
    if diff > ENTROPY_TOL:
        fail(f"sim phase: entropy_bits {float(bits)} against {want} "
             f"(|diff| {diff:.3g} > {ENTROPY_TOL})")
    return dict(bits=float(bits), host_bits=want, abs_diff=diff,
                samples=int(host.size))


def sim_baselines(torch, market, col, add) -> dict:
    """One window of ``benchmarks/fig18_19_recommendation.py``'s protocol
    on the contended pools (true capacity crossing 24 nodes over the next
    day): SpotVista's single-type picks at W = 0, 0.5, 1 from the card's
    engine against SpotVerse (T = 4, 6), SpotFleet (LP, CO, PCO) and naive
    single-point (SPS, T3) picks on the instantaneous signals; each pick
    probed for a day (``probe_real_availability``); then SpotVista's W =
    0.5 multi-node pool under ``run_interruption_experiment`` with
    Kaplan-Meier and Cox on its lifetimes (24 nodes a member, the
    member's availability score the covariate)."""
    from repro_torch.cloudsim import (probe_real_availability,
                                      run_interruption_experiment)
    from repro_torch.core import baselines as bl
    from repro_torch.core import cox_ph, kaplan_meier
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.types import ResourceRequest
    from repro_torch.serve import BatchServer

    allc = col.to_candidate_set(window=INGEST_WINDOW)
    t0 = market.now
    keys = list(zip(allc.names, allc.regions, allc.azs))
    idx = np.array([market.pool_index[k] for k in keys])
    caps = np.stack([market.capacity(tt, idx)
                     for tt in t0 + np.arange(0.0, SIM_HORIZON, 60.0)])
    sel = np.flatnonzero((caps.max(0) >= SIM_NODES)
                         & (caps.min(0) < SIM_NODES))
    cands = allc.take(sel)
    keys = [keys[i] for i in sel]
    sps_now = np.array([market.sps(*k, 1, t=t0) or 1 for k in keys])
    t3_now = np.array([market.t3_true(*k, t=t0) for k in keys])
    if_of = {(n, r): market.interruption_free_score(n, r, t=t0)
             for n, r in {(n, r) for n, r, _ in keys}}
    if_now = np.array([if_of[(n, r)] for n, r, _ in keys])

    server = BatchServer(device=DEVICE, bucket_sizes=BUCKETS,
                         config=EngineConfig(score_impl="tiled",
                                             pool_impl="tiled"))
    weights = (0.0, 0.5, 1.0)
    reqs = [ResourceRequest(cpus=SIM_NODES * 4.0, weight=w, max_types=1)
            for w in weights]
    reqs.append(ResourceRequest(cpus=SIM_POOL_CPUS, weight=0.5))
    recs = add("sim phase baselines", lambda: server.serve(cands, reqs))
    row_of = {k: i for i, k in enumerate(keys)}
    picks = {f"spotvista_W{w}": row_of[(r.names[0], r.regions[0], r.azs[0])]
             for w, r in zip(weights, recs)}
    picks["spotverse_T4"] = bl.spotverse_select(sps_now, if_now,
                                                cands.prices, 4).index
    picks["spotverse_T6"] = bl.spotverse_select(sps_now, if_now,
                                                cands.prices, 6).index
    for name, strategy in (("spotfleet_LP", "lowest-price"),
                           ("spotfleet_CO", "capacity-optimized"),
                           ("spotfleet_PCO", "price-capacity-optimized")):
        picks[name] = bl.spotfleet_select(strategy, cands.prices,
                                          t3_now).index
    picks["naive_sps"] = bl.naive_single_point(sps_now, cands.prices).index
    picks["naive_t3"] = bl.naive_single_point(t3_now, cands.prices).index
    targets = sorted({keys[i] for i in picks.values()})
    probed = {p.target: p.real_availability for p in probe_real_availability(
        market, targets, n_nodes=SIM_NODES, duration_min=SIM_HORIZON)}
    outcomes = {name: dict(pick=f"{keys[i][0]}@{keys[i][2]}",
                           availability=probed[keys[i]],
                           hourly_cost=float(cands.prices[i] * SIM_NODES))
                for name, i in picks.items()}

    pool = recs[-1]
    members = list(zip(pool.names, pool.regions, pool.azs))
    life = run_interruption_experiment(
        market, members, [float(x) for x in pool.availability],
        n_nodes=SIM_NODES, horizon_min=SIM_HORIZON)
    km = kaplan_meier(life.durations, life.events)
    cox = cox_ph(life.covariates, life.durations, life.events)
    return dict(contended_pools=int(sel.size), outcomes=outcomes,
                pool=dict(members=len(members),
                          counts=[int(c) for c in pool.counts]),
                lifetimes=dict(nodes=int(life.durations.size),
                               interrupted=int(life.events.sum()),
                               km_median_min=km.median(),
                               km_survival_at_horizon=km.at(SIM_HORIZON),
                               cox_hazard_ratio=cox.hazard_ratio,
                               cox_p_value=cox.p_value,
                               cox_converged=cox.converged))


class pauses:
    """Within the block: every garbage collection's generation and pause
    (``gc.callbacks``), and the device memory segments the caching
    allocator newly reserved (``torch.cuda.memory_stats``)."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        import gc
        self.gc, self.seen, self.t0 = gc, [], None

        def record(phase, info):
            if phase == "start":
                self.t0 = time.perf_counter()
            elif self.t0 is not None:
                self.seen.append((info["generation"],
                                  time.perf_counter() - self.t0))
        self.record = record
        gc.callbacks.append(record)
        self.segments = self._segments()
        return self

    def _segments(self) -> int:
        return int(self.torch.cuda.memory_stats().get(
            "segment.all.allocated", 0))

    def __exit__(self, *exc):
        self.gc.callbacks.remove(self.record)
        self.segments = self._segments() - self.segments

    def summary(self) -> dict:
        ms = [dt * 1e3 for _, dt in self.seen]
        return dict(gc_collections=len(ms),
                    gc_gen2=sum(g == 2 for g, _ in self.seen),
                    gc_max_ms=max(ms, default=0.0), gc_total_ms=sum(ms),
                    new_device_segments=self.segments)


def sim_load(torch, snapshot, add) -> dict:
    """``benchmarks/latency_slo.py``'s scenarios over the ingestor's last
    snapshot on the card: Steady and MMPP2 at 0.6 of the calibrated
    capacity on the filterless and the 64-filter distinct-mask mixes, then
    the mixed mix at 2x capacity with ``shed_depth`` 128.  Every ledger
    must balance and every ticket resolve once."""
    from repro_torch.loadgen import (MMPP2, LoadHarness, Steady,
                                     distinct_mask_mix, filterless_mix,
                                     mixed_mix)
    from repro_torch.serve import BatchServer

    import gc
    # the containers a full collection walks (the simulator's quota book,
    # estimators and archives among them)
    tracked = len(gc.get_objects())
    server = BatchServer(device=DEVICE, bucket_sizes=SLO_BUCKETS)
    cands = snapshot.host
    mixes = {"filterless": filterless_mix(),
             "distinct-mask": distinct_mask_mix(cands, n_filters=64)}
    per_mix = add("sim phase calibration", lambda: [
        bucket_service_s(server, snapshot, m) for m in mixes.values()])
    svc = {b: max(s[b] for s in per_mix) for b in server.bucket_sizes}
    cap = max(SLO_BUCKETS) / svc[max(SLO_BUCKETS)]
    rate = stable_rate(server, svc, UTILIZATION, MAX_WAIT_S)
    arrivals = {"steady": Steady(rate=rate),
                "bursty": MMPP2(rate_low=0.5 * rate, rate_high=2.5 * rate,
                                mean_low_s=SLO_HORIZON_S / 8.0,
                                mean_high_s=SLO_HORIZON_S / 24.0)}
    harness = LoadHarness(server, snapshot, max_wait_s=MAX_WAIT_S,
                          adaptive=True)
    reports, stalls, seed = [], {}, 0
    for mix_name, mix in mixes.items():
        harness.warmup(mix)
        for arr_name, arr in arrivals.items():
            seed += 1
            name = f"{mix_name}/{arr_name}"
            seen = pauses(torch)

            def run():
                with seen:
                    return harness.run(mix, arr, SLO_HORIZON_S, seed=seed,
                                       name=name)
            reports.append(add(f"sim phase {name}", run))
            stalls[name] = seen.summary()
    shed_depth = SHED_DEPTH_BUCKETS * max(SLO_BUCKETS)
    over_mix = mixed_mix(cands, n_filters=8)
    over = LoadHarness(server, snapshot, max_wait_s=MAX_WAIT_S,
                       adaptive=True, shed_depth=shed_depth)

    seen = pauses(torch)

    def overload():
        over.warmup(over_mix)
        warmed = over.warm_pool_cache(over_mix)
        with seen:
            return warmed, over.run(over_mix, Steady(rate=OVERLOAD * cap),
                                    SLO_HORIZON_S, seed=13,
                                    name="mixed/overload-2x")
    warmed, rep = add("sim phase overload", overload)
    stalls[rep.name] = seen.summary()
    reports.append(rep)
    out = []
    for rep in reports:
        shedding = rep.name.endswith("overload-2x")
        if (rep.dropped or rep.errors
                or rep.submitted != rep.served + rep.shed
                or rep.latency.n != rep.served
                or rep.shed_latency.n != rep.shed):
            fail(f"sim phase {rep.name}: the ledger does not balance: "
                 f"{rep.to_dict()}")
        if shedding != (rep.shed > 0):
            fail(f"sim phase {rep.name}: shed {rep.shed} tickets")
        d = rep.to_dict()
        out.append({**{k: d[k] for k in (
            "name", "offered_rate", "submitted", "served", "shed", "errors",
            "dropped", "drains", "latency", "shed_latency", "batch_latency")},
                    "pauses": stalls[rep.name]})
    slo_s = SLO_MARGIN * (MAX_WAIT_S + (shed_depth + max(SLO_BUCKETS)) / cap)
    return dict(gc_tracked_objects=tracked, capacity_rps=cap,
                stable_rate_rps=rate,
                bucket_service_ms={b: s * 1e3 for b, s in svc.items()},
                scenarios=out, memo_warmed=warmed,
                overload_slo_ms=slo_s * 1e3,
                overload_non_shed_p99_ms=rep.latency.quantile(0.99) * 1e3,
                overload_within_slo=rep.latency.quantile(0.99) <= slo_s)


def sim_phase(torch):
    """The paper's pipeline at the full default catalog (see the module
    docstring): collect, ingest on the card, serve through admission,
    recommend against the baselines, run the load harness.  B3's counter is
    set to 0 before the first poll and read after the last; B1's and B2's
    per segment (``launch_segment``), every one of their launches held bit
    for bit."""
    from repro_torch.kernels import stats_update as su

    t_start = time.perf_counter()
    laps, t_lap = {}, [t_start]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    launches = {"score_fuse": 0, "pool_scan": 0}
    err = {"score_fuse": 0.0, "pool_scan": 0.0}

    def add(label, fn):
        out, n, e = launch_segment(torch, label, fn)
        for k in n:
            launches[k] += n[k]
            err[k] = max(err[k], e[k])
        return out

    market, service, col = sim_world()
    lap("world")
    col.run(SIM_PRIME)
    lap("collect")
    su.stats_update.launches = 0
    ing, ingest = sim_ingest(torch, col, add)
    launches["stats_update"] = su.stats_update.launches
    lap("ingest")
    # the quota book after collection, before the baselines move the clock
    book = dict(cycles=col.ticks, queries=service.total_queries,
                accounts_holding=service.book.accounts_holding(),
                accounts_inspected_per_query=(service.book.inspected
                                              / service.total_queries),
                capacity_remaining=service.capacity_remaining())
    if launches["stats_update"] != SIM_TICKS:
        fail(f"sim phase: B3 launched {launches['stats_update']} times over "
             f"{SIM_TICKS} ticks, not once per tick")
    entropy = sim_entropy(torch, col, ing.archive)
    lap("entropy")
    baselines = sim_baselines(torch, market, col, add)
    lap("baselines")
    load = sim_load(torch, ing.archive.snapshot(), add)
    lap("load")
    for name, n in launches.items():
        if n == 0:
            fail(f"sim phase: the path never launched kernel {name}")
    report = dict(
        K=len(col.targets), accounts=SIM_ACCOUNTS, budget=SIM_BUDGET,
        **book, collect_s_per_cycle=laps["collect"] / SIM_PRIME,
        launches=launches, max_abs_err={**err, "stats_update":
                                        ingest.pop("b3_max_abs_err")},
        ingest=ingest, entropy=entropy, baselines=baselines, load=load,
        seconds=laps, phase_s=time.perf_counter() - t_start)
    return launches, report


def bf16_closeness(got, want, floor=None):
    """(count beyond one bf16 ulp, count beyond both one ulp and ``floor``
    (1e-3 * max|want| when ``None``), max |got - want|) of two tensors on
    the card."""
    import torch
    got, want = got.double(), want.double()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    d = (got - want).abs()
    far = d > ulp
    bad = far & (d > (1e-3 * want.abs().max() if floor is None else floor))
    return int(far.sum()), int(bad.sum()), float(d.max())


def generate(torch, model, params, prompt, new: int):
    """Greedy serving: prefill, then ``new - 1`` decode steps.  Returns the
    (B, new) tokens, the (B, new, V) float32 logits they were picked from,
    the prefill time and the per-step decode times (host clock around work
    that ends in a synchronise)."""
    B, S = prompt.shape
    cache = model.init_cache(B, S + new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompt}, cache)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    toks, rows, step_ms = [tok], [logits[:, -1].float()], []
    for i in range(new - 1):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, tok, cache, S + i)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(tok)
        rows.append(logits[:, -1].float())
    return torch.cat(toks, 1), torch.stack(rows, 1), prefill_ms, step_ms


def gmm_times(torch, gmm, name, args, c_rows):
    """Kernel B7 or B8 alone on captured operands: device and call time,
    the plain version's, the bound, torch.bmm's for B8 (``library_ms``) and,
    for B7, ``torch.bmm(x, cat([w1, w3], -1))``: the two products alone, a
    yardstick that no single PyTorch call matches (silu and the product are
    left out), kept apart from ``library_ms``."""
    fn = getattr(gmm, name)
    # both are Hopper kernels of one template: `gmm_up_kernel<MT>` (B7) and
    # `gmm_down_kernel<MT>` (B8)
    symbol = "gmm_down_kernel" if name == "moe_gmm_down" else "gmm_up_kernel"
    call_ms, dev_ms = time_ms(lambda: fn(*args), (symbol,))
    plain_call_ms, plain_dev_ms = time_ms(lambda: fn(*args, backend="torch"),
                                          None)
    x = args[0]
    E, C, K = x.shape
    N = args[1].shape[-1]
    n_w = len(args) - 1
    nbytes = 2 * (E * C * K + n_w * E * K * N + E * C * N)
    nops = 2 * n_w * E * C * K * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / BF16_OPS_PER_S * 1e3
    ms = dev_ms if dev_ms is not None else call_ms
    extra = {"library_ms": None}
    if name == "moe_gmm_down":
        lib_call_ms, lib_dev_ms = time_ms(lambda: torch.bmm(*args), None)
        lib_ms = lib_dev_ms if lib_dev_ms is not None else lib_call_ms
        extra.update(library_ms=lib_ms, ratio_to_library=ms / lib_ms)
    else:
        w13 = torch.cat(args[1:], -1)
        bmm_call_ms, bmm_dev_ms = time_ms(lambda: torch.bmm(x, w13), None)
        bmm_ms = bmm_dev_ms if bmm_dev_ms is not None else bmm_call_ms
        extra.update(products_bmm_ms=bmm_ms, ratio_to_products_bmm=ms / bmm_ms)
        del w13
    return dict(E=E, C=C, K=K, N=N, c_rows=c_rows, ms=ms,
                ms_source="profiler" if dev_ms is not None else "events",
                call_ms=call_ms,
                plain_ms=plain_dev_ms if plain_dev_ms is not None
                else plain_call_ms,
                plain_call_ms=plain_call_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=nops, **extra)


def _layer_stack(cfg, params, cache):
    """(kind, moe, params, cache) of every layer in order, as views (the
    cache ``None`` for every layer when ``cache`` is ``None``)."""
    from repro_torch.models import lm
    from repro_torch.models.param import tree_map
    prefix, scanned, suffix, U = lm._partition(cfg)
    info = lambda i: (lm._layer_kind(cfg, i), lm._is_moe_layer(cfg, i))  # noqa: E731
    part = lambda name, n: cache[name][n] if cache else None  # noqa: E731
    out = [(*info(i), params["prefix"][n], part("prefix", n))
           for n, i in enumerate(prefix)]
    for u in range(U):
        p_u = tree_map(lambda a: a[u], params["unit"])
        c_u = tree_map(lambda a: a[u], cache["unit"]) if cache else None
        for j in range(cfg.repeat_unit):
            i = scanned[u * cfg.repeat_unit + j]
            out.append((*info(i), p_u[f"b{j}"], c_u[f"b{j}"] if c_u else None))
    out += [(*info(i), params["suffix"][n], part("suffix", n))
            for n, i in enumerate(suffix)]
    return out


def layerwise(torch, cfg, ref_cfg, params, prompt, *, cached=True,
              exact=None):
    """Each layer's update ``out - in`` through ``cfg`` (kernels) and
    ``ref_cfg`` (the plain route) on the same input and the same starting
    cache, at prefill and at the first decode step, the stack advancing on
    ``cfg``'s output and cache.  With ``cached=False`` the walk is the
    full-sequence forward's: no cache, every layer over the whole prompt,
    no decode step, and each layer is also run in float32 (parameters and
    input upcast, the plain route); each route's distance from that is
    recorded in ``exact`` (|update - update_f32| / |update_f32|, per
    layer: ``cfg``'s, then ``ref_cfg``'s).  Returns the per-layer
    |update_cfg - update_ref| / |update_cfg| (Frobenius norms) at prefill
    (or the forward) and at the decode step (empty without a cache)."""
    from repro_torch.models import lm
    from repro_torch.models.param import tree_map
    B, S = prompt.shape
    cache = lm.init_cache(cfg, B, S + 1, prompt.device) if cached else None
    stack = _layer_stack(cfg, params, cache)

    def walk(x, positions, index, valid, decode):
        devs = []
        for kind, moe, p, c in stack:
            # the plain route starts from a copy of the same cache (the
            # recurrent states are read and written in place)
            c_ref = tree_map(torch.clone, c)
            xa = lm._apply_layer(cfg, kind, moe, p, x, positions, c, index,
                                 valid, decode)[0]
            xb = lm._apply_layer(ref_cfg, kind, moe, p, x, positions, c_ref,
                                 index, valid, decode)[0]
            upd = (xa.float() - x.float()).norm()
            devs.append(float((xa.float() - xb.float()).norm() / upd))
            if exact is not None:
                xf = lm._apply_layer(ref_cfg, kind, moe, tree_map(
                    lambda t: t.float(), p), x.float(), positions, None,
                    index, valid, decode)[0] - x.float()
                exact.append(tuple(
                    float((y.float() - x.float() - xf).norm() / xf.norm())
                    for y in (xa, xb)))
            x = xa
        return x, devs

    with torch.no_grad():
        x = lm._embed_inputs(cfg, params, prompt, None)
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        if not cached:
            return walk(x, pos, None, None, False)[1], []
        x, pre = walk(x, pos, 0, S, False)
        z = lm.rmsnorm(params["final_norm"], x[:, -1:], cfg.rms_eps)
        tok = lm._logits(cfg, params, z)[:, -1].argmax(-1, keepdim=True)
        x1 = lm._embed_inputs(cfg, params, tok, None)
        pos1 = torch.full((B, 1), S, dtype=torch.int32, device=x.device)
        _, dec = walk(x1, pos1, S, S + 1, True)
    return pre, dec


def sensitivity(torch, cfg, params, prompt):
    """How far the model amplifies rounding: the prefill's last-position
    logits after a one-ulp step of one embedding element, against the
    unperturbed run, relative to max|logits|."""
    from repro_torch.models import lm
    B, S = prompt.shape
    out = []
    with torch.no_grad():
        for bump in (False, True):
            x = lm._embed_inputs(cfg, params, prompt, None)
            if bump:
                x.view(torch.int16)[0, 0, 0] += 1
            pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
            cache = lm.init_cache(cfg, B, S, x.device)
            x, _, _ = lm._run_stack(cfg, params, x, pos, cache, 0, S, False)
            out.append(lm._logits(cfg, params, x[:, -1:]).float())
    return float((out[1] - out[0]).abs().max() / out[0].abs().max())


def profile_decode(torch, model, params, prompt):
    """One decode step under ``torch.profiler``: wall time, the device's
    busy time and idle share, and the largest device and host items."""
    from torch.profiler import ProfilerActivity, profile
    B, S = prompt.shape
    cache = model.init_cache(B, S + 1)
    logits, cache = model.prefill(params, {"tokens": prompt}, cache)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode_step(params, tok, cache, S)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev, host = [], []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            dev.append((dev_us / 1e3, evt.key[:60]))
        if evt.self_cpu_time_total > 0:
            host.append((evt.self_cpu_time_total / 1e3, evt.key[:60],
                         evt.count))
    dev.sort(reverse=True)
    host.sort(reverse=True)
    busy = sum(ms for ms, k in dev if not k.startswith("aten::"))
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=1 - busy / wall_ms if wall_ms > 0 else None,
                device_top=[[round(ms, 4), k] for ms, k in dev[:10]],
                host_top=[[round(ms, 4), k, n] for ms, k, n in host[:12]])


def wkv_cost(B, S, H, D):
    """(bytes, TF32 tensor-core flops, float32 operations) that one B5 call
    needs as the kernel computes it: each input read once, each output
    written once; per (batch, head) and chunk (C = 32 rows, the last one
    padded) the tensor-core products, three for each multiply-add of the
    inter term (C x D x D) and the off-diagonal block (16 x 16 x D) and two
    where one operand is bf16 v (att @ v over the 16 and 32 columns rows
    0-15 and 16-31 see, the state update D x C x D); and the float32 work:
    the cumsum's five scan steps, the per-element decays (r exp(cw_{i-1}),
    q~ or k~, k exp(cw_C - cw): a difference, a scaling, an exponential
    and a product each), the bonus, the pairwise decays of the two
    diagonal 16 x 16 triangles (a difference, two clips, a scaling, an
    exponential, a product and a multiply-add per channel), the operand
    splits, and the state's decay."""
    from repro_torch.kernels.rwkv6_scan import CHUNK
    nbytes = 2 * 3 * B * S * H * D + 4 * B * S * H * D + 4 * H * D \
        + 4 * B * H * D * D + 4 * B * S * H * D + 4 * B * H * D * D
    C, sub = CHUNK, CHUNK // 2
    chunks = -(-S // C)
    macs3 = C * D * D + sub * sub * D
    macs2 = (sub * sub + C * C // 2) * D + D * C * D
    tf32 = 2 * (3 * macs3 + 2 * macs2)
    pairs = 2 * sub * (sub - 1) // 2
    fp32 = (5 * C * D                       # cumsum
            + 4 * 3 * C * D                 # per-element decays
            + 3 * C * D + 2 * C             # bonus
            + 8 * pairs * D                 # pairwise decays
            + 2 * 3 * (C * D + 2 * sub * D + C * C + C * D)  # operand splits
            + D * D + C * D)                # state decay; out's sum
    return nbytes, tf32 * chunks * B * H, fp32 * chunks * B * H


def rglru_cost(B, S, R):
    """(bytes, float32 operations) that one B6 call needs: log_a and x read
    once, hs written once, h0 and h_last; per channel and chunk of c rows
    the carry fold (an exponential, a product, an add) and the doubling
    steps (an exponential, a product and two adds on each row t >= off)."""
    from repro_torch.kernels.rglru_scan import CHUNK
    nbytes = 4 * 3 * B * S * R + 4 * 2 * B * R
    ops = 0
    for t0 in range(0, S, CHUNK):
        c = min(CHUNK, S - t0)
        ops += 3 + sum(4 * (c - (1 << d)) for d in range(c.bit_length())
                       if c > (1 << d))
    return nbytes, ops * B * R


def scan_times(torch, fn, args, knames, cost):
    """A scan kernel alone on captured inputs: device and call time, the
    plain version's, and the bound: bytes at the memory rate against the
    operations at their type's peak (``cost`` is (bytes, float32 ops) or
    (bytes, TF32 tensor flops, float32 ops))."""
    call_ms, dev_ms = time_ms(lambda: fn(*args), knames)
    plain_call_ms, plain_dev_ms = time_ms(lambda: fn(*args, backend="torch"),
                                          None)
    nbytes, *ops = cost
    tf32, fp32 = ops if len(ops) == 2 else (0, ops[0])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (tf32 / TF32_OPS_PER_S + fp32 / FP32_OPS_PER_S) * 1e3
    return dict(shape=list(args[0].shape),
                ms=dev_ms if dev_ms is not None else call_ms,
                ms_source="profiler" if dev_ms is not None else "events",
                call_ms=call_ms,
                plain_ms=plain_dev_ms if plain_dev_ms is not None
                else plain_call_ms,
                plain_call_ms=plain_call_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=tf32 + fp32, tf32_flops=tf32,
                fp32_ops=fp32, library_ms=None)


def hold_gmm(torch, arch, captured, c_prefill, c_decode):
    """B7 and B8 against their plain versions on the first MoE layer's
    operands at prefill and at a decode step (one bf16 ulp or 1e-3 * max),
    and their times there."""
    from repro_torch.kernels import moe_gmm as gmm
    checks, max_err, shapes = {}, {}, {}
    for (name, phase), args in sorted(captured.items()):
        fn = getattr(gmm, name)
        got, plain = fn(*args), fn(*args, backend="torch")
        torch.cuda.synchronize()
        far, bad, err = bf16_closeness(got, plain)
        checks[f"{name}@{phase}"] = dict(shape=list(args[0].shape),
                                         beyond_one_ulp=far, max_abs_err=err,
                                         elements=got.numel())
        if bad:
            fail(f"{arch}: {name} at {phase} differs from its plain version "
                 f"in {bad} elements beyond one bf16 ulp and 1e-3 * max")
        max_err[name] = max(max_err.get(name, 0.0), err)
        shapes.setdefault(name, {})[phase] = gmm_times(
            torch, gmm, name, args, c_prefill if phase == "prefill" else c_decode)
    if len(checks) != 4:
        fail(f"{arch}: captured {sorted(checks)}, expected both kernels at "
             "prefill and decode")
    timings = {name: {**s["decode"], "max_abs_err": max_err[name], "shapes": s}
               for name, s in shapes.items()}
    return checks, timings


def hold_wkv(torch, arch, captured):
    """B5 against its plain version on the first rwkv layer's inputs: as
    captured; with a seeded random ``u`` (the model draws ``u`` as zeros,
    which leaves the current token's bonus untested); and on a ragged prefix
    of them with that ``u``, starting from the state the first check ends
    in.  Each output must lie within ``WKV_TOL`` of its own max|plain|."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    args = captured[("rwkv6_scan", "prefill")]
    r, k, v, log_w, u, s0 = args
    u_rand = torch.from_numpy(np.random.default_rng(LM_SEED).standard_normal(
        tuple(u.shape)).astype(np.float32)).to(u.device)
    checks = {}

    def hold(label, a):
        got, plain = rwkv6_scan(*a), rwkv6_scan(*a, backend="torch")
        torch.cuda.synchronize()
        checks[label] = {"shape": list(a[0].shape)}
        for part, g, w in zip(("out", "s_final"), got, plain):
            err, scale = float((g - w).abs().max()), float(w.abs().max())
            checks[label][part] = dict(max_abs_err=err, max_abs_plain=scale)
            if err > WKV_TOL * scale:
                fail(f"{arch}: rwkv6_scan's {part} at {label} differs from "
                     f"its plain version by {err:.3g} > {WKV_TOL} x "
                     f"max|plain| {scale:.3g}")
        return plain

    plain = hold("prefill", args)
    hold("prefill, u ~ N(0, 1)", (r, k, v, log_w, u_rand, s0))
    hold(f"S={RAGGED_S}, u ~ N(0, 1)",
         (*(t[:, :RAGGED_S].contiguous() for t in (r, k, v, log_w)), u_rand,
          plain[1].contiguous()))
    timing = scan_times(torch, rwkv6_scan, args, ("wkv_kernel",),
                        wkv_cost(*r.shape))
    timing.update(max_abs_err=max(c[p]["max_abs_err"] for c in checks.values()
                                  for p in ("out", "s_final")),
                  tolerance=f"{WKV_TOL} x max|plain| of each output")
    return checks, {"rwkv6_scan": timing}


def hold_rglru(torch, arch, captured):
    """B6 against its plain version, bit for bit, on the first rglru
    layer's inputs and on a ragged prefix of them that starts from the state
    the first check ends in."""
    from repro_torch.kernels.rglru_scan import rglru_scan
    args = captured[("rglru_scan", "prefill")]
    log_a, x_in, _ = args
    checks = {}

    def hold(label, a):
        got, plain = rglru_scan(*a), rglru_scan(*a, backend="torch")
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, plain))
        same = all(same_bits(g, w) for g, w in zip(got, plain))
        checks[label] = dict(shape=list(a[0].shape), max_abs_err=err,
                             bit_identical=same)
        if not same:
            fail(f"{arch}: rglru_scan at {label} is not bit-identical to its "
                 "plain version")
        return plain

    plain = hold("prefill", args)
    hold(f"S={RAGGED_S}", (log_a[:, :RAGGED_S].contiguous(),
                           x_in[:, :RAGGED_S].contiguous(),
                           plain[1].contiguous()))
    timing = scan_times(torch, rglru_scan, args, ("rglru_kernel",),
                        rglru_cost(*log_a.shape))
    timing.update(max_abs_err=max(c["max_abs_err"] for c in checks.values()),
                  tolerance="bit-identical",
                  plan=rglru_plan_line(torch, *log_a.shape))
    return checks, {"rglru_scan": timing}


def lm_path(cfg):
    """What :func:`lm_phase` drives and holds for ``cfg``: the model module
    whose kernel wrappers it patches to capture operands (``kernels``: name
    -> (module attribute, wrapper)), the launches each kernel must make in
    one prefill and ``LM_NEW - 1`` decode steps, which phase a call belongs
    to, the check of the captured operands, and whether greedy tokens may
    part from the plain route only at a small margin."""
    from repro_torch.kernels import moe_gmm, rglru_scan, rwkv6_scan
    from repro_torch.models import moe, rglru, rwkv6
    if cfg.moe:
        # DeepSeek-V2-Lite: B7/B8 in every MoE layer, at prefill and decode
        n = cfg.num_layers - cfg.moe.first_dense_layers
        c_prefill = moe.capacity_of(cfg, LM_BATCH * LM_PROMPT)
        c_decode = moe.capacity_of(cfg, LM_BATCH)
        return dict(
            module=moe, layers=n, launches=n * LM_NEW,
            per=f"once per MoE layer ({n}) and forward ({LM_NEW})",
            kernels={"moe_gmm": ("moe_gmm", moe_gmm.moe_gmm),
                     "moe_gmm_down": ("moe_gmm_down", moe_gmm.moe_gmm_down)},
            phase=lambda args: ("prefill" if args[0].shape[1] == c_prefill
                                else "decode"),
            hold=lambda torch, arch, captured: hold_gmm(
                torch, arch, captured, c_prefill, c_decode),
            gate_parting=True)
    # the recurrent models: the scan kernel at prefill, the reference's step
    # function at decode
    kind = "rwkv" if "rwkv" in cfg.block_pattern else "rglru"
    n = sum(cfg.block_pattern[i % cfg.repeat_unit] == kind
            for i in range(cfg.num_layers))
    common = dict(layers=n, launches=n, phase=lambda args: "prefill",
                  per=f"once per {kind} layer of the prefill ({n})",
                  gate_parting=False)
    if kind == "rwkv":
        return dict(common, module=rwkv6, hold=hold_wkv, kernels={
            "rwkv6_scan": ("rwkv6_scan", rwkv6_scan.rwkv6_scan)})
    return dict(common, module=rglru, hold=hold_rglru, kernels={
        "rglru_scan": ("rglru_kernel", rglru_scan.rglru_scan)})


def lm_phase(torch, arch):
    """``arch`` served at full width and depth through its kernels
    (:func:`lm_path`), then held against the plain route."""
    from dataclasses import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: full fp32
    cfg = replace(get_config(arch), use_pallas=True)
    path = lm_path(cfg)
    kernels, module = path["kernels"], path["module"]
    model = get_model(cfg, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(LM_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    report = dict(arch=arch, layers=cfg.num_layers,
                  kernel_layers=path["layers"], params=model.num_params(),
                  param_bytes_allocated=torch.cuda.memory_allocated(),
                  init_s=init_s, batch=LM_BATCH, prompt=LM_PROMPT,
                  new_tokens=LM_NEW)
    print(f"{arch}: {cfg.num_layers} layers ({path['layers']} through "
          f"{' + '.join(kernels)}), {report['params']} parameters, "
          f"{report['param_bytes_allocated'] / 1e9:.2f} GB allocated, drawn "
          f"in {init_s:.1f} s")
    prompt = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to(DEVICE)

    # warm-up (prefill + 2 steps), capturing each kernel's first operands in
    # each phase (prefill, decode) that it runs in
    captured = {}
    real = {name: getattr(module, attr) for name, (attr, _) in kernels.items()}

    def capturing(name):
        def wrapper(*args, **kw):
            captured.setdefault((name, path["phase"](args)), args)
            return real[name](*args, **kw)
        return wrapper

    for name, (attr, _) in kernels.items():
        setattr(module, attr, capturing(name))
    try:
        generate(torch, model, params, prompt, 3)
    finally:
        for name, (attr, _) in kernels.items():
            setattr(module, attr, real[name])

    for _, fn in kernels.values():
        fn.launches = 0
    toks, rows, prefill_ms, step_ms = generate(torch, model, params, prompt,
                                               LM_NEW)
    launches = {name: fn.launches for name, (_, fn) in kernels.items()}
    for name, n in launches.items():
        if n != path["launches"]:
            fail(f"{arch}: {name} launched {n} times in one prefill and "
                 f"{LM_NEW - 1} decode steps, not {path['per']}: "
                 f"{path['launches']}")
    if not bool(torch.isfinite(rows).all()):
        fail(f"{arch}: non-finite logits")
    if tuple(toks.shape) != (LM_BATCH, LM_NEW):
        fail(f"{arch}: generated {tuple(toks.shape)} tokens")
    report["peak_bytes"] = torch.cuda.max_memory_allocated()
    served = LM_BATCH * LM_NEW
    report.update(
        prefill_ms=prefill_ms,
        decode_ms={"p50": float(np.percentile(step_ms, 50)),
                   "p90": float(np.percentile(step_ms, 90)),
                   "max": float(np.max(step_ms)), "steps": len(step_ms)},
        decode_tokens_per_s=LM_BATCH / (np.percentile(step_ms, 50) / 1e3),
        tokens_per_s=served / ((prefill_ms + sum(step_ms)) / 1e3),
        launches=launches)

    checks, timings = path["hold"](torch, arch, captured)
    report["kernel_checks"] = checks

    # the same weights through the reference's plain route (einsum experts,
    # chunked scans)
    ref_cfg = replace(cfg, use_pallas=False)
    ref_toks, ref_rows, ref_prefill_ms, ref_step_ms = generate(
        torch, get_model(ref_cfg, device=DEVICE), params, prompt, LM_NEW)
    d_prefill = float((rows[:, 0] - ref_rows[:, 0]).abs().max())
    agree = (toks == ref_toks).cpu().numpy()
    top2 = rows.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    excused = parted = 0
    shared_dev = 0.0
    for b in range(LM_BATCH):
        off = np.flatnonzero(~agree[b])
        t0_ = int(off[0]) if off.size else LM_NEW
        # logits on identical contexts: every step up to the first parting
        upto = min(t0_ + 1, LM_NEW)
        shared_dev = max(shared_dev, float(
            (rows[b, :upto] - ref_rows[b, :upto]).abs().max()))
        if off.size:
            parted += 1
            if path["gate_parting"] and margin[b, t0_] >= 2 * d_prefill:
                fail(f"{arch}: sequence {b} parts from the plain route at "
                     f"step {t0_} with a top-1/top-2 margin "
                     f"{margin[b, t0_]:.4g} >= 2 x prefill max|dlogits| "
                     f"{2 * d_prefill:.4g}")
            excused += int(off.size)
    report["plain_route"] = dict(
        prefill_max_abs_dlogits=d_prefill,
        prefill_rel_dlogits=d_prefill / float(ref_rows[:, 0].abs().max()),
        shared_context_max_abs_dlogits=shared_dev,
        tokens_agree=int(agree.sum()), tokens=served,
        sequences_parted=parted, disagreements_after_parting=excused,
        parting_gated=path["gate_parting"], prefill_ms=ref_prefill_ms,
        decode_ms_p50=float(np.percentile(ref_step_ms, 50)))

    # layer by layer on the same inputs: the two routes differ only in the
    # kernels' work, so each layer's update must agree to rounding
    pre, dec = layerwise(torch, cfg, ref_cfg, params, prompt)
    report["layerwise_update_rel_dev"] = dict(
        prefill_max=max(pre), decode_max=max(dec), prefill=pre, decode=dec)
    worst = max(pre + dec)
    if worst > LAYER_TOL:
        fail(f"{arch}: a layer's update differs between the kernel and plain "
             f"routes by {worst:.3g} of its norm (> {LAYER_TOL})")
    report["one_ulp_sensitivity"] = sensitivity(torch, cfg, params, prompt)
    report["decode_profile"] = profile_decode(torch, model, params, prompt)
    del params, captured
    torch.cuda.empty_cache()
    return launches, timings, report


def flash_cost(B, Sq, Sk, H, KV, D):
    """(bytes, bf16 operations) that one causal B4 call needs: q, k and v
    read once and the output written once; per (batch, head) the two
    products over the causal triangle of Sq(Sq + 1)/2 (query, key) pairs
    (``Sq == Sk``), 2D operations each."""
    nbytes = 2 * (2 * B * Sq * H * D + 2 * B * Sk * KV * D)
    return nbytes, 4 * B * H * (Sq * (Sq + 1) // 2) * D


def hold_flash(torch, captured):
    """B4 against its plain version on the first layer's q, k, v as
    captured, on a ragged prefix (S = 4000) and a short one (S = 77) of
    them, and on seeded inputs with G = 1, D = 128, S = 1000: every output
    within one bf16 ulp, or within ``FLASH_P_ULP`` * max|v|.  The count
    beyond the B7/B8 contract (one ulp or 1e-3 * max|plain|) is recorded."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = captured
    D = q.shape[-1]
    rng = np.random.default_rng(LM_SEED)
    on = lambda a: torch.from_numpy(a.astype(np.float32)).to(  # noqa: E731
        DEVICE).to(torch.bfloat16)
    cases = [("captured", (q, k, v), D ** -0.5)]
    for S in FLASH_PREFIXES:
        cases.append((f"S={S}", tuple(t[:, :S].contiguous() for t in (q, k, v)),
                      D ** -0.5))
    cases.append(("G=1, D=128, S=1000",
                  (on(rng.standard_normal((2, 1000, 8, 128))),
                   on(rng.standard_normal((2, 1000, 8, 128))),
                   on(rng.standard_normal((2, 1000, 8, 128)))), 128 ** -0.5))
    checks, max_err = {}, 0.0
    for label, args, scale in cases:
        got = fa.flash_attention(*args, scale=scale)
        plain = fa.flash_attention(*args, scale=scale, backend="torch")
        torch.cuda.synchronize()
        floor = FLASH_P_ULP * float(args[2].abs().max())
        far, bad, err = bf16_closeness(got, plain, floor)
        checks[label] = dict(q_shape=list(args[0].shape),
                             kv_heads=args[1].shape[2], beyond_one_ulp=far,
                             beyond_b7_b8_contract=bf16_closeness(got, plain)[1],
                             max_abs_err=err, bound=floor,
                             max_abs_plain=float(plain.abs().max()),
                             elements=got.numel())
        if bad or not bool(torch.isfinite(got).all()):
            fail(f"flash_attention at {label} differs from its plain version "
                 f"in {bad} elements beyond one bf16 ulp and {FLASH_P_ULP} x "
                 f"max|v| = {floor:.3g} (max |d| {err:.3g})")
        max_err = max(max_err, err)
    return checks, max_err


def flash_times(torch, captured):
    """B4 alone on the captured q, k, v: device and call time, the plain
    version's, scaled_dot_product_attention's (timed only: the port never
    calls it) and the bound."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = captured
    B, S, H, D = q.shape
    scale = D ** -0.5
    call_ms, dev_ms = time_ms(lambda: fa.flash_attention(q, k, v, scale=scale),
                              ("flash_kernel",))
    plain_call_ms, plain_dev_ms = time_ms(
        lambda: fa.flash_attention(q, k, v, scale=scale, backend="torch"), None)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_call_ms, lib_dev_ms = time_ms(
        lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True, scale=scale),
        None)
    nbytes, nops = flash_cost(B, S, k.shape[1], H, k.shape[2], D)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / BF16_OPS_PER_S * 1e3
    ms = dev_ms if dev_ms is not None else call_ms
    lib_ms = lib_dev_ms if lib_dev_ms is not None else lib_call_ms
    return dict(shape=[B, S, H, D], kv_heads=k.shape[2], ms=ms,
                ratio_to_library=ms / lib_ms,
                ms_source="profiler" if dev_ms is not None else "events",
                call_ms=call_ms,
                plain_ms=plain_dev_ms if plain_dev_ms is not None
                else plain_call_ms,
                plain_call_ms=plain_call_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=nops, library_ms=lib_ms,
                library="scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True)")


def profile_call(torch, fn):
    """``fn()`` once under ``torch.profiler``: wall time, the device's busy
    time and idle share, and the largest device items."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        # "Command Buffer Full" is the tracer's record of a stalled launch
        # queue, not device work
        if (dev_us > 0 and not evt.key.startswith("aten::")
                and not evt.key.startswith("Command Buffer")):
            dev.append((dev_us / 1e3, evt.key[:60]))
    dev.sort(reverse=True)
    busy = sum(ms for ms, _ in dev)
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=1 - busy / wall_ms if wall_ms > 0 else None,
                device_top=[[round(ms, 4), k] for ms, k in dev[:10]])


def batch_cross_entropy(torch, logits, labels):
    """The port's ``cross_entropy`` over a (B, S, V) batch, one row at a
    time (the float32 upcast of all rows at once would take 20 GB): the
    mean of the rows' means, which is the batch mean."""
    from repro_torch.train import cross_entropy
    rows = [cross_entropy(logits[b:b + 1], labels[b:b + 1])
            for b in range(logits.shape[0])]
    return float(torch.stack(rows).mean())


def forward_phase(torch):
    """qwen2-0.5b's full-sequence forward at full width and depth through
    ``Model.forward`` with ``use_pallas=True``: B4 in every layer."""
    from dataclasses import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention, get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(get_config(FWD_ARCH), use_pallas=True)
    model = get_model(cfg, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(LM_SEED))
    batch = make_pipeline(cfg, FWD_SEQ, FWD_BATCH, seed=0,
                          device=DEVICE).batch(0)
    torch.cuda.synchronize()
    report = dict(arch=FWD_ARCH, layers=cfg.num_layers,
                  params=model.num_params(), batch=FWD_BATCH, seq=FWD_SEQ,
                  batch_cut="train_4k's global batch of 256 cut to 8 to fit "
                            "one card")
    print(f"{FWD_ARCH}: {cfg.num_layers} layers, {report['params']} "
          f"parameters, forward of {FWD_BATCH} x {FWD_SEQ} tokens")

    # warm-up forward, capturing the first layer's q, k, v
    captured = []

    def capturing(q, k, v, **kw):
        if not captured:
            captured.append((q, k, v))
        return fa.flash_attention(q, k, v, **kw)

    attention.flash_attention = capturing
    try:
        with torch.no_grad():
            model.forward(params, batch, train=False)
    finally:
        attention.flash_attention = fa.flash_attention
    q, k, v = captured[0]
    expect = (FWD_BATCH, FWD_SEQ, cfg.num_heads, cfg.head_dim)
    if tuple(q.shape) != expect or k.shape[2] != cfg.num_kv_heads:
        fail(f"B4 was called at {tuple(q.shape)} with {k.shape[2]} KV heads, "
             f"not {expect} with {cfg.num_kv_heads}")

    # the main path: one forward with the counter from 0
    fa.flash_attention.launches = 0
    torch.cuda.synchronize()
    with torch.no_grad():
        logits, aux = model.forward(params, batch, train=False)
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    if launches != cfg.num_layers:
        fail(f"flash_attention launched {launches} times in one forward, not "
             f"once per layer ({cfg.num_layers})")
    if tuple(logits.shape) != (FWD_BATCH, FWD_SEQ, cfg.vocab_size):
        fail(f"forward gave logits of shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        fail("non-finite logits from the forward")
    report["cross_entropy"] = batch_cross_entropy(torch, logits,
                                                  batch["labels"])
    report["aux"] = float(aux)
    del logits

    forward_ms = []
    for _ in range(FWD_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model.forward(params, batch, train=False)[0]
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t0) * 1e3)
        del out
    p50 = float(np.percentile(forward_ms, 50))
    report.update(
        launches_per_forward=launches,
        forward_ms={"p50": p50, "p90": float(np.percentile(forward_ms, 90)),
                    "calls": FWD_CALLS},
        tokens_per_s=FWD_BATCH * FWD_SEQ / (p50 / 1e3),
        peak_bytes=torch.cuda.max_memory_allocated())

    checks, max_err = hold_flash(torch, captured[0])
    report["kernel_checks"] = checks
    timing = flash_times(torch, captured[0])
    timing["max_abs_err"] = max_err
    ref_cfg = replace(cfg, use_pallas=False)
    exact = []
    pre, _ = layerwise(torch, cfg, ref_cfg, params, batch["tokens"],
                       cached=False, exact=exact)
    report["layerwise_update_rel_dev"] = dict(
        forward_max=max(pre), forward=pre,
        b4_vs_float32=[e[0] for e in exact],
        plain_vs_float32=[e[1] for e in exact])
    worst = max(pre + [e[0] for e in exact])
    if worst > FWD_LAYER_TOL:
        fail(f"{FWD_ARCH}: a layer's update through B4 differs from the plain "
             f"route's or the float32 layer's by {worst:.3g} of its norm "
             f"(> {FWD_LAYER_TOL})")
    with torch.no_grad():
        report["forward_profile"] = profile_call(
            torch, lambda: model.forward(params, batch, train=False))
    del params, captured, q, k, v
    torch.cuda.empty_cache()
    return {"flash_attention": launches}, {"flash_attention": timing}, report


def train_phase(torch, forward_ce: float):
    """qwen2-0.5b trained at full width and depth through
    ``build_train_step`` on the reference's training route
    (``use_pallas=False``): ``TRAIN_STEPS`` steps of ``FWD_BATCH`` x
    ``FWD_SEQ`` tokens in ``TRAIN_ACCUM`` microbatches, from the forward
    phase's initial parameters and first batch."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import get_model
    from repro_torch.train import build_train_step, init_train_state
    from repro_torch.train.optim import lr_schedule

    cfg = get_config(FWD_ARCH)
    if cfg.use_pallas:
        fail("the training route must be the plain one (use_pallas=False)")
    model = get_model(cfg, device=DEVICE)
    tcfg = TrainConfig(grad_accum=TRAIN_ACCUM)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(
        model, tcfg, torch.Generator(device=DEVICE).manual_seed(LM_SEED))
    first = {name: state.params["unit"]["b0"]["mix"][name].clone()
             for name in ("wq", "bk")}
    first["embed"] = state.params["embed"][:64].clone()
    step_fn = build_train_step(model, tcfg)
    pipe = make_pipeline(cfg, FWD_SEQ, FWD_BATCH, seed=0, device=DEVICE)
    fa.flash_attention.launches = 0
    losses, norms, step_ms = [], [], []
    for i in range(TRAIN_STEPS):
        batch = pipe.batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        want_lr = float(lr_schedule(tcfg, torch.tensor(i + 1, dtype=torch.int32,
                                                       device=DEVICE)))
        if float(metrics["lr"]) != want_lr:
            fail(f"train step {i}: lr {float(metrics['lr'])} is not "
                 f"lr_schedule's {want_lr}")
    if fa.flash_attention.launches != 0:
        fail(f"the training route launched B4 {fa.flash_attention.launches} "
             "times; it has no backward and must not run there")
    if not all(np.isfinite(x) and x > 0 for x in losses + norms):
        fail(f"train losses {losses} or gradient norms {norms} not finite "
             "and positive")
    moved = {name: float((state.params["unit"]["b0"]["mix"][name].float()
                          - t.float()).norm())
             for name, t in first.items() if name != "embed"}
    moved["embed"] = float((state.params["embed"][:64].float()
                            - first["embed"].float()).norm())
    if not all(d > 0 for d in moved.values()):
        fail(f"parameters did not move: {moved}")
    rel = abs(losses[0] - forward_ce) / forward_ce
    if rel > TRAIN_CE_TOL:
        fail(f"first train loss {losses[0]:.6g} is {rel:.3g} off the B4 "
             f"forward's cross-entropy {forward_ce:.6g} (> {TRAIN_CE_TOL})")
    p50 = float(np.percentile(step_ms, 50))
    tokens = FWD_BATCH * FWD_SEQ
    batch = pipe.batch(TRAIN_STEPS)
    holder = [state]

    def one_step():
        holder[0] = step_fn(holder[0], batch)[0]

    step_profile = profile_call(torch, one_step)
    state = holder[0]
    report = dict(
        arch=FWD_ARCH, steps=TRAIN_STEPS, batch=FWD_BATCH, seq=FWD_SEQ,
        grad_accum=TRAIN_ACCUM, losses=losses, grad_norms=norms,
        first_loss_vs_b4_forward_ce=dict(train=losses[0], forward=forward_ce,
                                         rel=rel),
        params_moved=moved, step_ms=step_ms, step_ms_p50=p50,
        tokens_per_s=tokens / (p50 / 1e3),
        peak_bytes=torch.cuda.max_memory_allocated(),
        model_flops_share=6 * model.num_params() * tokens / (p50 / 1e3)
        / BF16_OPS_PER_S,
        b4_launches=fa.flash_attention.launches, step_profile=step_profile)
    del state, holder
    torch.cuda.empty_cache()
    return report


def hopper_smem_line() -> str:
    """The dynamic shared memory of B4, B7, B8 and B5 by configuration
    (ptxas reports static shared memory only)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.kernels import rwkv6_scan as wkv
    b4 = ", ".join(f"D={d}: {fa.launch_plan(1, 128, 1, d).smem_bytes}"
                   for d in fa.HEAD_DIMS)
    gmm_line = {
        kernel: ", ".join(
            f"{t} m64 tiles: "
            f"{gmm.gmm_plan(1, 64 * t, 64, 128, 1, up=up).smem_bytes}"
            for t in (1, 2, 4))
        for kernel, up in (("gmm_up_kernel", True), ("gmm_down_kernel", False))}
    b5 = ", ".join(f"D={d}: {wkv.smem_bytes(d)}" for d in wkv.CUDA_HEAD_DIMS)
    return (f"dynamic shared memory a block (bytes): flash_kernel {b4}; "
            + "; ".join(f"{k} {v}" for k, v in gmm_line.items())
            + f"; wkv_kernel {b5}")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script measures the port on a GPU")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"src/repro_torch not found beside {Path(__file__).name}: "
             "run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.serve import DeviceArchive

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    sources = ("score_fuse", "pool_scan", "stats_update", "moe_gmm",
               "rwkv6_scan", "rglru_scan", "flash_attention")
    _build.build(*sources)
    print(f"built {' + '.join(f'{n}.cu' for n in sources)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in sources:
        for line in _build.build_log(name).splitlines():
            if "entry function" in line or "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(hopper_smem_line())

    t0 = time.perf_counter()
    cands = candidates(K_FULL, T_FULL)
    archive = DeviceArchive.stage(cands, device=DEVICE)
    archive.score_stats()
    torch.cuda.synchronize()
    print(f"archive K={K_FULL} T={T_FULL}: {archive.t3.nbytes / 1e6:.1f} MB "
          f"of T3 on the card, set up in {time.perf_counter() - t0:.2f} s")

    timings = kernel_phase(torch, cands, archive)
    launches, report = main_path(torch, cands)
    print("main path: " + json.dumps(report))
    print("serve profile: " + json.dumps(profile_serve(torch, cands)))
    del archive
    for precision in ("float32", "int8", "bfloat16"):
        t0 = time.perf_counter()
        ingest_launches, ingest = ingest_phase(torch, cands, precision)
        ingest["phase_s"] = time.perf_counter() - t0
        print(f"ingest {precision}: " + json.dumps(ingest))
        prof = ingest["profile"]
        print(f"ingest {precision}: {prof['kernels_per_poll']:.2f} kernels "
              f"and {prof['copies_per_poll']:.2f} copies a poll on the "
              f"device; B3 {ingest['b3']['ms']:.5f} ms a tick, timed as "
              + "; ".join(f"{k} x {v['launches']} ({v['recorded']:.2f} "
                          f"recorded)"
                          for k, v in ingest['b3']['kernels'].items()))
        if precision == "float32":
            launches["stats_update"] = ingest_launches["stats_update"]
            timings["stats_update"] = ingest["b3"]

    shard_launches, shard_kernels, shard = shard_phase(torch)
    print("shard phase: " + json.dumps(shard))
    print(f"shard phase: {shard['phase_s']:.1f} s (budget 120 s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in shard["seconds"].items()))
    timings["score_fuse"]["shard_phase"] = dict(
        launches={"phase0": shard_launches["score_fuse_phase0"],
                  "emit": shard_launches["score_fuse"]},
        phase0=shard_kernels["phase0"], emit=shard_kernels["emit"])
    timings["pool_scan"]["shard_phase"] = dict(
        launches=shard_launches["pool_scan"], **shard_kernels["pool_scan"])
    timings["stats_update"]["shard_phase"] = dict(
        launches=shard_launches["stats_update"])

    sim_launches, sim = sim_phase(torch)
    print("sim phase: " + json.dumps(sim))
    print(f"sim phase: {sim['phase_s']:.1f} s (budget {SIM_BUDGET_S:.0f} s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in sim["seconds"].items())
          + f"; {sim['collect_s_per_cycle']:.4f} s a cycle, "
          f"{sim['queries']} queries, {sim['accounts_holding']} of "
          f"{sim['accounts']} accounts holding scenarios")
    print("sim phase, simulator outcomes (not card numbers), availability % "
          "and $/h for 24 nodes: " + "; ".join(
              f"{k} {v['availability']:.1f} / {v['hourly_cost']:.3f}"
              for k, v in sim["baselines"]["outcomes"].items()))
    print("sim phase load harness on the card (ms): " + "; ".join(
        f"{s['name']} p50 {s['latency']['p50_ms']:.2f} p99 "
        f"{s['latency']['p99_ms']:.2f} p99.9 {s['latency']['p999_ms']:.2f}, "
        f"served {s['served']} shed {s['shed']} failed {s['errors']}"
        for s in sim["load"]["scenarios"]))
    for name, n in sim_launches.items():
        timings[name]["sim_phase"] = dict(
            launches=n, max_abs_err=sim["max_abs_err"][name])

    for arch in LM_ARCHS:
        t0 = time.perf_counter()
        lm_launches, lm_timings, lm = lm_phase(torch, arch)
        lm["phase_s"] = time.perf_counter() - t0
        print(f"{arch}: " + json.dumps({**lm, "kernel_times": lm_timings}))
        launches.update(lm_launches)
        timings.update(lm_timings)

    t0 = time.perf_counter()
    fwd_launches, fwd_timings, fwd = forward_phase(torch)
    fwd["phase_s"] = time.perf_counter() - t0
    print(f"{FWD_ARCH} forward: " + json.dumps({**fwd,
                                               "kernel_times": fwd_timings}))
    launches.update(fwd_launches)
    timings.update(fwd_timings)
    t0 = time.perf_counter()
    train = train_phase(torch, fwd["cross_entropy"])
    train["phase_s"] = time.perf_counter() - t0
    print(f"{FWD_ARCH} train: " + json.dumps(train))

    meta = {"score_fuse": ("cuda", "src/repro_torch/csrc/score_fuse.cu",
                           "src/repro/kernels/score_fuse.py:189"),
            "pool_scan": ("cuda", "src/repro_torch/csrc/pool_scan.cu",
                          "src/repro/kernels/pool_scan.py:155"),
            "stats_update": ("cuda", "src/repro_torch/csrc/stats_update.cu",
                             "src/repro/kernels/stats_update.py:203"),
            "moe_gmm": ("cuda", "src/repro_torch/csrc/moe_gmm.cu",
                        "src/repro/kernels/moe_gmm.py:23"),
            "moe_gmm_down": ("cuda", "src/repro_torch/csrc/moe_gmm.cu",
                             "src/repro/kernels/moe_gmm.py:78"),
            "rwkv6_scan": ("cuda", "src/repro_torch/csrc/rwkv6_scan.cu",
                           "src/repro/kernels/rwkv6_scan.py:22"),
            "rglru_scan": ("cuda", "src/repro_torch/csrc/rglru_scan.cu",
                           "src/repro/kernels/rglru_scan.py:19"),
            "flash_attention": ("cuda",
                                "src/repro_torch/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:26")}
    kernels = []
    for name, (route, source, replaces) in meta.items():
        t = {"library_ms": None, **timings[name]}
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **t})
    b7 = timings["moe_gmm"]["shapes"]
    b8 = timings["moe_gmm_down"]["shapes"]
    old = FIRST_VERSION_MS
    print("same-run ratios: B4/SDPA {:.3f}; B8/bmm prefill {:.3f}, decode "
          "{:.3f}; B7/bmm-products prefill {:.3f}, decode {:.3f}".format(
              timings["flash_attention"]["ratio_to_library"],
              b8["prefill"]["ratio_to_library"],
              b8["decode"]["ratio_to_library"],
              b7["prefill"]["ratio_to_products_bmm"],
              b7["decode"]["ratio_to_products_bmm"]))
    print("first version (PERF.md) -> this run, device ms: "
          "B5 {:.4f} -> {:.4f}; B7 prefill {:.4f} -> {:.4f}, decode {:.4f} "
          "-> {:.4f}".format(
              old["rwkv6_scan"], timings["rwkv6_scan"]["ms"],
              old["moe_gmm"]["prefill"], b7["prefill"]["ms"],
              old["moe_gmm"]["decode"], b7["decode"]["ms"]))
    b1 = timings["score_fuse"]
    print("previous version (PERF.md) -> this run, device ms: B1 {:.5f} -> "
          "{:.5f} ({}); B6 {:.5f} -> {:.5f}; B2 {:.5f} -> {:.5f}; B3 "
          "float32 {:.5f} -> {:.5f}".format(
              PREVIOUS_MS["score_fuse"], b1["ms"],
              ", ".join(f"{k} {v:.5f}" for k, v in b1["kernel_ms"].items()),
              PREVIOUS_MS["rglru_scan"], timings["rglru_scan"]["ms"],
              PREVIOUS_MS["pool_scan"], timings["pool_scan"]["ms"],
              PREVIOUS_MS["stats_update"], timings["stats_update"]["ms"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
