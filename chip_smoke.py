#!/usr/bin/env python3
"""Drive the PyTorch port's serving, live-ingest, K-sharded and quantized
archive paths, the paper's simulated-cloud pipeline (collector, ingestion,
admission, baselines, load harness), the closed-loop operator and the
region-sharded multi-vendor world with the paper's four-setup comparison,
spot-elastic training with checkpoints and the int8 gradient exchange, LM
serving (DeepSeek-V2-Lite,
RWKV6-7B, RecurrentGemma-2B), the encoder-decoder and vision-prefix
families (seamless-m4t-medium, llava-next-mistral-7b) served and run
forward, qwen2-0.5b's full-sequence forward and training step, and the
device mesh (the expert-parallel MoE layer, sharded restore and a step
with sharded accumulators on four ranks), and three launch cells held
against their roofline bounds, on one NVIDIA GPU.

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
5c. Operator phase (``operator_phase``): the closed loop of
   ``repro_torch.operator`` and the region-sharded world of
   ``repro_torch.multicloud`` on the card.  (c1) ``ChaosReplay`` on the sim
   phase's market and collector (K = 6400, no second collection: a
   float32 ring of 1008 primed with the 552 columns collected), requests
   48 vCPUs at W 0.5, 24 at W 0.8, 96 GiB at W 0.3 and 1536 vCPUs at W 0.5
   (24 nodes of 64): a no-fault control of 18 cycles, then a fresh replay
   of 36 cycles with reclaims at cycles 9, 18, 27 (8, 12, 6 nodes), a
   failing drain at 12, collector outages at 9, 10, 24 and a delayed tick
   at 18; ``benchmarks/operator_replay.py``'s gates (0 stranded tickets,
   the worker alive, 0 unresolved pools; the control's delivered within
   0.05 of recommended; the faulty run interrupted, reacting, stale, and
   failing exactly its failed drains' tickets).  (c2) ``ScenarioEngine``
   over the three vendors' full registries (38 regions, K = 10,920, 1092
   probes a cycle, int8 host ring of 1008), 288 cycles collected (two
   days: the one cut in depth); a region-sharded and a single ring primed
   on the card, 3 cycles each ending in ``poll()`` on both and 16 mixed
   requests served from both (pools and rows bit-identical between the
   rings, and against a CPU run); then ``replay_spotvista``'s loop on the
   federation: ``ChaosReplay`` with ``shard_bounds=region_bounds``, 24
   cycles, 1536 and 96 vCPUs at W 0.5, ``default_reclaims(24)``, the same
   gates.  Every serve of every replay is recorded with a snapshot of its
   archive and held against the CPU on its statistics as in phase 3 (F1
   ties counted), every ``score_archive`` row against the CPU's (RTOL
   1e-5, ATOL 1e-4); each replay and each parity request batch is one
   ``launch_segment`` (B1's phase 0 counted on the sharded ones: a phase 0
   and an emit a region shard), every B3 tick's inputs cloned at the call
   and replayed through the plain version.  Then the paper's four-setup
   comparison (``paper_comparison``): ``multicloud.compare_setup`` for
   single-region, multi-AZ, multi-region and multi-cloud at
   ``benchmarks/multiregion_compare.py``'s full size (period 30 min, 6
   types a region, window 12, warmup 16, 24 cycles, 96 vCPUs,
   ``default_reclaims(24)``, all four policies), SpotVista's replay on the
   card as one ``launch_segment`` with the O(K) pool scan (K = 6-36 is
   under the auto threshold), every serve and B3 tick held as above; the
   four results must equal the port's CPU run of the same setup (a
   difference only after a pool parted at a counted F1 tie), with
   SpotVista's availability at or above SpotFleet's and interruptions
   injected, and a line a setup prints each policy's availability and
   savings beside the abstract's gains (simulator outcomes, not gated).
   The phase fails if B1, B2 or B3 never launched.  Prints
   ``reconcile_once`` p50 / p90 on the host clock,
   re-recommendations, plans, launches, retirements, delivered and
   recommended availability (simulator outcomes), and its seconds against
   its 120 s budget.
5d. Analysis phase (``analysis_phase``, on the operator phase's world):
   the port's spotlint (``repro_torch.analysis``) over its default paths
   must report 0 findings.  Then live ingestion and threaded serving
   together under a fresh ``repro_torch.analysis.racecheck.LockRegistry``
   (the server, the admission queue and the pump instrumented before any
   thread starts): the ingest phase's feed over the K = 32768 catalog
   primes a float32 ring of 1008 with 504 columns, an ``IngestPump``
   (period 0) pumps 300 ticks (B3 once each, every call held bit for bit)
   while the admission worker serves 4 x 16 mixed requests from 4 client
   threads and one thread serves 3 x 16 directly on the current snapshot;
   0 race reports, 0 lock-order cycles, 0 pump errors, ticks pumped equal
   to the ring's appends and version advance, every B1 / B2 launch held
   (``launch_segment``) and every served pool against a CPU run on the
   snapshot its serve read (F1 ties counted).  Then the operator phase's
   faulty schedule cut to 13 cycles (K = 6400, its failing drain at 12
   included) with the server, the fault proxy, the queue and the CMDB
   instrumented: 0 reports, 0 cycles, the replay gates.  Last, each on a
   fresh registry, two negative controls that must fire: an off-lock
   ``ServeStats.requests`` write (exactly one report naming it) and two
   locks taken in opposite orders (exactly one cycle).  Prints the
   acquisition-order edges, the tickets' p50 / p90 and the phase's seconds
   against its 30 s budget.
5e. Elastic phase (``elastic_phase``, on the sim phase's market and
   collector, K = 6400): ``SpotElasticTrainer`` trains qwen2-0.5b at full
   width and depth (494 M parameters drawn on the card) on
   ``ElasticConfig()``'s 4 nodes of 64 vCPUs at W = 0.5 with the int8
   exchange, a checkpoint every 4 steps, batches of 8 x 512
   tokens from ``make_pipeline``, 10 market minutes a step: ``train(6)``,
   every node reclaimed, ``train(10)``, which re-provisions through the
   engine, restores step 4 and runs steps 4-9.  Every provisioning is one
   ``RecommendationEngine.recommend`` on the card (B2 at K = 6400); the
   whole run is one ``launch_segment`` (every B2 launch held bit for bit;
   the phase fails if B2 never launched) and each pool is held against a
   CPU ``recommend`` on the same candidates (F1 ties counted).  The
   events must hold checkpoint @ 4, an interruption, the re-provisioning
   and the rewind to 4 in that order; every save copies the state to the
   host and every restore must equal that copy bit for bit.  The first
   step's worker gradients of the embedding and the first layer go
   through the int8 exchange on the card and on the CPU: scales bit-equal,
   codes equal but at half-way ties, wire bytes equal.  Then
   ``launch.train.main`` on the reduced model with ``--ckpt-dir``: an
   uninterrupted 8-step run, a run killed at step 4 after its checkpoint
   and its ``--resume`` (restored state and losses bit-equal to the saved
   state and the uninterrupted run's).  Prints the
   phase's seconds against its 120 s budget, step p50 (its gradient,
   exchange and update parts) and tokens/s, a profiled node's gradient
   call, each checkpoint's bytes and seconds, peak memory, B2's launches and the
   exchange's wire bytes against the exact exchange's.
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
6b. Prefix phase (``prefix_phase``, one per entry of ``PREFIX_ARCHS``):
   ``seamless-m4t-medium`` (12 encoder + 12 decoder layers, d_model 1024,
   16 heads of 64, vocab 256206; 0.98 B parameters) and
   ``llava-next-mistral-7b`` (32 layers, d_model 4096, 32 query heads over
   8 KV heads of 128; 7.24 B) at full width and depth, seeded bf16 drawn
   on the card, ``use_pallas=True``; their frontends are stubs fed seeded
   embeddings, as in the reference.  Serving: 8 (seamless: 1536 frames
   each) or 4 (llava: 2880 patches each) prompts of 128 tokens through
   ``Model.prefill`` and 31 greedy ``decode_step``s; B4 must launch 0
   times (a cached prefill takes the plain attend), the cross cache the
   seamless prefill wrote must be unchanged bit for bit after the decode
   steps, greedy tokens are compared with the plain route
   (``use_pallas=False``, reported), and each layer's update (seamless:
   the encoder's and the decoder's) against the plain route's within
   ``LAYER_TOL`` at prefill and at a decode step.  Forward
   (``train=False``): seamless 4 x 1024 tokens over 1536 frames, llava
   ``make_pipeline(cfg, 4096, 2)``'s first batch (2880 patches + 1216
   tokens); B4 must launch once per decoder layer (12, 32) with the
   counter reset just before and read just after, and is held against its
   plain version on the first layer's captured q, k, v and a 77-row prefix
   of them (one bf16 ulp or ``FLASH_P_ULP`` * max|v|).  Within
   ``FWD_LAYER_TOL``: llava's layers against the plain route and float32;
   seamless's encoder layers against the plain route and each decoder
   layer's self-attention (where B4 runs) against the plain route's and
   float32 (the whole decoder layers are recorded: their cross-attention
   over 1536 frames amplifies rounding on either route).  Prints prefill
   ms, decode p50 / p90 and tokens/s, forward p50 / p90 over 3 calls, B4's
   device ms at the two shapes beside its bound and SDPA's, peak memory,
   and the phase's seconds against its 120 s budget.
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
8b. Mesh phase (``mesh_phase``): the device mesh of ``repro_torch`` run
   by four ranks (``torch.multiprocessing``, ``spawn``) that share
   ``cuda:0`` as a (2, 2) ``("data", "model")`` mesh over gloo (NCCL
   refuses two ranks on one card); the parent built every kernel and the
   ranks load the libraries.  Each rank: (a) every MoE layer of
   DeepSeek-V2-Lite (26, E = 64, top-6, D = 2048, expert F = 1408, 2
   shared experts) at full width through the expert-parallel path with
   ``use_pallas=True``, each layer drawn whole from its seed and sharded,
   on seeded bf16 hidden states of 16 x 128 tokens (the LM phase's
   prefill) and 16 x 1 (a decode batch): B7 and B8 once a layer, rank and
   batch (the counters set to 0 just before each call and read just
   after), each launch held against its plain version right after it (one
   bf16 ulp or 1e-3 * max; E_loc = 32, C = 120 at prefill, 8 at decode),
   y gathered over "data" within 2 bf16 ulps of max|y| of the one-device
   path run on each data shard (the same local capacity), aux within 1e-6
   of the shards' mean; (b) ``restore(shardings=)`` of a full-width
   qwen2-0.5b ``TrainState`` saved once (7.9 GB, in a temporary directory
   the phase removes) with ``param_shardings`` / ``opt_shardings``: every
   local shard of the spec's shape and bit-equal to its slice of the leaf
   restored whole; (c) one qwen2-0.5b step of 8 x 512 tokens,
   ``grad_accum=2``, plain route, ``grad_shardings = opt_shardings``, each
   rank its ``batch_pspec`` shard; rank 0 holds it against the one-device
   step with the same microbatches (``grad_accum = 4``): loss within 1e-6
   relative, its master shard within ``mesh_step_bound`` (float32
   reassociation of the accumulators and the norm), the gathered
   parameters within one bf16 ulp.  A failing rank fails the phase.
   Prints wall times only (the ranks time-slice the card), the phase's
   seconds against its 90 s budget, the launches a rank against the
   formula, the restore's seconds and bytes a rank, the accumulators'
   resident bytes a rank; then B7's and B8's device times alone at the EP
   shapes.
8c. Launch phase (``launch_phase``, 150 s budget for the cells, the
   wait for the host work apart): the launch cells of
   ``repro_torch.launch.cells`` built by ``build_cell`` on
   ``make_host_mesh()`` (one rank, NCCL on a ``HashStore``; the phase ends
   the group) and run through ``materialize_cell`` and the cell's step:
   (a) qwen2-0.5b ``train_4k`` cut to a global batch of 8 (S = 4096,
   ``pick_grad_accum``'s microbatches, plain route); (b)
   DeepSeek-V2-Lite ``prefill_32k`` cut to 1 x 8192 (at S = 32768 a call
   took 14.9 s, past the budget) and (c) ``decode_32k`` cut to a batch of
   16 (a 32768-deep cache, index 32767), both with ``use_pallas=True`` on
   one draw of the weights.  Per cell, one warm call, then timed calls
   (three training steps), finite outputs; on the host, in processes of
   their own started with the phase and finished before the first timed
   call (they run beside cell (a)'s arguments and warm call only),
   ``roofline_cell`` of the same cut cells (one rank's step traced on
   meta tensors) and their ``argument_bytes``.  Then: the arguments'
   bytes equal the dry-run's, and the allocator's requested bytes for
   them their unrounded sum (its allocated bytes at least the 512-byte
   rounded sum); no step faster than ``max(compute_s, memory_floor_s)``.
   (a): ``FlopCounterMode`` around the warm step (the step function on
   the timed step's arguments) counts exactly the meta trace's FLOPs.
   (b), (c): B7 and B8 launch 26 times each a step (the counters set to 0
   just before each timed call and read just after); on the warm call
   each launch is held against its plain version (one bf16 ulp or 1e-3 *
   max).  Beside the traces the entry points run on the host, each of which
   must exit 0: ``launch.dryrun`` (DeepSeek-V2-Lite ``decode_32k`` on the
   fake 16 x 16 group, on this host's torch: at most
   ``LAUNCH_DRYRUN_LIMIT_GIB`` a rank and not listed over the card, its
   peak and argument GiB printed with the torch version),
   ``launch.roofline`` (qwen2-0.5b ``train_4k``), then ``launch.report``.
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

import contextlib
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
# Operator phase: the closed loop (repro_torch.operator) on the sim phase's
# world, then the three-vendor world (repro_torch.multicloud) at full
# catalog width, sharded by region.  The schedules are
# benchmarks/operator_replay.py's menu at this length; its gates apply.
OP_BUDGET_S = 120.0
OP_PERIOD_MIN = 10.0
OP_CONTROL_CYCLES = 18
OP_FAULT_CYCLES = 36
OP_FAULTS = dict(reclaims={9: 8, 18: 12, 27: 6},
                 failing_drains=frozenset({12}),
                 collector_outages=frozenset({9, 10, 24}),
                 delayed_ticks=frozenset({18}))
# operator_replay.py: without faults, delivered >= recommended - this
NOFAULT_TOLERANCE = 0.05
# the three vendors' full registries: 38 regions, K = 10,920 pools; a tenth
# of the targets probed a cycle, as in the sim phase
MC_BUDGET = 1092
MC_WARMUP = 288              # two days primed of a ring of a week: the one cut
MC_PARITY_TICKS = 3
MC_CYCLES = 24
MC_REGIONS = ("us-east-1", "eu-west-1", "us-central1")   # aws rows take c5/m5
MC_REQUESTS = ((SIM_POOL_CPUS, 0.5), (96.0, 0.5))
# the paper's four-setup comparison at benchmarks/multiregion_compare.py's
# FULL size (its default_reclaims(24), all four policies); the replay's K
# (6-36) is under the pool scan's auto threshold, so the card run asks for
# the O(K) scan (B2) and its CPU twin keeps the default route
COMPARE_SIZE = dict(period_min=30.0, types_per_region=6, window=12,
                    warmup=16, cycles=24, amount=96.0)
# the abstract's SpotVista gains (availability %, savings %): against
# SpotVerse in a multi-region setup, and against AWS SpotFleet
PAPER_GAINS = {"spotverse": (81.28, 2.84), "spotfleet": (21.6, 26.3)}
# score_archive's availability rows against the CPU's (tests/_score_helpers)
ROW_RTOL, ROW_ATOL = 1e-5, 1e-4

# Analysis phase: the port's spotlint over its default paths, then live
# ingestion and threaded serving together at the main path's width under
# repro_torch.analysis.racecheck: a float32 ring of INGEST_WINDOW primed
# with INGEST_PRIME columns of the ingest phase's feed, an IngestPump
# (period 0) pumping ANALYSIS_TICKS ticks while the admission worker
# serves ANALYSIS_CLIENTS x B_FULL requests from as many client threads and
# one thread serves ANALYSIS_DIRECT batches directly; then the operator
# phase's faulty schedule, cut to ANALYSIS_CYCLES cycles (its failing drain
# at 12 included), instrumented; then the two negative controls.
ANALYSIS_BUDGET_S = 30.0
ANALYSIS_TICKS = 300
ANALYSIS_CLIENTS = 4
ANALYSIS_DIRECT = 3
ANALYSIS_CYCLES = 13

# Elastic phase: spot-elastic training (repro_torch.elastic) of qwen2-0.5b at
# full width and depth on the sim phase's market and catalog (K = 6400, no
# second collection), ElasticConfig()'s defaults (4 nodes of 64 vCPUs, W =
# 0.5, the int8 exchange) with a checkpoint every 4 steps;
# examples/train_elastic.py's full preset's batch and sequence.  train(6),
# every node reclaimed, train(10): re-provision, restore @ 4, steps 4-9.
ELASTIC_ARCH = "qwen2-0.5b"
ELASTIC_BUDGET_S = 120.0
ELASTIC_BATCH = 8
ELASTIC_SEQ = 512
ELASTIC_MINUTES = 10.0
ELASTIC_CKPT_EVERY = 4
ELASTIC_RUNS = (6, 10)
# the launcher's --ckpt-dir / --resume on the reduced model: a run killed at
# step 4 after its checkpoint, resumed; its losses must equal an
# uninterrupted run's bit for bit (the embedding's backward, an indexed
# accumulate, sorts its indices on CUDA and sums each row in a fixed order,
# so a step is deterministic; the losses of steps 0-3 and 4-7 differ by
# 0.5% at most, which a tolerance would not tell from a wrong resume)
LAUNCHER_STEPS = 8
LAUNCHER_KILL_AT = 4

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

# prefix phase: the encoder-decoder (audio) and vision-prefix families at
# their published widths and depths, their frontends stubs fed seeded
# embeddings (1536 frames, 2880 patches); served (prefill + LM_NEW - 1
# decode steps of LM_PROMPT-token prompts) and run forward
PREFIX_ARCHS = ("seamless-m4t-medium", "llava-next-mistral-7b")
PREFIX_SERVE_BATCH = {"seamless-m4t-medium": 8, "llava-next-mistral-7b": 4}
# forward (batch, positions): seamless 1024 text tokens over its frames,
# llava make_pipeline's 4096 positions (2880 patches + 1216 tokens)
PREFIX_FWD = {"seamless-m4t-medium": (4, 1024), "llava-next-mistral-7b": (2, 4096)}
PREFIX_FWD_CALLS = 3
PREFIX_BUDGET_S = 120.0
# B4's plain version takes ~0.1 s a call at llava's shape: timed over fewer
PREFIX_PLAIN_REPS = 5

# registry phase: the four registry architectures no other phase runs, at
# their published widths, served (LM_BATCH x LM_PROMPT prompts, LM_NEW
# tokens) and run forward; weights drawn on the card from LM_SEED
REGISTRY_ARCHS = ("qwen3-32b", "llama4-scout-17b-a16e", "qwen1.5-4b",
                  "qwen1.5-0.5b")
# depth cuts: llama4-scout's 48 layers are 107.8 B parameters (215.6 GB of
# bf16); 12 of them (28.49 B, 57.0 GB) fit the card beside the forward's
# float32 layer.  The others run at full depth.
REGISTRY_DEPTH = {"llama4-scout-17b-a16e": 12}
# forward (batch, positions): llama4 one 4096-token sequence, the qwen1.5
# pair 4 and 8; qwen3-32b cut to one of 2048 (REGISTRY_CUTS)
REGISTRY_FWD = {"qwen3-32b": (1, 2048), "llama4-scout-17b-a16e": (1, 4096),
                "qwen1.5-4b": (4, 4096), "qwen1.5-0.5b": (8, 4096)}
# cuts other than depth, printed on the architecture's line: qwen3-32b's
# forward over 4096 positions peaks at 81.1 GB of the card's 85.0 (65.5 GB
# of weights, the plain route's float32 scores in the layer gate) when it
# runs alone, and after the earlier phases the allocator's fragments left
# no room for its 4 GiB score tensor
REGISTRY_CUTS = {"qwen3-32b": "forward 1 x 2048 of 1 x 4096"}
REGISTRY_FWD_CALLS = 3
REGISTRY_BUDGET_S = 150.0          # an architecture's seconds
# A forward layer's update through B4 against the plain route and a float32
# layer.  qwen3-32b's q / k norms bound its scores (about N(0, 1)): its
# softmax is soft, and a layer holds to LAYER_TOL.  The other three keep the
# random init's nearly hard max (their scores spread by ~128 to ~290, from
# the init's fan-in over heads; see FWD_LAYER_TOL), and are held as
# qwen2-0.5b is.  Measured by this phase on an NVIDIA H100 80GB HBM3 (700
# W), the worst layer: qwen3-32b 0.0179 from float32 on both routes alike
# (B4 and the plain route 0.0059 apart: the layer's own bf16 roundings);
# llama4 0.0896 (its plain route 0.113 from float32), qwen1.5-4b 0.0679,
# qwen1.5-0.5b 0.0454.
REGISTRY_FWD_LAYER_TOL = {"qwen3-32b": LAYER_TOL,
                          "llama4-scout-17b-a16e": FWD_LAYER_TOL,
                          "qwen1.5-4b": FWD_LAYER_TOL,
                          "qwen1.5-0.5b": FWD_LAYER_TOL}
# bytes that may stay allocated on the card when the phase starts (what
# earlier phases left behind)
REGISTRY_START_BYTES = 1 << 30

# H100 SXM published peaks (NVIDIA data sheet), from the port's hardware
# model: HBM3 bandwidth, float32 rate outside the tensor cores, dense bf16
# and tf32 tensor-core rates.  Without the repo beside this script the
# import fails and the script stops there, printing no result.
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.launch import hw as _hw  # noqa: E402
HBM_BYTES_PER_S = _hw.HBM_BW
FP32_OPS_PER_S = _hw.PEAK_FLOPS_FP32
BF16_OPS_PER_S = _hw.PEAK_FLOPS_BF16
TF32_OPS_PER_S = _hw.PEAK_FLOPS_TF32

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


def profiled(fn, calls: int, tries: int = 6) -> dict:
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
            matched: dict | None = None, reps: int = TIME_REPS):
    """Median per-call CUDA-event time, and the per-call device time of the
    kernels whose names contain one of ``names`` (all kernels if ``None``)
    from a ``torch.profiler`` trace; the latter is ``None`` if the profiler
    records no device time.  ``per_name``, if given, receives each of
    ``names``' own per-call device time; ``matched`` the full name of every
    device item counted, with its launches and device ms a call and the
    share of its launches the trace recorded (``profiled``).  ``reps``
    calls are timed each way."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    call_ms = float(np.median([a.elapsed_time(b) for a, b in pairs]))
    prof_ms = None
    try:
        items = profiled(fn, reps)
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
    archive's statistics (scored from them at any K, the card server's
    pool scan): score rows must be bit-identical, and pools identical
    except where ``prefix_sum_tie`` flags a tie (counted)."""
    from repro_torch import convert
    from repro_torch.core import pool as pool_lib
    from repro_torch.core.config import EngineConfig
    from repro_torch.core.types import RequestBatch
    from repro_torch.kernels import pool_scan as ps
    from repro_torch.serve import BatchServer

    cpu_archive = convert.archive_from_numpy(cands, host_stats(archive),
                                             device="cpu", key="cpu")
    cpu_server = BatchServer(device="cpu", bucket_sizes=BUCKETS,
                             config=EngineConfig(
                                 pool_impl=server.engine.pool_impl,
                                 score_impl="tiled"))
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
    keyword args) in ``into`` and pass it through; calls may come from any
    thread (the admission worker's drains), so ``into`` grows under a
    lock."""

    def __init__(self, module, name: str, into: list):
        import threading
        self.module, self.name, self.into = module, name, into
        self.lock = threading.Lock()

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def wrapper(*args, **kw):
            with self.lock:
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


def launch_segment(torch, label: str, fn, *, sharded: bool = False):
    """``fn()`` with B1's and B2's launch counters set to 0 just before and
    read just after, every call captured; then each captured launch held
    against its plain version bit for bit (those checks' own launches are
    not counted).  ``sharded``: B1's phase-0 entry is counted and captured
    too, and every emit must have run on given (merged) scalars.  Returns
    ``(fn's result, launches, max abs errors)``."""
    from contextlib import nullcontext

    from repro_torch.core import pool as pool_lib
    from repro_torch.kernels import pool_scan as ps
    from repro_torch.kernels import score_fuse as sf
    captured = {"emit": [], "pool_scan": [], "phase0": []}
    sf.score_fuse_batch.launches = ps.pool_scan.launches = 0
    sf.score_fuse_phase0.launches = 0
    with capture(sf, "score_fuse_batch", captured["emit"]), \
            capture(pool_lib, "pool_scan", captured["pool_scan"]), \
            (capture(sf, "score_fuse_phase0", captured["phase0"])
             if sharded else nullcontext()):
        out = fn()
    launches = {"score_fuse": sf.score_fuse_batch.launches,
                "pool_scan": ps.pool_scan.launches}
    calls = {"score_fuse": len(captured["emit"]),
             "pool_scan": len(captured["pool_scan"])}
    if sharded:
        launches["score_fuse_phase0"] = sf.score_fuse_phase0.launches
        calls["score_fuse_phase0"] = len(captured["phase0"])
    if launches != calls:
        fail(f"{label}: launches {launches} against calls {calls}")
    err = hold_launches(torch, captured, label, given_scalars=sharded)
    errs = {"score_fuse": err["emit"], "pool_scan": err["pool_scan"]}
    if sharded:
        errs["score_fuse_phase0"] = err["phase0"]
    return out, launches, errs


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
    for bit.  Returns the counters, the report and the world (the market
    and the collector after their cycles), which the operator phase goes
    on with."""
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
    return launches, report, (market, col)


class held_ticks:
    """Within the block (it may be entered again), every B3 call
    (``kernels.stats_update.stats_update``) has its inputs cloned at the
    call, since the ring slot it reads as ``y_old`` is overwritten after
    it, and its outputs kept; :meth:`check` replays each through the plain
    version bit for bit.  ``launches`` counts the kernel's launches inside
    the block."""

    def __init__(self, torch):
        import threading
        from repro_torch.kernels import stats_update as su
        self.torch, self.su, self.calls, self.launches = torch, su, [], 0
        self.lock = threading.Lock()

    def __enter__(self):
        torch, real = self.torch, self.su.stats_update
        clone = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731

        def wrapper(moments, *args, **kw):
            kept = (type(moments)(*(clone(m) for m in moments)),
                    *(clone(a) for a in args))
            kept_kw = {k: clone(v) for k, v in kw.items()}
            out = real(moments, *args, **kw)
            with self.lock:
                self.calls.append((kept, kept_kw, out))
            return out
        # the kernel's wrapper counts through its module's name: see capture
        wrapper.launches = 0
        self.real, self.wrapper = real, wrapper
        self.su.stats_update = wrapper
        return self

    def __exit__(self, *exc):
        self.su.stats_update = self.real
        self.real.launches += self.wrapper.launches
        self.launches += self.wrapper.launches

    def check(self, label: str) -> float:
        err = 0.0
        for args, kw, (moments, stats) in self.calls:
            want_m, want_s = self.su.stats_update(*args, **kw,
                                                  backend="torch")
            for a, b in zip((*moments, *stats), (*want_m, *want_s)):
                if not same_bits(a, b):
                    fail(f"{label}: B3 differs from its plain version")
                err = max(err, float((a - b).abs().nan_to_num(0.0).max()))
        return err


class watched_replay:
    """A ``ChaosReplay`` whose server records every serve (a snapshot of
    the archive it read, the requests, the pools), whose engine records
    every ``score_archive`` (a snapshot and the rows), whose ``result_sink``
    counts what it hands the operator, and whose ``reconcile_once`` is
    timed on the host clock.  Serves come from the operator and from the
    admission worker, so the lists grow under a lock."""

    def __init__(self, replay):
        import threading
        self.replay, self.lock = replay, threading.Lock()
        self.served, self.rows, self.reconcile_s, self.sunk = [], [], [], 0
        server, engine, op = replay.server, replay.server.engine, \
            replay.operator
        real_serve, real_score = server.serve, engine.score_archive
        real_sink, real_reconcile = server.result_sink, op.reconcile_once
        pin = lambda a: a.snapshot() if hasattr(a, "snapshot") else a  # noqa: E731

        def serve(target, requests, **kw):
            recs = real_serve(target, requests, **kw)
            with self.lock:
                self.served.append((pin(target), list(requests), recs))
            return recs

        def score_archive(archive, **kw):
            out = real_score(archive, **kw)
            with self.lock:
                self.rows.append((pin(archive), out))
            return out

        def sink(request, rec):
            with self.lock:
                self.sunk += 1
            real_sink(request, rec)

        def reconcile_once():
            t0 = time.perf_counter()
            out = real_reconcile()
            self.reconcile_s.append(time.perf_counter() - t0)
            return out
        server.serve, engine.score_archive = serve, score_archive
        server.result_sink, op.reconcile_once = sink, reconcile_once
        self.real_sink = real_sink

    def unwatch(self) -> None:
        server = self.replay.server
        del server.serve, server.engine.score_archive
        del self.replay.operator.reconcile_once
        server.result_sink = self.real_sink

    def hold(self, torch, label: str) -> dict:
        """Every served pool against the CPU on its snapshot's statistics
        (``compare_with_cpu``: F1 ties counted), and every
        ``score_archive`` row against the CPU's on the same statistics."""
        from repro_torch import convert
        from repro_torch.core.engine import RecommendationEngine
        self.unwatch()
        recs = sum(len(r) for _, _, r in self.served)
        if self.sunk != recs:
            fail(f"{label}: result_sink saw {self.sunk} recommendations, "
                 f"the server served {recs}")
        ties = mismatched = 0
        for snap, reqs, got in self.served:
            check_pools(snap.host, [reqs], [got], label)
            cmp = compare_with_cpu(torch, self.replay.server, snap, snap.host,
                                   [reqs], [got], label)
            ties += cmp["ties"]
            mismatched += cmp["tie_mismatches"]
        cpu = RecommendationEngine(device="cpu")
        row_err, not_bit_equal = 0.0, 0
        for snap, rows in self.rows:
            want = cpu.score_archive(convert.archive_from_numpy(
                snap.host, host_stats(snap), device="cpu", key="cpu"))
            if not np.allclose(rows[1], want[1], rtol=ROW_RTOL,
                               atol=ROW_ATOL):
                fail(f"{label}: score_archive's availability row is off "
                     f"the CPU's")
            row_err = max(row_err, float(np.abs(rows[1] - want[1]).max()))
            not_bit_equal += not all(same_bits(a, b)
                                     for a, b in zip(rows, want))
        ms = np.array(self.reconcile_s) * 1e3
        return dict(serve_calls=len(self.served), recommendations=recs,
                    ties=ties, tie_mismatches=mismatched,
                    score_rows=len(self.rows),
                    score_row_max_abs_err=row_err,
                    score_rows_not_bit_equal=not_bit_equal,
                    reconcile_ms={"p50": float(np.percentile(ms, 50)),
                                  "p90": float(np.percentile(ms, 90)),
                                  "max": float(ms.max())})


def replay_gates(label: str, r, *, control: bool = False,
                 outages: bool = False, slack: bool = False,
                 react: bool = True) -> None:
    """``benchmarks/operator_replay.py``'s hard gates on one report.
    ``slack``: the operator must have reacted only if a pool ever fell
    short of its target (a delivered sample under 1), for a schedule whose
    reclaims a pool's surplus nodes may absorb.  ``react=False`` drops the
    reaction gate, for a schedule cut to end before the operator may
    react (the full schedule holds it in the operator phase)."""
    fails = []
    if r.stranded_tickets:
        fails.append(f"{r.stranded_tickets} stranded tickets")
    if not r.worker_alive_at_end:
        fails.append("the admission worker died")
    if r.unresolved_pools:
        fails.append(f"{r.unresolved_pools} unresolved pools")
    if control and r.delivery_gap > NOFAULT_TOLERANCE:
        fails.append(f"delivered {r.delivered_availability} below recommended "
                     f"{r.recommended_availability} - {NOFAULT_TOLERANCE}")
    if not control:
        if r.interruptions < 1:
            fails.append("the schedule interrupted nothing")
        if (react and r.rerecommendations + r.migrations_planned < 1
                and not (slack and r.delivered_availability == 1.0)):
            fails.append("the operator never reacted")
    if outages:
        if r.stale_cycles < 1 or r.ingest_failures < 1:
            fails.append(f"the outage never went stale ({r.stale_cycles} "
                         f"stale cycles, {r.ingest_failures} failures)")
        if not r.failed_tickets == r.failed_drains >= 1:
            fails.append(f"{r.failed_tickets} failed tickets against "
                         f"{r.failed_drains} failed drains")
    if fails:
        fail(f"{label}: " + "; ".join(fails))


def op_replay(torch, label: str, cycles: int, schedule, requests, add,
              before_run=None, **world) -> tuple:
    """One ``ChaosReplay`` on the card over an injected world (no second
    collection: the ring is primed with what the collector holds), run as
    one serving segment (``add``), every B3 tick held, every served pool
    and ``score_archive`` row against the CPU.  ``before_run(replay)`` is
    called once the replay is built, before any of its threads start."""
    from repro_torch.operator import ChaosReplay
    t0 = time.perf_counter()
    primed = world["collector"].ticks
    replay = ChaosReplay(**world, device=DEVICE, warmup_cycles=0,
                         window=INGEST_WINDOW, cycles=cycles,
                         period_min=OP_PERIOD_MIN, requests=requests,
                         schedule=schedule)
    torch.cuda.synchronize()
    prime_s = time.perf_counter() - t0
    if before_run is not None:
        before_run(replay)
    watch, ticks = watched_replay(replay), held_ticks(torch)
    t0 = time.perf_counter()
    with ticks:
        report, launches = add(label, lambda: replay.run(label),
                               sharded=world.get("shard_bounds") is not None)
    run_s = time.perf_counter() - t0
    held = watch.hold(torch, label)
    b3_err = ticks.check(label)
    if ticks.launches != len(ticks.calls):
        fail(f"{label}: B3 launched {ticks.launches} times in "
             f"{len(ticks.calls)} calls")
    pools = [dict(amount=p.amount, alive_capacity=p.alive_capacity,
                  alive_nodes=len(p.alive_members),
                  types=len(p.alive_by_key()),
                  interrupted=p.interrupted_total)
             for p in replay.operator.cmdb.active_pools]
    return report, launches, dict(
        K=len(replay.ingestor.archive), primed_columns=primed, pools=pools,
        prime_s=prime_s, run_s=run_s, launches=launches,
        b3_launches=ticks.launches,
        b3_max_abs_err=b3_err, **held,
        report={**vars(report), "delivery_gap": report.delivery_gap})


def multicloud_world():
    """The three vendors' full registries (38 regions, every type and AZ:
    K = 10,920), a tenth of the targets probed a cycle, an int8 host ring
    of a week."""
    from repro_torch.multicloud import ScenarioConfig, ScenarioEngine
    return ScenarioEngine(ScenarioConfig(
        vendors=("aws", "azure", "gcp"), regions_per_vendor=None,
        types_per_region=None, azs_per_region=None, period_min=OP_PERIOD_MIN,
        ring_capacity=INGEST_WINDOW, ring_dtype="int8",
        budget_per_cycle=MC_BUDGET, seed=0))


def multicloud_parity(torch, eng, add) -> dict:
    """``benchmarks/multiregion_compare.py``'s parity gate on the card: a
    region-sharded and a single ring primed from the same collector; each
    of ``MC_PARITY_TICKS`` cycles ends in ``poll()`` on both (B3 once a
    shard and once, every tick held), then 16 mixed requests through
    ``BatchServer.serve`` on both: pools and score rows bit-identical
    between the rings, and against the CPU on the sharded snapshot's
    statistics (F1 ties counted)."""
    from repro_torch.serve import BatchServer
    t0 = time.perf_counter()
    server = BatchServer(device=DEVICE, bucket_sizes=BUCKETS)
    sharded = eng.build_ingestor(window=INGEST_WINDOW, sharded=True,
                                 device=DEVICE)
    single = eng.build_ingestor(window=INGEST_WINDOW, sharded=False,
                                name="multicloud-single", device=DEVICE)
    sharded.prime()
    single.prime()
    torch.cuda.synchronize()
    prime_s = time.perf_counter() - t0
    n_shards = sharded.archive.n_shards
    ticks = held_ticks(torch)
    rng = np.random.default_rng(27)
    ties = mismatched = 0
    for tick in range(1, MC_PARITY_TICKS + 1):
        eng.warmup(1)
        with ticks:
            if sharded.poll() != 1 or single.poll() != 1:
                fail("multicloud parity: a poll absorbed no single tick")
        reqs = mixed_requests(rng, B_FULL, regions=MC_REGIONS)
        label = f"multicloud parity tick {tick}"
        got, n = add(f"{label} sharded", lambda: server.serve(
            sharded.archive, reqs), sharded=True)
        if not n["score_fuse_phase0"] == n["score_fuse"] == n_shards:
            fail(f"{label}: B1 launched {n} on {n_shards} region shards")
        want, _ = add(f"{label} single", lambda: server.serve(
            single.archive, reqs))
        same_pools(got, want, label)
        for a, b in zip(got, want):
            if not (same_bits(a.availability, b.availability)
                    and same_bits(a.cost, b.cost)):
                fail(f"{label}: score rows differ between the rings")
        snap = sharded.archive.snapshot()
        check_pools(snap.host, [reqs], [got], label)
        cmp = compare_with_cpu(torch, server, snap, snap.host, [reqs], [got],
                               label)
        ties += cmp["ties"]
        mismatched += cmp["tie_mismatches"]
    if ticks.launches != MC_PARITY_TICKS * (n_shards + 1):
        fail(f"multicloud parity: B3 launched {ticks.launches} times over "
             f"{MC_PARITY_TICKS} ticks of {n_shards} shards and one ring")
    return dict(shards=n_shards, prime_s=prime_s, ticks=MC_PARITY_TICKS,
                requests=MC_PARITY_TICKS * B_FULL, b3_launches=ticks.launches,
                b3_max_abs_err=ticks.check("multicloud parity"), ties=ties,
                tie_mismatches=mismatched,
                b1_vec_shards=shard_vec_paths(torch, sharded.archive))


def shard_vec_paths(torch, archive) -> int:
    """On how many region shards B1 takes its 16-byte path: each shard's
    statistics and catalog slice are tensors of their own, so the path
    turns on the shard's length alone (a multiple of 4)."""
    from repro_torch.kernels import score_fuse as sf
    return sum(sf.vec_ok(len(s), (torch.stack(tuple(s.score_stats())),
                                  s.prices, s.vcpus, s.memory_gb), ())
               for s in archive.shards)


def paper_comparison(torch, add) -> tuple:
    """``compare_setup`` for each of the four setups on the card (B1's
    phase 0 and emit, B2, B3 on SpotVista's replay; the baselines are
    host numpy), then on the CPU at the default engine route: the four
    results must be equal, or differ only after a pool that parted at a
    counted F1 tie.  Every serve and ``score_archive`` row of the replay
    is held against the CPU (``watched_replay``), every B3 tick against
    its plain version; ``multiregion_compare.py``'s availability gates
    hold in each setup.  Returns (the report, B3's launches, its max abs
    error)."""
    from repro_torch.core.config import EngineConfig
    from repro_torch.multicloud import compare as cmp

    real = cmp.ChaosReplay

    class Watched(real):
        def run(self, label):
            watches.append(watched_replay(self))
            return super().run(label)

    runs, b3_launches, b3_err = {}, 0, 0.0
    for setup in cmp.SETUPS:
        label, watches, ticks = f"compare {setup}", [], held_ticks(torch)
        t0 = time.perf_counter()
        cmp.ChaosReplay = Watched
        try:
            with ticks:
                card, n = add(label, lambda: cmp.compare_setup(
                    setup, device=DEVICE,
                    engine_config=EngineConfig(pool_impl="tiled"),
                    **COMPARE_SIZE), sharded=True)
        finally:
            cmp.ChaosReplay = real
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = cmp.compare_setup(setup, device="cpu", **COMPARE_SIZE)
        cpu_s = time.perf_counter() - t0
        if len(watches) != 1:
            fail(f"{label}: {len(watches)} SpotVista replays, not one")
        held = watches[0].hold(torch, label)
        b3_err = max(b3_err, ticks.check(label))
        b3_launches += ticks.launches
        n = dict(n, stats_update=ticks.launches)
        if 0 in n.values() or n["score_fuse"] != n["score_fuse_phase0"]:
            fail(f"{label}: launches {n}, not a phase 0 and an emit a "
                 "region shard, B2 and B3 each at least once")
        card = {p: r.to_dict() for p, r in card.items()}
        cpu = {p: r.to_dict() for p, r in cpu.items()}
        differ = sorted(f"{p}.{k}" for p in card for k in card[p]
                        if card[p][k] != cpu[p][k])
        if differ and not (held["tie_mismatches"] and all(
                d.startswith("spotvista.") for d in differ)):
            fail(f"{label}: {differ} differ from the CPU run with "
                 f"{held['tie_mismatches']} pools parted at an F1 tie")
        sv, sf = card["spotvista"], card["spotfleet"]
        if sv["interruptions"] == 0:
            fail(f"{label}: the reclaim schedule injected nothing")
        if sv["availability"] < sf["availability"]:
            fail(f"{label}: spotvista availability {sv['availability']} "
                 f"below spotfleet's {sf['availability']}")
        gains = {p: dict(
            availability_pct=100.0 * (sv["availability"]
                                      / card[p]["availability"] - 1.0),
            savings_pp=sv["savings_pct"] - card[p]["savings_pct"])
            for p in PAPER_GAINS}
        runs[setup] = dict(card_s=card_s, cpu_s=cpu_s, launches=n,
                           results=card, fields_differing=differ,
                           gains=gains, held=held)
    return dict(size=COMPARE_SIZE, paper=PAPER_GAINS, runs=runs), \
        b3_launches, b3_err


def compare_lines(cp: dict, seconds: float, card: str) -> list[str]:
    """``paper_comparison``'s report as printed: a header, then a line a
    setup with each policy's availability and savings, SpotVista's gains
    beside the abstract's, the launches and the CPU comparison."""
    lines = [f"operator phase, the paper's comparison ({card}): "
             f"{seconds:.1f} s at {cp['size']}, default_reclaims(24); "
             "availability / savings % are simulator outcomes, not card "
             "numbers"]
    for setup, r in cp["runs"].items():
        res, g, n = r["results"], r["gains"], r["launches"]
        lines.append(
            f"compare {setup}: card {r['card_s']:.2f} s, CPU "
            f"{r['cpu_s']:.2f} s; " + "; ".join(
                f"{p} {v['availability']:.5f} / {v['savings_pct']:.2f}%"
                for p, v in res.items())
            + "; SpotVista against " + ", ".join(
                f"{p} availability {g[p]['availability_pct']:+.2f}%, "
                f"savings {g[p]['savings_pp']:+.2f} points (paper "
                f"{cp['paper'][p][0]}%, {cp['paper'][p][1]}%)" for p in g)
            + f"; B1 {n['score_fuse_phase0']} phase-0 + {n['score_fuse']} "
            f"emits, B2 {n['pool_scan']}, B3 {n['stats_update']}, each "
            f"held; {r['held']['ties']} F1 ties, "
            f"{r['held']['tie_mismatches']} pools parted at one, fields "
            f"differing from the CPU run: {r['fields_differing'] or 'none'}")
    return lines


def operator_phase(torch, market, col) -> tuple:
    """The closed loop and the region-sharded multi-vendor world on the
    card (see the module docstring).  B1's and B2's counters are set to 0
    before each serving segment and read after it (``launch_segment``),
    B3's around each replay's and each parity tick's polls; every launch is
    held bit for bit against its plain version."""
    from repro_torch.core.types import ResourceRequest
    from repro_torch.multicloud.compare import default_reclaims
    from repro_torch.operator import ChaosSchedule

    t_start = time.perf_counter()
    laps, t_lap = {}, [t_start]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    launches = {"score_fuse": 0, "score_fuse_phase0": 0, "pool_scan": 0,
                "stats_update": 0}
    err = dict.fromkeys(launches, 0.0)

    def add(label, fn, *, sharded=False):
        out, n, e = launch_segment(torch, label, fn, sharded=sharded)
        for k in n:
            launches[k] += n[k]
            err[k] = max(err[k], e[k])
        return out, n

    def b3(stats):
        launches["stats_update"] += stats["b3_launches"]
        err["stats_update"] = max(err["stats_update"],
                                  stats["b3_max_abs_err"])

    # (c1) the operator's closed loop on the sim phase's world, K = 6400
    reqs = [ResourceRequest(cpus=48.0, weight=0.5),
            ResourceRequest(cpus=24.0, weight=0.8),
            ResourceRequest(memory_gb=96.0, weight=0.3),
            ResourceRequest(cpus=SIM_POOL_CPUS, weight=0.5)]
    control, _, control_stats = op_replay(
        torch, "operator control", OP_CONTROL_CYCLES, ChaosSchedule(), reqs,
        add, market=market, collector=col)
    replay_gates("operator control", control, control=True)
    b3(control_stats)
    faulty, _, faulty_stats = op_replay(
        torch, "operator faults", OP_FAULT_CYCLES, ChaosSchedule(**OP_FAULTS),
        reqs, add, market=market, collector=col)
    replay_gates("operator faults", faulty, outages=True)
    b3(faulty_stats)
    lap("operator")

    # (c2) three vendors at full width, one ring shard a region
    eng = multicloud_world()
    lap("multicloud world")
    eng.warmup(MC_WARMUP)
    lap("multicloud warmup")
    bounds = eng.region_bounds
    parity = multicloud_parity(torch, eng, add)
    b3(parity)
    lap("multicloud parity")
    mc, n, mc_stats = op_replay(
        torch, "multicloud replay", MC_CYCLES,
        ChaosSchedule(reclaims=default_reclaims(MC_CYCLES)),
        [ResourceRequest(cpus=c, weight=w) for c, w in MC_REQUESTS], add,
        market=eng.federation, collector=eng.collector, shard_bounds=bounds)
    # at full width the 1536-vCPU pool spans tens of types and hundreds of
    # nodes, so the drumbeat (3 nodes every 5 cycles) may take only its
    # surplus: the operator then has nothing to react to
    replay_gates("multicloud replay", mc, slack=True)
    b3(mc_stats)
    if not (n["score_fuse_phase0"] == n["score_fuse"]
            and n["score_fuse"] % len(bounds) == 0):
        fail(f"multicloud replay: B1 launched {n}, not a phase-0 and an emit "
             f"for each of {len(bounds)} region shards")
    if mc_stats["b3_launches"] % len(bounds):
        fail(f"multicloud replay: B3 launched {mc_stats['b3_launches']} "
             f"times on {len(bounds)} shards")
    lap("multicloud replay")
    compare, n_b3, e_b3 = paper_comparison(torch, add)
    b3(dict(b3_launches=n_b3, b3_max_abs_err=e_b3))
    lap("compare")
    for name, k in launches.items():
        if k == 0:
            fail(f"operator phase: the path never launched kernel {name}")
    extents = [b - a for a, b in bounds]
    report = dict(
        operator=dict(K=control_stats["K"], control=control_stats,
                      faults=faulty_stats),
        multicloud=dict(
            K=eng.n_targets, regions=len(bounds),
            extents=dict(min=min(extents), max=max(extents)),
            offsets_not_16=sum(a % 16 != 0 for a, _ in bounds),
            warmup_cycles=MC_WARMUP, ring=INGEST_WINDOW,
            collected=eng.collector.ticks,
            missing_responses=eng.collector.missing_responses,
            parity=parity, replay=mc_stats),
        compare=compare, launches=launches, max_abs_err=err, seconds=laps,
        phase_s=time.perf_counter() - t_start)
    return launches, report


class recorded_serves:
    """Within the block, ``server.serve`` records every call (the pinned
    snapshot it read, the requests, the pools) under a lock: the admission
    worker and direct callers serve from their own threads."""

    def __init__(self, server):
        import threading
        self.server, self.lock, self.calls = server, threading.Lock(), []

    def __enter__(self):
        real = self.server.serve

        def serve(target, requests, **kw):
            recs = real(target, requests, **kw)
            with self.lock:
                self.calls.append((target, list(requests), recs))
            return recs
        self.server.serve = serve
        return self

    def __exit__(self, *exc):
        del self.server.serve


def lint_gate() -> dict:
    """``repro_torch.analysis`` over its default paths: 0 findings."""
    from repro_torch.analysis import DEFAULT_PATHS, run_paths
    t0 = time.perf_counter()
    findings, n_files = run_paths([ROOT / p for p in DEFAULT_PATHS])
    lint_s = time.perf_counter() - t0
    if findings:
        fail("spotlint: " + "; ".join(f.format() for f in findings[:10]))
    return dict(files=n_files, findings=0, s=lint_s)


def pumped_serving(torch, cands, add) -> dict:
    """Live ingestion and threaded serving at once under a fresh
    ``LockRegistry``: an ``IngestPump`` (period 0) pumps ``ANALYSIS_TICKS``
    ticks of the ingest phase's feed into a float32 ring of
    ``INGEST_WINDOW`` (B3 once a tick) while the admission worker serves
    ``ANALYSIS_CLIENTS`` x ``B_FULL`` requests from as many client threads
    and one thread serves ``ANALYSIS_DIRECT`` batches on the current
    snapshot.  The instrumentation is applied before any thread starts."""
    import threading

    from repro_torch.analysis.racecheck import (LockRegistry,
                                                instrument_admission_queue,
                                                instrument_pump,
                                                instrument_server)
    from repro_torch.core.config import EngineConfig
    from repro_torch.stream import AdmissionQueue, IngestPump

    label = "analysis serving"
    t0 = time.perf_counter()
    feed = SyntheticFeed(cands, seed=5, ticks=INGEST_PRIME)
    cfg = EngineConfig()
    server = cfg.build_server(device=DEVICE, bucket_sizes=BUCKETS)
    ing = cfg.build_ingestor(feed, window=INGEST_WINDOW, name="analysis",
                             device=DEVICE)
    arch = ing.prime()
    torch.cuda.synchronize()
    prime_s = time.perf_counter() - t0
    queue = AdmissionQueue(server, lambda: ing.archive, max_wait_s=MAX_WAIT_S)
    target = INGEST_PRIME + ANALYSIS_TICKS
    fed = threading.Event()

    def collect() -> None:
        if feed.ticks < target:
            feed.run(1)
        else:
            fed.set()

    pump = IngestPump(ing, collect, period=0.0)
    rng = np.random.default_rng(29)
    batches = [mixed_requests(rng, B_FULL)
               for _ in range(ANALYSIS_CLIENTS + ANALYSIS_DIRECT)]
    reg = LockRegistry()
    try:
        instrument_server(reg, server)
        instrument_admission_queue(reg, queue)
        instrument_pump(reg, pump)
        v0, a0 = arch.version, arch.appends
        errors, direct, latency = [], [], []

        def client(reqs) -> None:
            try:
                tickets = [queue.submit(r) for r in reqs]
                for t in tickets:
                    t.result(timeout=120.0)
            except Exception as err:  # noqa: BLE001 - raised below
                errors.append(err)

        def caller(calls) -> None:
            try:
                for reqs in calls:
                    direct.append(server.serve(ing.archive.snapshot(), reqs))
            except Exception as err:  # noqa: BLE001 - raised below
                errors.append(err)

        def run() -> None:
            queue.start()
            try:
                with pump:
                    threads = [threading.Thread(target=client, args=(b,))
                               for b in batches[:ANALYSIS_CLIENTS]]
                    threads.append(threading.Thread(
                        target=caller, args=(batches[ANALYSIS_CLIENTS:],)))
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join(120.0)
                    latency.extend(queue.stats.latency.quantile(q) * 1e3
                                   for q in (0.5, 0.9))
                    if not fed.wait(120.0):
                        fail(f"{label}: the pump fed {feed.ticks - INGEST_PRIME}"
                             f" of {ANALYSIS_TICKS} ticks in 120 s")
                    deadline = time.monotonic() + 60.0
                    while (pump.ticks_pumped < ANALYSIS_TICKS
                           and time.monotonic() < deadline):
                        time.sleep(0.001)
                    if any(t.is_alive() for t in threads):
                        fail(f"{label}: a serving thread did not finish")
            finally:
                queue.stop()
            torch.cuda.synchronize()

        ticks = held_ticks(torch)
        t0 = time.perf_counter()
        with recorded_serves(server) as rec, ticks:
            _, launches, err = add(label, run)
        run_s = time.perf_counter() - t0
        if errors:
            raise errors[0]
        reports, cycles, edges = reg.race_reports(), reg.cycles(), reg.edges()
    finally:
        reg.close()
    if reports or cycles:
        fail(f"{label}: " + "; ".join(
            [r.format() for r in reports]
            + ["lock-order cycle " + " -> ".join(c) for c in cycles]))
    if pump.errors:
        fail(f"{label}: the pump counted {pump.errors} errors: "
             f"{pump.last_error!r}")
    advanced = dict(ticks_pumped=pump.ticks_pumped,
                    appends=arch.appends - a0, versions=arch.version - v0)
    if set(advanced.values()) != {ANALYSIS_TICKS}:
        fail(f"{label}: pumped, appended and versions advanced differ: "
             f"{advanced} (want {ANALYSIS_TICKS} each)")
    b3_err = ticks.check(label)
    if not ticks.launches == len(ticks.calls) == ANALYSIS_TICKS:
        fail(f"{label}: B3 launched {ticks.launches} times in "
             f"{len(ticks.calls)} calls over {ANALYSIS_TICKS} ticks")
    n_requests = (ANALYSIS_CLIENTS + ANALYSIS_DIRECT) * B_FULL
    served = sum(len(r) for _, _, r in rec.calls)
    st = queue.stats
    if not (served == n_requests and st.submitted == st.served
            == ANALYSIS_CLIENTS * B_FULL and st.failed == 0
            and len(direct) == ANALYSIS_DIRECT):
        fail(f"{label}: served {served} of {n_requests} requests "
             f"(queue submitted {st.submitted}, served {st.served}, failed "
             f"{st.failed}; {len(direct)} direct calls)")
    ties = mismatched = 0
    for snap, reqs, recs in rec.calls:
        check_pools(snap.host, [reqs], [recs], f"{label} v{snap.version}")
        cmp = compare_with_cpu(torch, server, snap, snap.host, [reqs],
                               [recs], f"{label} v{snap.version}")
        ties += cmp["ties"]
        mismatched += cmp["tie_mismatches"]
    versions = [snap.version for snap, _, _ in rec.calls]
    return dict(
        K=len(arch), capacity=INGEST_WINDOW, prime_columns=INGEST_PRIME,
        prime_s=prime_s, run_s=run_s, **advanced, serve_calls=len(rec.calls),
        drains=st.drains, requests=n_requests,
        versions_served=dict(min=min(versions), max=max(versions),
                             distinct=len(set(versions)),
                             below_final=sum(v < arch.version
                                             for v in versions)),
        ticket_ms={"p50": latency[0], "p90": latency[1]},
        edges=[list(e) for e in edges], race_reports=0, cycles=0,
        launches={**launches, "stats_update": ticks.launches},
        max_abs_err={**err, "stats_update": b3_err}, ties=ties,
        tie_mismatches=mismatched)


def instrumented_replay(torch, market, col, add) -> dict:
    """The operator phase's faulty schedule, cut to ``ANALYSIS_CYCLES``
    cycles, with the server, the fault proxy, the admission queue and the
    CMDB instrumented under a fresh ``LockRegistry``."""
    from repro_torch.analysis.racecheck import (LockRegistry,
                                                instrument_admission_queue,
                                                instrument_cmdb,
                                                instrument_fault_server,
                                                instrument_server)
    from repro_torch.core.types import ResourceRequest
    from repro_torch.operator import ChaosSchedule

    label = "analysis replay"
    reg = LockRegistry()

    def instrument(replay) -> None:
        instrument_server(reg, replay.server)
        instrument_fault_server(reg, replay.faulty)
        instrument_admission_queue(reg, replay.queue)
        instrument_cmdb(reg, replay.operator.cmdb)

    reqs = [ResourceRequest(cpus=48.0, weight=0.5),
            ResourceRequest(cpus=24.0, weight=0.8),
            ResourceRequest(memory_gb=96.0, weight=0.3),
            ResourceRequest(cpus=SIM_POOL_CPUS, weight=0.5)]
    try:
        report, _, stats = op_replay(
            torch, label, ANALYSIS_CYCLES, ChaosSchedule(**OP_FAULTS), reqs,
            add, before_run=instrument, market=market, collector=col)
        reports, cycles, edges = reg.race_reports(), reg.cycles(), reg.edges()
    finally:
        reg.close()
    if reports or cycles:
        fail(f"{label}: " + "; ".join(
            [r.format() for r in reports]
            + ["lock-order cycle " + " -> ".join(c) for c in cycles]))
    # the cut ends three cycles after the first reclaim (cycle 9, inside
    # the collector's outage of cycles 9-10, when the operator holds its
    # pools), so it is not held to a reaction
    replay_gates(label, report, outages=True, react=False)
    return dict(cycles=ANALYSIS_CYCLES, K=stats["K"],
                rerecommendations=report.rerecommendations,
                migrations_planned=report.migrations_planned,
                failed_drains=report.failed_drains,
                failed_tickets=report.failed_tickets,
                stale_cycles=report.stale_cycles,
                interruptions=report.interruptions,
                edges=[list(e) for e in edges], race_reports=0,
                lock_cycles=0, serve_calls=stats["serve_calls"],
                ties=stats["ties"], tie_mismatches=stats["tie_mismatches"],
                b3_launches=stats["b3_launches"],
                b3_max_abs_err=stats["b3_max_abs_err"],
                launches=stats["launches"], run_s=stats["run_s"])


def negative_controls() -> dict:
    """Each on a fresh registry: an off-lock write of a guarded
    ``ServeStats`` counter of an instrumented server gives one report
    naming the field, and two locks taken in opposite orders by two
    threads, one after the other, give one cycle.  A sanitizer that
    reports nothing would otherwise pass the gates above vacuously."""
    import threading

    from repro_torch.analysis.racecheck import LockRegistry, instrument_server
    from repro_torch.serve import BatchServer
    reg = LockRegistry()
    try:
        server = BatchServer(device=DEVICE, bucket_sizes=BUCKETS)
        instrument_server(reg, server)

        def unguarded() -> None:
            server.stats.requests += 1
        t = threading.Thread(target=unguarded, name="unguarded-writer")
        t.start()
        t.join(10.0)
        reports = reg.race_reports()
    finally:
        reg.close()
    if not (len(reports) == 1 and reports[0].obj == "ServeStats"
            and reports[0].attr == "requests"
            and reports[0].thread == "unguarded-writer"):
        fail("negative control: an off-lock ServeStats.requests write gave "
             f"{[r.format() for r in reports]}, not one report naming it")
    reg = LockRegistry()
    a = reg.wrap(threading.Lock(), "control.a")
    b = reg.wrap(threading.Lock(), "control.b")

    def take(first, second) -> None:
        with first:
            with second:
                pass
    for pair in ((a, b), (b, a)):
        t = threading.Thread(target=take, args=pair)
        t.start()
        t.join(10.0)
    cycles = reg.cycles()
    if len(cycles) != 1 or reg.race_reports():
        fail(f"negative control: opposite lock orders gave cycles {cycles}, "
             "not one")
    return dict(report=reports[0].format(),
                cycle=" -> ".join(cycles[0]))


def analysis_phase(torch, cands, market, col) -> tuple:
    """The port's spotlint and race sanitizer on the card (see the module
    docstring): the lint gate, live ingestion and threaded serving at K =
    32768 under a ``LockRegistry``, the instrumented faulty replay at K =
    6400, and the negative controls.  B1's and B2's counters are set to 0
    before each serving segment and read after it (``launch_segment``),
    B3's around the pump's and the replay's ticks; every launch is held bit
    for bit against its plain version."""
    t_start = time.perf_counter()
    laps, t_lap = {}, [t_start]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    launches = {"score_fuse": 0, "pool_scan": 0, "stats_update": 0}
    err = dict.fromkeys(launches, 0.0)

    def add(label, fn, *, sharded=False):
        out, n, e = launch_segment(torch, label, fn, sharded=sharded)
        for k in n:
            launches[k] += n[k]
            err[k] = max(err[k], e[k])
        return out, n, e

    lint = lint_gate()
    lap("lint")
    serving = pumped_serving(torch, cands, add)
    launches["stats_update"] += serving["launches"]["stats_update"]
    err["stats_update"] = max(err["stats_update"],
                              serving["max_abs_err"]["stats_update"])
    lap("pumped serving")
    replay = instrumented_replay(torch, market, col,
                                 lambda *a, **k: add(*a, **k)[:2])
    launches["stats_update"] += replay["b3_launches"]
    err["stats_update"] = max(err["stats_update"], replay["b3_max_abs_err"])
    lap("instrumented replay")
    controls = negative_controls()
    lap("negative controls")
    for name, k in launches.items():
        if k == 0:
            fail(f"analysis phase: the path never launched kernel {name}")
    report = dict(lint=lint, serving=serving, replay=replay,
                  controls=controls, launches=launches, max_abs_err=err,
                  seconds=laps, phase_s=time.perf_counter() - t_start)
    return launches, report


class patched:
    """Within the block, ``owner.name`` is ``make(real)``."""

    def __init__(self, owner, name: str, make):
        self.owner, self.name, self.make = owner, name, make

    def __enter__(self):
        self.real = getattr(self.owner, self.name)
        setattr(self.owner, self.name, self.make(self.real))
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)


_INT_OF_SIZE = {1: "int8", 2: "int16", 4: "int32", 8: "int64"}


def leaves_bit_equal(torch, got, want) -> bool:
    """Two lists of tensors equal bit for bit (dtype, shape and bits), the
    comparison on ``got``'s device."""
    if len(got) != len(want):
        return False
    for a, b in zip(got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        view = getattr(torch, _INT_OF_SIZE[a.element_size()])
        if not torch.equal(a.view(view), b.to(a.device).view(view)):
            return False
    return True


class ckpt_watch:
    """Within the block, every ``ckpt.save`` and ``ckpt.restore`` is timed
    and its bytes on disk counted; each save copies the tree to the host
    first, and each restore is held bit for bit against the copy of the
    save it loads (the comparison is not timed)."""

    def __init__(self, torch, label: str):
        self.torch, self.label = torch, label
        self.saves, self.restores, self.copies = [], [], {}

    def __enter__(self):
        from repro_torch.ckpt import checkpoint as ck
        from repro_torch.train.optim import tree_flatten
        torch, real_save, real_restore = self.torch, ck.save, ck.restore
        self.ck, self.real = ck, (real_save, real_restore)

        def save(root, tree, step, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            copy = [x.detach().to("cpu", copy=True)
                    for x in tree_flatten(tree)[0]]
            t1 = time.perf_counter()
            final = real_save(root, tree, step, **kw)
            t2 = time.perf_counter()
            self.copies[(str(root), step)] = copy
            self.saves.append(dict(
                step=step, bytes=sum(f.stat().st_size
                                     for f in final.iterdir()),
                s=t2 - t1, host_copy_s=t1 - t0))
            return final

        def restore(root, like, **kw):
            t0 = time.perf_counter()
            tree, step = real_restore(root, like, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            d = Path(root) / f"step_{step:09d}"
            want = self.copies.get((str(root), step))
            if want is None:
                fail(f"{self.label}: restored step {step}, which no save of "
                     "this phase wrote")
            if not leaves_bit_equal(torch, tree_flatten(tree)[0], want):
                fail(f"{self.label}: the state restored at step {step} is "
                     "not the saved one bit for bit")
            self.restores.append(dict(
                step=step, bytes=sum(f.stat().st_size for f in d.iterdir()),
                s=t1 - t0, bit_equal=True))
            return tree, step

        ck.save, ck.restore = save, restore
        return self

    def __exit__(self, *exc):
        self.ck.save, self.ck.restore = self.real
        self.copies.clear()


def hold_provisions(torch, records, label: str) -> dict:
    """Each provisioning's pool (``recommend`` on the card) against a CPU
    ``RecommendationEngine.recommend`` on the same candidates: score rows
    within ``ROW_RTOL`` / ``ROW_ATOL`` (bit-equality counted), pools equal,
    or an F1 tie: the two score orders agree on every prefix either scan
    reached and ``prefix_sum_tie`` puts a decision within the two
    devices' prefix-sum difference (counted)."""
    from repro_torch.core import pool as pool_lib
    from repro_torch.core.engine import RecommendationEngine
    from repro_torch.core.scoring import f32
    from repro_torch.kernels import pool_scan as ps

    cpu = RecommendationEngine(device="cpu")
    ties = rows_not_bit_equal = 0
    row_err = 0.0
    for cands, sub, req, rec, rows in records:
        crec = cpu.recommend(cands, req)
        crows = cpu.score(sub, req)
        if not np.allclose(rows[0], crows[0], rtol=ROW_RTOL, atol=ROW_ATOL):
            fail(f"{label}: combined scores of {req} are off the CPU's")
        rows_not_bit_equal += not all(same_bits(a, b)
                                      for a, b in zip(rows, crows))
        row_err = max(row_err, float(np.abs(rows[0] - crows[0]).max()))
        if (list(rec.names) == list(crec.names)
                and list(rec.azs) == list(crec.azs)
                and list(rec.regions) == list(crec.regions)
                and np.array_equal(rec.counts, crec.counts)):
            continue
        caps = np.asarray(req.capacity_of(sub), np.float64)

        def scan(comb, dev):
            s_all = f32(comb, dev)
            order = torch.sort(-s_all, stable=True).indices
            s, c = s_all[order], f32(caps, dev)[order]
            _, k_stop, any_term = pool_lib._prefix_allocations(
                s, c, f32(req.amount, dev), impl="tiled")
            return (order.cpu().numpy(), s.cpu().numpy(), c.cpu().numpy(),
                    ps._clamped_prefix_sums(s).cpu().numpy(),
                    (int(k_stop), bool(any_term)))

        og, _, _, csg, rg = scan(rows[0], DEVICE)
        oc, sc, cc, csc, rc = scan(crows[0], "cpu")
        k_hi = max(k if found else len(oc) - 1 for k, found in (rg, rc))
        if not np.array_equal(og[:k_hi + 1], oc[:k_hi + 1]):
            fail(f"{label}: the card orders {req}'s candidates otherwise "
                 "than the CPU within the scanned prefix")
        tie, margin, budget = pool_lib.prefix_sum_tie(
            sc, cc, float(req.amount), csc, csg, [rg, rc])
        if not tie:
            fail(f"{label}: pool of {req} differs between card and CPU "
                 f"with margin {margin:.3g} > budget {budget:.3g}")
        ties += 1
    return dict(provisions=len(records), ties=ties,
                rows_not_bit_equal=rows_not_bit_equal,
                row_max_abs_err=row_err)


def exchange_slice(torch, grads):
    """The embedding's and the first layer's gradient leaves, cloned."""
    from repro_torch.models.param import tree_map
    return {"embed": grads["embed"].clone(),
            "layer0": tree_map(lambda x: x[0].clone(), grads["unit"])}


def hold_exchange(torch, worker_grads) -> dict:
    """The int8 exchange of the first step's worker gradients (the
    embedding and one layer) on the card against the CPU's: every scale
    bit-equal, every code equal except at a half-way tie (counted), the
    wire bytes equal, and the means bit-equal where no tie moved a code."""
    from repro_torch.models.param import tree_map
    from repro_torch.parallel import compression as comp
    from repro_torch.train.optim import tree_flatten

    def exchange(grads):
        """``allreduce_compressed`` with fresh feedback, every
        ``quantize`` it calls recorded: ``(mean, wire, [(g, q, s)])``."""
        seen = []

        def record(real):
            def wrapped(g, error=None):
                out = real(g, error)
                seen.append((g, *out[:2]))
                return out
            return wrapped
        with patched(comp, "quantize", record):
            mean, wire = comp.allreduce_compressed(
                grads, [comp.ErrorFeedback() for _ in grads])
        return mean, wire, seen

    host = [tree_map(lambda x: x.cpu(), g) for g in worker_grads]
    mean_dev, wire_dev, on_dev = exchange(worker_grads)
    mean_cpu, wire_cpu, on_cpu = exchange(host)
    ties = codes = 0
    for (_, qa, sa), (b, qb, sb) in zip(on_dev, on_cpu):
        if not leaves_bit_equal(torch, [sa.cpu()], [sb]):
            fail(f"elastic exchange: a scale differs, card {float(sa):.9g} "
                 f"CPU {float(sb):.9g}")
        diff = qa.cpu() != qb
        codes += qb.numel()
        if bool(diff.any()):
            r = b.float() / sb
            tie = (r - r.floor()).abs() == 0.5
            if bool((diff & ~tie).any()):
                fail("elastic exchange: an int8 code differs off a half-way "
                     "tie")
            ties += int(diff.sum())
    if len(on_dev) != len(on_cpu) or not codes:
        fail(f"elastic exchange: {len(on_dev)} quantised leaves on the "
             f"card, {len(on_cpu)} on the CPU")
    if wire_dev != wire_cpu:
        fail(f"elastic exchange: wire bytes {wire_dev} on the card, "
             f"{wire_cpu} on the CPU")
    got, want = tree_flatten(mean_dev)[0], tree_flatten(mean_cpu)[0]
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(got, want))
    if ties == 0 and not leaves_bit_equal(torch, [a.cpu() for a in got],
                                          want):
        fail(f"elastic exchange: the means differ by {err:.3g} with no tie")
    return dict(workers=len(worker_grads), codes=codes, ties=ties,
                wire_bytes=wire_dev, mean_max_abs_err=err)


class _Killed(Exception):
    """The launcher's run, cut at a step (a reclaimed machine)."""


def launcher_substep(torch, workdir: Path) -> dict:
    """``launch.train.main`` on the reduced model with ``--ckpt-dir``: an
    uninterrupted run, a run killed at step ``LAUNCHER_KILL_AT`` after
    that step's checkpoint, and its ``--resume`` in a fresh call, whose
    restored state must be the saved one (``ckpt_watch``) and whose losses
    must be the uninterrupted run's, bit for bit."""
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.launch import train as launcher

    def dies(real):
        def make(*args, **kw):
            pipe = real(*args, **kw)
            batch = pipe.batch

            def at(step):
                if step == LAUNCHER_KILL_AT:
                    raise _Killed
                return batch(step)
            pipe.batch = at
            return pipe
        return make

    argv = ["--arch", ELASTIC_ARCH, "--reduced", "--steps",
            str(LAUNCHER_STEPS), "--device", DEVICE]
    whole_dir, cut_dir = workdir / "whole", workdir / "cut"
    with ckpt_watch(torch, "launcher") as watch:
        whole = launcher.main(argv + ["--ckpt-dir", str(whole_dir)])
        with patched(launcher, "make_pipeline", dies):
            try:
                launcher.main(argv + ["--ckpt-dir", str(cut_dir)])
                fail("launcher: the cut run was not cut")
            except _Killed:
                pass
        if ck.latest_step(cut_dir) != LAUNCHER_KILL_AT:
            fail(f"launcher: the cut run's latest checkpoint is "
                 f"{ck.latest_step(cut_dir)}, not {LAUNCHER_KILL_AT}")
        resumed = launcher.main(argv + ["--ckpt-dir", str(cut_dir),
                                        "--resume"])
    if [r["step"] for r in watch.restores] != [LAUNCHER_KILL_AT]:
        fail(f"launcher: restores {watch.restores}")
    tail = whole[LAUNCHER_KILL_AT:]
    if len(resumed) != len(tail) or not np.isfinite(resumed).all():
        fail(f"launcher: resumed losses {resumed} against {tail}")
    if list(resumed) != list(tail):
        fail(f"launcher: resumed losses {resumed} are not the "
             f"uninterrupted run's {tail} bit for bit")
    return dict(steps=LAUNCHER_STEPS, killed_at=LAUNCHER_KILL_AT,
                whole=whole, resumed=resumed, bit_equal=True,
                saves=watch.saves, restores=watch.restores)


def elastic_events_in_order(events) -> bool:
    """checkpoint @ 4, then an interruption, then the engine's
    re-provisioning, then the rewind to 4."""
    want = [lambda e: e.kind == "checkpoint" and e.step == ELASTIC_CKPT_EVERY,
            lambda e: e.kind == "interruption",
            lambda e: e.kind == "restore"
            and e.detail.startswith("re-provisioned"),
            lambda e: e.kind == "restore" and e.detail
            == f"rewound to checkpoint @ {ELASTIC_CKPT_EVERY}"]
    i = 0
    for e in events:
        if i < len(want) and want[i](e):
            i += 1
    return i == len(want)


def elastic_phase(torch, market, col) -> tuple:
    """Spot-elastic training of qwen2-0.5b at full width and depth on the
    sim phase's world (see the module docstring).  B2's counter is set to
    0 just before the trainer is built and read after its second run
    (``launch_segment``: every launch held bit for bit)."""
    import shutil
    import tempfile

    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import RecommendationEngine
    from repro_torch.core.pool import POOL_TILED_AUTO_K
    from repro_torch.data import make_pipeline
    from repro_torch.elastic import ElasticConfig, SpotElasticTrainer
    from repro_torch.elastic import cluster
    from repro_torch.models import get_model
    from repro_torch.train import optim
    from repro_torch.train.optim import tree_flatten

    t_start = time.perf_counter()
    laps, t_lap = {}, [t_start]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    cands = col.to_candidate_set(window=INGEST_WINDOW)
    if len(cands) < POOL_TILED_AUTO_K:
        fail(f"elastic phase: K = {len(cands)} would not reach B2")
    cfg = get_config(ELASTIC_ARCH)
    model = get_model(cfg, device=DEVICE)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2,
                       total_steps=ELASTIC_RUNS[1])
    ecfg = ElasticConfig(checkpoint_every=ELASTIC_CKPT_EVERY)
    pipe = make_pipeline(cfg, ELASTIC_SEQ, ELASTIC_BATCH, seed=0,
                         device=DEVICE)
    workdir = Path(tempfile.mkdtemp(prefix="elastic_phase_"))
    provisions, first_grads, norms, step_s = [], [], [], []
    exact_bytes, clock, parts = [0], [0.0], []

    class Watched(RecommendationEngine):
        def score(self, sub, req):
            self.last = (sub, super().score(sub, req))
            return self.last[1]

        def recommend(self, cands, req):
            rec = super().recommend(cands, req)
            sub, rows = self.last
            provisions.append((cands, sub, req, rec, rows))
            return rec

    class timed:
        """The pipeline, marking each step's start."""

        def batch(self, step):
            torch.cuda.synchronize()
            clock[0] = time.perf_counter()
            return pipe.batch(step)

    def exchange(real):
        def wrapped(worker_grads, feedbacks):
            if not first_grads:
                first_grads.extend(exchange_slice(torch, g)
                                   for g in worker_grads)
            exact_bytes[0] += len(worker_grads) * sum(
                4 * x.numel() for x in tree_flatten(worker_grads[0])[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(worker_grads, feedbacks)
            torch.cuda.synchronize()
            parts.append(dict(grads=t0 - clock[0],
                              exchange=time.perf_counter() - t0))
            return out
        return wrapped

    def update(real):
        def wrapped(*args):
            t0 = time.perf_counter()
            out = real(*args)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - clock[0])
            parts[-1]["update"] = time.perf_counter() - t0
            norms.append(float(out[2]["grad_norm"]))
            return out
        return wrapped

    def run():
        tr = SpotElasticTrainer(model, tcfg, market, cands, ecfg, timed(),
                                workdir / "elastic", seed=0, device=DEVICE)
        first = tr.train(ELASTIC_RUNS[0], minutes_per_step=ELASTIC_MINUTES)
        first_losses, first_events = list(first["losses"]), len(tr.events)
        for n in list(tr.nodes):        # every node reclaimed at once
            tr.market.terminate(n.market_ids)
            for rec in tr.market.records:
                if rec.node_id in n.market_ids:
                    rec.reason = "interrupted"
        second = tr.train(ELASTIC_RUNS[1], minutes_per_step=ELASTIC_MINUTES)
        return tr, first_losses, first_events, second

    torch.cuda.reset_peak_memory_stats()
    try:
        with patched(cluster, "RecommendationEngine", lambda real: Watched), \
                patched(cluster, "allreduce_compressed", exchange), \
                patched(optim, "adamw_update", update), \
                ckpt_watch(torch, "elastic phase") as watch:
            (tr, first_losses, first_events, second), launches, err = \
                launch_segment(torch, "elastic phase", run)
        peak = torch.cuda.max_memory_allocated()
        lap("train")
        losses = first_losses + second["losses"]
        if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
            fail(f"elastic phase: losses {losses} or gradient norms {norms} "
                 "not finite")
        events = [(e.step, e.kind, e.detail) for e in tr.events]
        if not elastic_events_in_order(tr.events):
            fail(f"elastic phase: events {events} lack checkpoint @ "
                 f"{ELASTIC_CKPT_EVERY}, interruption, re-provisioning and "
                 f"the rewind to {ELASTIC_CKPT_EVERY}, in that order")
        if second["restored_from"] != ELASTIC_CKPT_EVERY or not watch.restores:
            fail(f"elastic phase: restored from {second['restored_from']}")
        if launches["pool_scan"] == 0:
            fail("elastic phase: the engine never launched B2")
        nodes = [dict(node=n.node_id, pool="/".join(map(str, n.pool)),
                      speed=n.speed) for n in tr.nodes]
        wire = second["wire_bytes"]
        shard = tr._node_shards(pipe.batch(0))[0]
        grad_profile = profile_call(
            torch, lambda: tr._grad_fn(tr.state.params, shard))
        del tr, shard
        provision = hold_provisions(torch, provisions, "elastic phase")
        lap("provisions against the CPU")
        exchange_check = hold_exchange(torch, first_grads)
        del first_grads[:]
        lap("exchange against the CPU")
        launcher = launcher_substep(torch, workdir / "launcher")
        lap("launcher")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    p50 = float(np.percentile(step_s, 50))
    report = dict(
        arch=ELASTIC_ARCH, params=model.num_params(), K=len(cands),
        nodes_wanted=ecfg.nodes_wanted, batch=ELASTIC_BATCH, seq=ELASTIC_SEQ,
        runs=list(ELASTIC_RUNS), minutes_per_step=ELASTIC_MINUTES,
        checkpoint_every=ELASTIC_CKPT_EVERY,
        events=events, events_of_first_run=first_events,
        final_nodes=nodes, losses=losses, grad_norms=norms,
        step_s=step_s, step_s_p50=p50,
        step_parts_s_p50={k: float(np.percentile([x[k] for x in parts], 50))
                          for k in ("grads", "exchange", "update")},
        grad_profile=grad_profile,
        tokens_per_s=ELASTIC_BATCH * ELASTIC_SEQ / p50,
        saves=watch.saves, restores=watch.restores, peak_bytes=peak,
        wire_bytes=dict(compressed=wire, exact=exact_bytes[0],
                        ratio=wire / exact_bytes[0]),
        provisions=provision, exchange=exchange_check, launcher=launcher,
        launches=launches, max_abs_err=err, seconds=laps,
        phase_s=time.perf_counter() - t_start)
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


def hold_flash_call(torch, label, args, got, plain):
    """One B4 launch against its plain version (``hold_flash``'s contract:
    one bf16 ulp or ``FLASH_P_ULP`` * max|v|)."""
    floor = FLASH_P_ULP * float(args[2].abs().max())
    far, bad, err = bf16_closeness(got, plain, floor)
    if bad or not bool(torch.isfinite(got).all()):
        fail(f"{label}: B4 at {tuple(args[0].shape)} differs from its plain "
             f"version in {bad} elements beyond one bf16 ulp and "
             f"{FLASH_P_ULP} x max|v| = {floor:.3g} (max |d| {err:.3g})")
    return dict(beyond_one_ulp=far, max_abs_err=err, bound=floor,
                elements=got.numel())


def hold_gmm_call(torch, label, name, args, got, plain):
    """One B7 or B8 launch against its plain version (``hold_gmm``'s
    contract: one bf16 ulp or 1e-3 * max)."""
    far, bad, err = bf16_closeness(got, plain)
    if bad:
        fail(f"{label}: {name} at {tuple(args[0].shape)} differs from its "
             f"plain version in {bad} elements beyond one bf16 ulp and 1e-3 "
             "* max")
    return dict(name=name, C=args[0].shape[1], beyond_one_ulp=far,
                max_abs_err=err, elements=got.numel())


def generate(torch, model, params, prompt, new: int, extra=None, watch=None):
    """Greedy serving: prefill, then ``new - 1`` decode steps.  Returns the
    (B, new) tokens, the (B, new, V) float32 logits they were picked from,
    the prefill time and the per-step decode times (host clock around work
    that ends in a synchronise).  ``extra`` joins the prefill's batch (a
    frontend's ``frames`` or ``prefix_embeds``; the patches take positions
    before the prompt's); ``watch(stage, cache)``, if given, sees the cache
    after the prefill (``"prefill"``) and after the last step (``"end"``)."""
    extra = extra or {}
    B, S = prompt.shape
    if "prefix_embeds" in extra:
        S += extra["prefix_embeds"].shape[1]
    cache = model.init_cache(B, S + new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompt, **extra}, cache)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if watch is not None:
        watch("prefill", cache)
    toks, rows, step_ms = [tok], [logits[:, -1].float()], []
    for i in range(new - 1):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, tok, cache, S + i)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(tok)
        rows.append(logits[:, -1].float())
    if watch is not None:
        watch("end", cache)
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
              exact=None, prefix=None):
    """Each layer's update ``out - in`` through ``cfg`` (kernels) and
    ``ref_cfg`` (the plain route) on the same input and the same starting
    cache, at prefill and at the first decode step, the stack advancing on
    ``cfg``'s output and cache.  With ``cached=False`` the walk is the
    full-sequence forward's: no cache, every layer over the whole prompt,
    no decode step, and each layer is also run in float32 (parameters and
    input upcast, the plain route); each route's distance from that is
    recorded in ``exact`` (|update - update_f32| / |update_f32|, per
    layer: ``cfg``'s, then ``ref_cfg``'s).  ``prefix`` (B, P, D) goes in
    front of the prompt's embeddings (the vision frontend's patches).
    Returns the per-layer |update_cfg - update_ref| / |update_cfg|
    (Frobenius norms) at prefill (or the forward) and at the decode step
    (empty without a cache)."""
    from repro_torch.models import lm
    from repro_torch.models.param import tree_map
    B = prompt.shape[0]
    S = prompt.shape[1] + (0 if prefix is None else prefix.shape[1])
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
        x = lm._embed_inputs(cfg, params, prompt, prefix)
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
        rec = hold_gmm_call(torch, f"{arch} {phase}", name, args, got, plain)
        checks[f"{name}@{phase}"] = dict(shape=list(args[0].shape), **{
            k: rec[k] for k in ("beyond_one_ulp", "max_abs_err", "elements")})
        max_err[name] = max(max_err.get(name, 0.0), rec["max_abs_err"])
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
        # an MoE model (DeepSeek-V2-Lite, llama4-scout): B7/B8 in every MoE
        # layer, at prefill and decode, at the capacities the config gives
        # the served tokens
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


def hold_flash(torch, captured, prefixes=FLASH_PREFIXES, seeded=True):
    """B4 against its plain version on the first layer's q, k, v as
    captured, on prefixes of them (``prefixes``: a ragged S = 4000 and a
    short S = 77 by default), and with ``seeded`` on seeded inputs with
    G = 1, D = 128, S = 1000: every output within one bf16 ulp, or within
    ``FLASH_P_ULP`` * max|v|.  The count beyond the B7/B8 contract (one
    ulp or 1e-3 * max|plain|) is recorded."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = captured
    D = q.shape[-1]
    rng = np.random.default_rng(LM_SEED)
    on = lambda a: torch.from_numpy(a.astype(np.float32)).to(  # noqa: E731
        DEVICE).to(torch.bfloat16)
    cases = [("captured", (q, k, v), D ** -0.5)]
    for S in prefixes:
        cases.append((f"S={S}", tuple(t[:, :S].contiguous() for t in (q, k, v)),
                      D ** -0.5))
    if seeded:
        cases.append(("G=1, D=128, S=1000",
                      (on(rng.standard_normal((2, 1000, 8, 128))),
                       on(rng.standard_normal((2, 1000, 8, 128))),
                       on(rng.standard_normal((2, 1000, 8, 128)))),
                      128 ** -0.5))
    checks, max_err = {}, 0.0
    for label, args, scale in cases:
        got = fa.flash_attention(*args, scale=scale)
        plain = fa.flash_attention(*args, scale=scale, backend="torch")
        torch.cuda.synchronize()
        rec = hold_flash_call(torch, f"flash_attention at {label}", args, got,
                              plain)
        checks[label] = dict(q_shape=list(args[0].shape),
                             kv_heads=args[1].shape[2],
                             beyond_b7_b8_contract=bf16_closeness(got, plain)[1],
                             max_abs_plain=float(plain.abs().max()), **rec)
        max_err = max(max_err, rec["max_abs_err"])
    return checks, max_err


def flash_times(torch, captured, plain_reps: int = TIME_REPS):
    """B4 alone on the captured q, k, v: device and call time, the plain
    version's (over ``plain_reps`` calls), scaled_dot_product_attention's
    (timed only: the port never calls it) and the bound."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = captured
    B, S, H, D = q.shape
    scale = D ** -0.5
    call_ms, dev_ms = time_ms(lambda: fa.flash_attention(q, k, v, scale=scale),
                              ("flash_kernel",))
    plain_call_ms, plain_dev_ms = time_ms(
        lambda: fa.flash_attention(q, k, v, scale=scale, backend="torch"), None,
        reps=plain_reps)
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


def prefix_inputs(torch, cfg, batch: int, n_text: int, seed: int) -> dict:
    """Seeded prompt tokens (``batch``, ``n_text``) and the frontend's stub
    embeddings (``batch``, ``frontend_len``, ``d_model``), standard normal
    drawn on the card and rounded to bf16: ``frames`` for an
    encoder-decoder model, ``prefix_embeds`` for the vision prefix."""
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, n_text))).to(DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    emb = torch.randn((batch, cfg.frontend_len, cfg.d_model), generator=g,
                      device=DEVICE).to(torch.bfloat16)
    return {"tokens": tokens, "frames" if cfg.encdec else "prefix_embeds": emb}


def encdec_layerwise(torch, cfg, ref_cfg, params, batch, *, cached=True,
                     exact=None):
    """:func:`layerwise` for an encoder-decoder model: each encoder layer's
    update, then each decoder layer's, through ``cfg`` (kernels) and
    ``ref_cfg`` (the plain route) on the same input and starting caches,
    the stacks advancing on ``cfg``'s outputs; at prefill (self and cross
    caches written) and at the first decode step, or with ``cached=False``
    over the full-sequence forward, where each layer also runs in float32
    (``exact`` as in :func:`layerwise`).  Over the forward, each decoder
    layer's self-attention (the sublayer where B4 runs) is also held
    alone on the layer's normed input: its output through ``cfg`` against
    ``ref_cfg``'s and the float32 one, and ``ref_cfg``'s against the
    float32 one (``"self_attn"``).  Returns the per-layer deviations
    ``{"encoder": [...], "decoder": [...], "decode": [...],
    "self_attn": [...]}``."""
    from repro_torch.models import attention, encdec, lm
    from repro_torch.models.param import tree_map
    tokens, frames = batch["tokens"], batch["frames"]
    B, S = tokens.shape
    F = frames.shape[1]
    caches = encdec.init_cache(cfg, B, S + 1, tokens.device) if cached else None
    up = lambda p: tree_map(lambda t: t.float(), p)  # noqa: E731

    def dev(xa, xb, x):
        return float((xa.float() - xb.float()).norm()
                     / (xa.float() - x.float()).norm())

    def exact_dev(xf, xs, x):
        return tuple(float((y.float() - x.float() - (xf - x.float())).norm()
                           / (xf - x.float()).norm()) for y in xs)

    out = {"encoder": [], "decoder": [], "decode": [], "self_attn": []}

    def self_attn(p, x, positions):
        h = lm.rmsnorm(p["ln1"], x, cfg.rms_eps)
        ma, mb = (attention.apply_gqa(c, p["self_attn"], h,
                                      positions=positions)[0].float()
                  for c in (cfg, ref_cfg))
        mf = attention.apply_gqa(ref_cfg, up(p["self_attn"]), h.float(),
                                 positions=positions)[0]
        rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
        return rel(ma, mb), rel(ma, mf), rel(mb, mf)
    with torch.no_grad():
        x = frames.to(torch.bfloat16)
        pos = torch.arange(F, dtype=torch.int32, device=x.device)[None].expand(B, F)
        for u in range(cfg.enc_layers):
            p = tree_map(lambda a: a[u], params["enc_unit"])
            xa = encdec._enc_layer(cfg, p, x, pos)
            xb = encdec._enc_layer(ref_cfg, p, x, pos)
            out["encoder"].append(dev(xa, xb, x))
            if exact is not None and not cached:
                xf = encdec._enc_layer(ref_cfg, up(p), x.float(), pos)
                exact.append(exact_dev(xf, (xa, xb), x))
            x = xa
        enc_out = lm.rmsnorm(params["enc_norm"], x, cfg.rms_eps)

        def walk(x, positions, index, valid, decode, key):
            for u in range(cfg.num_layers):
                p = tree_map(lambda a: a[u], params["dec_unit"])
                sc = tree_map(lambda a: a[u], caches["self"]) if cached else None
                cc = tree_map(lambda a: a[u], caches["cross"]) if cached else None
                xa = encdec._dec_layer(cfg, p, x, positions, enc_out, sc, cc,
                                       index, valid, decode)
                xb = encdec._dec_layer(ref_cfg, p, x, positions, enc_out,
                                       tree_map(torch.clone, sc),
                                       tree_map(torch.clone, cc), index, valid,
                                       decode)
                out[key].append(dev(xa, xb, x))
                if exact is not None and not cached:
                    xf = encdec._dec_layer(ref_cfg, up(p), x.float(), positions,
                                           enc_out.float(), None, None, None,
                                           None, False)
                    exact.append(exact_dev(xf, (xa, xb), x))
                if not cached:
                    out["self_attn"].append(self_attn(p, x, positions))
                x = xa
            return x

        x = lm._embed_inputs(cfg, params, tokens, None)
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        if not cached:
            walk(x, pos, None, None, False, "decoder")
            return out
        x = walk(x, pos, 0, S, False, "decoder")
        z = lm.rmsnorm(params["final_norm"], x[:, -1:], cfg.rms_eps)
        tok = lm._logits(cfg, params, z)[:, -1].argmax(-1, keepdim=True)
        x1 = lm._embed_inputs(cfg, params, tok, None)
        pos1 = torch.full((B, 1), S, dtype=torch.int32, device=x.device)
        walk(x1, pos1, S, S + 1, True, "decode")
    return out


def prefix_phase(torch, arch):
    """``arch`` (an encoder-decoder or vision-prefix model) at published
    width and depth: served through ``Model.prefill`` and greedy
    ``decode_step``s, then its full-sequence forward through B4, each
    held against the plain route; returns (B4's launches a forward, B4's
    timing at the forward's shape, the report)."""
    from dataclasses import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention, get_model

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: full fp32
    cfg = replace(get_config(arch), use_pallas=True)
    ref_cfg = replace(cfg, use_pallas=False)
    model = get_model(cfg, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(LM_SEED))
    torch.cuda.synchronize()
    report = dict(arch=arch, encoder_layers=cfg.enc_layers if cfg.encdec else 0,
                  decoder_layers=cfg.num_layers, params=model.num_params(),
                  param_bytes_allocated=torch.cuda.memory_allocated(),
                  init_s=time.perf_counter() - t0, frontend=cfg.frontend,
                  frontend_len=cfg.frontend_len)
    print(f"{arch}: {cfg.enc_layers if cfg.encdec else 0} encoder + "
          f"{cfg.num_layers} decoder layers, {report['params']} parameters, "
          f"{report['param_bytes_allocated'] / 1e9:.2f} GB allocated, drawn "
          f"in {report['init_s']:.1f} s")

    # serving: prefill and LM_NEW - 1 greedy decode steps, B4 never launched
    # (a cached prefill passes kv_valid, which takes the plain attend)
    B = PREFIX_SERVE_BATCH[arch]
    extra = prefix_inputs(torch, cfg, B, LM_PROMPT, seed=7)
    prompt = extra.pop("tokens")
    cross = {}

    def watch(stage, cache):
        if cfg.encdec:
            cross[stage] = {n: t.clone() for n, t in cache["cross"].items()}

    generate(torch, model, params, prompt, 3, extra)          # warm-up
    fa.flash_attention.launches = 0
    toks, rows, prefill_ms, step_ms = generate(torch, model, params, prompt,
                                               LM_NEW, extra, watch)
    if fa.flash_attention.launches != 0:
        fail(f"{arch}: serving launched B4 {fa.flash_attention.launches} "
             "times; the cached prefill and decode take the plain attend")
    if not bool(torch.isfinite(rows).all()):
        fail(f"{arch}: non-finite logits while serving")
    if tuple(toks.shape) != (B, LM_NEW):
        fail(f"{arch}: generated {tuple(toks.shape)} tokens")
    if cfg.encdec:
        # the cross cache is written once by the prefill and only read by
        # the decode steps
        unchanged = all(torch.equal(cross["prefill"][n], cross["end"][n])
                        for n in ("k", "v"))
        written = all(bool(cross["prefill"][n].any()) for n in ("k", "v"))
        if not written:
            fail(f"{arch}: the prefill left the cross cache empty")
        if not unchanged:
            fail(f"{arch}: the decode steps rewrote the cross cache")
        report["cross_cache"] = dict(
            shape=list(cross["prefill"]["k"].shape), written_at_prefill=written,
            bit_equal_after_decode=unchanged)
        del cross
    ref_toks, _, ref_prefill_ms, ref_step_ms = generate(
        torch, get_model(ref_cfg, device=DEVICE), params, prompt, LM_NEW, extra)
    report["serve"] = dict(
        batch=B, prompt=LM_PROMPT, frontend_positions=cfg.frontend_len,
        new_tokens=LM_NEW, prefill_ms=prefill_ms,
        decode_ms={"p50": float(np.percentile(step_ms, 50)),
                   "p90": float(np.percentile(step_ms, 90)),
                   "max": float(np.max(step_ms)), "steps": len(step_ms)},
        decode_tokens_per_s=B / (np.percentile(step_ms, 50) / 1e3),
        tokens_per_s=B * LM_NEW / ((prefill_ms + sum(step_ms)) / 1e3),
        b4_launches=fa.flash_attention.launches,
        plain_route=dict(tokens_agree=int((toks == ref_toks).sum()),
                         tokens=B * LM_NEW, prefill_ms=ref_prefill_ms,
                         decode_ms_p50=float(np.percentile(ref_step_ms, 50))))
    pre_dev = (encdec_layerwise(torch, cfg, ref_cfg, params,
                                {"tokens": prompt, **extra})
               if cfg.encdec else
               dict(zip(("decoder", "decode"), layerwise(
                   torch, cfg, ref_cfg, params, prompt,
                   prefix=extra["prefix_embeds"]))))
    worst = max(v for devs in pre_dev.values() for v in devs)
    report["serve"]["layerwise_update_rel_dev"] = dict(worst=worst, **pre_dev)
    if worst > LAYER_TOL:
        fail(f"{arch}: a layer's update differs between the kernel and plain "
             f"routes by {worst:.3g} of its norm (> {LAYER_TOL})")
    del extra, prompt, toks, rows, ref_toks
    torch.cuda.empty_cache()

    # the forward: B4 on every decoder self-attention
    Bf, Sf = PREFIX_FWD[arch]
    if cfg.encdec:
        batch = prefix_inputs(torch, cfg, Bf, Sf, seed=11)
    else:
        batch = make_pipeline(cfg, Sf, Bf, seed=0, device=DEVICE).batch(0)
        del batch["labels"]
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
    expect = (Bf, Sf, cfg.num_heads, cfg.head_dim)
    if tuple(q.shape) != expect or k.shape[2] != cfg.num_kv_heads:
        fail(f"{arch}: B4 was called at {tuple(q.shape)} with {k.shape[2]} KV "
             f"heads, not {expect} with {cfg.num_kv_heads}")
    fa.flash_attention.launches = 0
    torch.cuda.synchronize()
    with torch.no_grad():
        logits, _ = model.forward(params, batch, train=False)
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    if launches != cfg.num_layers:
        fail(f"{arch}: flash_attention launched {launches} times in one "
             f"forward, not once per decoder layer ({cfg.num_layers})")
    if tuple(logits.shape) != (Bf, Sf, cfg.padded_vocab):
        fail(f"{arch}: forward gave logits of shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        fail(f"{arch}: non-finite logits from the forward")
    del logits
    forward_ms = []
    for _ in range(PREFIX_FWD_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model.forward(params, batch, train=False)[0]
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t0) * 1e3)
        del out
    p50 = float(np.percentile(forward_ms, 50))
    text = batch["tokens"].shape[1]
    report["forward"] = dict(
        batch=Bf, positions=Sf, text_tokens=text, launches=launches,
        forward_ms={"p50": p50, "p90": float(np.percentile(forward_ms, 90)),
                    "calls": PREFIX_FWD_CALLS},
        tokens_per_s=Bf * text / (p50 / 1e3))
    checks, max_err = hold_flash(torch, captured[0], prefixes=(RAGGED_S,),
                                 seeded=False)
    report["forward"]["kernel_checks"] = checks
    timing = flash_times(torch, captured[0], plain_reps=PREFIX_PLAIN_REPS)
    timing.update(max_abs_err=max_err, launches=launches)
    del captured, q, k, v
    exact = []
    if cfg.encdec:
        # Gated: the encoder's layers against the plain route (B4 never
        # runs there) and each decoder layer's self-attention, where B4
        # runs, against the plain route's and float32.  The whole decoder
        # layer is recorded: its cross-attention (the plain attend in both
        # routes) attends over 1536 frames with the random init's nearly
        # hard max and turns the self-attention's rounding into a change of
        # the layer's update that is larger still with no kernel at all
        # (the plain route's own layer against float32).
        fwd_dev = encdec_layerwise(torch, cfg, ref_cfg, params, batch,
                                   cached=False, exact=exact)
        del fwd_dev["decode"]
        gated = fwd_dev["encoder"] + [max(a[:2]) for a in fwd_dev["self_attn"]]
        enc = cfg.enc_layers
        fwd_dev.update(encoder_vs_float32=[e[0] for e in exact[:enc]],
                       layer_b4_vs_float32=[e[0] for e in exact[enc:]],
                       layer_plain_vs_float32=[e[1] for e in exact[enc:]])
    else:
        fwd_dev = {"decoder": layerwise(
            torch, cfg, ref_cfg, params, batch["tokens"], cached=False,
            exact=exact, prefix=batch["prefix_embeds"])[0]}
        fwd_dev.update(b4_vs_float32=[e[0] for e in exact],
                       plain_vs_float32=[e[1] for e in exact])
        gated = fwd_dev["decoder"] + fwd_dev["b4_vs_float32"]
    worst = max(gated)
    report["forward"]["layerwise_update_rel_dev"] = dict(worst=worst,
                                                         **fwd_dev)
    if worst > FWD_LAYER_TOL:
        fail(f"{arch}: a layer's update through B4 differs from the plain "
             f"route's or the float32 layer's by {worst:.3g} of its norm "
             f"(> {FWD_LAYER_TOL})")
    report["peak_bytes"] = torch.cuda.max_memory_allocated()
    del params, batch
    torch.cuda.empty_cache()
    return launches, timing, report


def serve_layerwise(torch, cfg, ref_cfg, params, prompt):
    """Each layer's update through the cache (``cfg``: the prefill over the
    prompt, then the first greedy decode step) against the same layer of
    the cacheless plain forward (``ref_cfg``) over the prompt and that
    token, at the same positions and on the same input: the reference's
    ``test_serve_consistency`` property, layer by layer.  The stack
    advances on the cacheless forward's output.  Returns the per-layer
    |update_cached - update_full| / |update_full| at prefill and at the
    decode step."""
    from repro_torch.models import lm
    B, S = prompt.shape
    dev = prompt.device
    with torch.no_grad():
        logits, _ = lm.prefill(cfg, params, prompt,
                               lm.init_cache(cfg, B, S + 1, dev))
        tok = logits[:, -1].argmax(-1, keepdim=True)
        del logits
        x = lm._embed_inputs(cfg, params, torch.cat([prompt, tok], 1), None)
        pos = torch.arange(S + 1, dtype=torch.int32, device=dev)[None].expand(
            B, S + 1)
        cache = lm.init_cache(cfg, B, S + 1, dev)
        pre, dec = [], []
        for kind, moe, p, c in _layer_stack(cfg, params, cache):
            full = lm._apply_layer(ref_cfg, kind, moe, p, x, pos, None, None,
                                   None, False)[0]
            got = (lm._apply_layer(cfg, kind, moe, p, x[:, :S], pos[:, :S], c,
                                   0, S, False)[0],
                   lm._apply_layer(cfg, kind, moe, p, x[:, S:], pos[:, S:], c,
                                   S, S + 1, True)[0])
            for y, rows, out in zip(got, (slice(0, S), slice(S, S + 1)),
                                    (pre, dec)):
                upd = full[:, rows].float() - x[:, rows].float()
                out.append(float((y.float() - full[:, rows].float()).norm()
                                 / upd.norm()))
            x = full
    return pre, dec


class held_launches:
    """While active, every call of the kernel wrappers ``wrappers`` (name
    -> (module, attribute)) that the model makes runs the kernel, then its
    plain version on the same inputs, and is held: ``hold(name, args, got,
    plain)`` returns the call's record (and fails the run on a miss).
    ``first`` keeps each (name, phase)'s first inputs (``phase(name,
    args)``) for the timings.  The launches made here are the warm-up's,
    not the main path's."""

    def __init__(self, torch, wrappers, hold, phase):
        self.torch, self.wrappers, self.hold, self.phase = (torch, wrappers,
                                                            hold, phase)
        self.records, self.first, self.real = [], {}, {}

    def __enter__(self):
        for name, (module, attr) in self.wrappers.items():
            real = self.real[name] = getattr(module, attr)

            def wrapper(*args, _name=name, _real=real, **kw):
                got = _real(*args, **kw)
                plain = _real(*args, backend="torch", **kw)
                self.torch.cuda.synchronize()
                self.records.append(self.hold(_name, args, got, plain))
                self.first.setdefault((_name, self.phase(_name, args)), args)
                return got

            setattr(module, attr, wrapper)
        return self

    def __exit__(self, *exc):
        for name, (module, attr) in self.wrappers.items():
            setattr(module, attr, self.real[name])


def held_summary(records, key="max_abs_err") -> dict:
    """How many launches were held and their worst error."""
    return dict(held=len(records),
                max_abs_err=max((r[key] for r in records), default=0.0),
                beyond_one_ulp=sum(r["beyond_one_ulp"] for r in records))


def registry_phase(torch, arch):
    """``arch``, one of the registry architectures no other phase runs, at
    its published widths (depth as ``REGISTRY_DEPTH`` cuts it): served
    through ``Model.prefill`` and greedy ``decode_step``s (B7/B8 in every
    MoE layer; a dense model's serve path runs no kernel), then run forward
    through ``Model.forward`` with B4 in every layer.  Every kernel launch
    of the warm-up runs is held against its plain version; the main-path
    runs count launches from 0.  Returns (launches on the main paths,
    kernel timings, the report)."""
    from dataclasses import replace
    from repro_torch.configs.registry import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.models import attention, get_model, moe
    from repro_torch.models.param import tree_leaves

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: full fp32
    torch.cuda.empty_cache()
    start_bytes = torch.cuda.memory_allocated()
    if start_bytes > REGISTRY_START_BYTES:
        fail(f"{arch}: {start_bytes} bytes still allocated when the registry "
             f"phase starts (> {REGISTRY_START_BYTES})")
    published = get_config(arch)
    depth = REGISTRY_DEPTH.get(arch, published.num_layers)
    cfg = replace(published, use_pallas=True, num_layers=depth)
    ref_cfg = replace(cfg, use_pallas=False)
    Bf, Sf = REGISTRY_FWD[arch]
    cuts = ([f"depth {depth} of {published.num_layers}"]
            if depth != published.num_layers else [])
    cuts += [REGISTRY_CUTS[arch]] if arch in REGISTRY_CUTS else []
    model = get_model(cfg, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(LM_SEED))
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    capacity = torch.cuda.get_device_properties(0).total_memory
    report = dict(arch=arch, layers=depth, published_layers=published.num_layers,
                  cuts=cuts, params=model.num_params(), weight_bytes=weight_bytes,
                  start_bytes=start_bytes,
                  param_bytes_allocated=torch.cuda.memory_allocated(),
                  device_bytes=capacity, init_s=time.perf_counter() - t0,
                  heads=[cfg.num_heads, cfg.num_kv_heads, cfg.head_dim],
                  qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias,
                  tied_embeddings=cfg.tie_embeddings)
    print(f"{arch}: {depth} of {published.num_layers} layers, "
          f"{report['params']} parameters, {weight_bytes / 1e9:.2f} GB of "
          f"weights drawn in {report['init_s']:.1f} s ({start_bytes} bytes "
          "allocated before)")
    seconds = {"init": time.perf_counter() - t_start}

    # serving: prefill + LM_NEW - 1 greedy decode steps of LM_BATCH x
    # LM_PROMPT prompts; B4 never runs (the cached prefill passes kv_valid)
    t0 = time.perf_counter()
    prompt = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to(DEVICE)
    gmm_wrappers = {"moe_gmm": (moe, "moe_gmm"),
                    "moe_gmm_down": (moe, "moe_gmm_down")}
    path = lm_path(cfg) if cfg.moe else None
    with held_launches(
            torch, gmm_wrappers if cfg.moe else {},
            lambda name, a, got, plain: hold_gmm_call(
                torch, f"{arch} serve", name, a, got, plain),
            lambda name, a: path["phase"](a)) as serve_held:
        generate(torch, model, params, prompt, 3)            # warm-up
    fa.flash_attention.launches = 0
    gmm.moe_gmm.launches = gmm.moe_gmm_down.launches = 0
    toks, rows, prefill_ms, step_ms = generate(torch, model, params, prompt,
                                               LM_NEW)
    serve_launches = {"flash_attention": fa.flash_attention.launches,
                      "moe_gmm": gmm.moe_gmm.launches,
                      "moe_gmm_down": gmm.moe_gmm_down.launches}
    want = {"flash_attention": 0,
            "moe_gmm": path["launches"] if cfg.moe else 0,
            "moe_gmm_down": path["launches"] if cfg.moe else 0}
    for name, n in serve_launches.items():
        if n != want[name]:
            fail(f"{arch}: {name} launched {n} times in one prefill and "
                 f"{LM_NEW - 1} decode steps, not {want[name]}"
                 + (f" ({path['per']})" if cfg.moe and name != "flash_attention"
                    else ""))
    if not bool(torch.isfinite(rows).all()):
        fail(f"{arch}: non-finite logits while serving")
    if tuple(toks.shape) != (LM_BATCH, LM_NEW):
        fail(f"{arch}: generated {tuple(toks.shape)} tokens")
    p50 = float(np.percentile(step_ms, 50))
    floor_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    report["serve"] = dict(
        batch=LM_BATCH, prompt=LM_PROMPT, new_tokens=LM_NEW,
        prefill_ms=prefill_ms,
        decode_ms={"p50": p50, "p90": float(np.percentile(step_ms, 90)),
                   "max": float(np.max(step_ms)), "steps": len(step_ms)},
        decode_tokens_per_s=LM_BATCH / (p50 / 1e3),
        tokens_per_s=LM_BATCH * LM_NEW / ((prefill_ms + sum(step_ms)) / 1e3),
        weight_read_floor_ms=floor_ms, decode_p50_over_floor=p50 / floor_ms,
        launches=serve_launches)
    timings = {}
    if cfg.moe:
        report["serve"]["held"] = held_summary(serve_held.records)
        if len(serve_held.records) != 3 * 2 * path["layers"]:
            fail(f"{arch}: held {len(serve_held.records)} B7/B8 launches in "
                 f"the warm-up's prefill and two decode steps, not "
                 f"{3 * 2 * path['layers']}")
        checks, gmm_timings = path["hold"](torch, arch, serve_held.first)
        report["serve"]["kernel_checks"] = checks
        for name, t in gmm_timings.items():
            timings[name] = dict(t, held=held_summary(
                [r for r in serve_held.records if r["name"] == name]))
        # the kernel route against the plain route (einsum experts), layer
        # by layer on the same inputs and cache
        pre, dec = layerwise(torch, cfg, ref_cfg, params, prompt)
        gate = "kernel route against the plain route, through the cache"
    else:
        # no kernel on this path: each layer through the cache against the
        # cacheless plain forward at the same positions
        pre, dec = serve_layerwise(torch, cfg, ref_cfg, params, prompt)
        gate = "through the cache against the cacheless plain forward"
    worst = max(pre + dec)
    report["serve"]["layerwise_update_rel_dev"] = dict(
        gate=gate, tolerance=LAYER_TOL, worst=worst, prefill=pre, decode=dec)
    if worst > LAYER_TOL:
        fail(f"{arch}: a layer's update {gate} differs by {worst:.3g} of its "
             f"norm (> {LAYER_TOL})")
    del toks, rows, prompt
    torch.cuda.empty_cache()
    seconds["serve"] = time.perf_counter() - t0

    # the forward: B4 in every layer (and B7/B8 in llama4's)
    t0 = time.perf_counter()
    batch = make_pipeline(cfg, Sf, Bf, seed=0, device=DEVICE).batch(0)
    del batch["labels"]
    wrappers = {"flash_attention": (attention, "flash_attention")}
    if cfg.moe:
        wrappers.update(gmm_wrappers)

    def hold_fwd(name, a, got, plain):
        if name == "flash_attention":
            return dict(name=name, **hold_flash_call(torch, f"{arch} forward",
                                                    a, got, plain))
        return hold_gmm_call(torch, f"{arch} forward", name, a, got, plain)

    with held_launches(torch, wrappers, hold_fwd,
                       lambda name, a: "forward") as fwd_held:
        with torch.no_grad():
            model.forward(params, batch, train=False)        # warm-up
    q, k, v = fwd_held.first[("flash_attention", "forward")]
    expect = (Bf, Sf, cfg.num_heads, cfg.head_dim)
    if tuple(q.shape) != expect or k.shape[2] != cfg.num_kv_heads:
        fail(f"{arch}: B4 was called at {tuple(q.shape)} with {k.shape[2]} KV "
             f"heads, not {expect} with {cfg.num_kv_heads}")
    fa.flash_attention.launches = 0
    gmm.moe_gmm.launches = gmm.moe_gmm_down.launches = 0
    torch.cuda.synchronize()
    with torch.no_grad():
        logits, _ = model.forward(params, batch, train=False)
    torch.cuda.synchronize()
    fwd_launches = {"flash_attention": fa.flash_attention.launches,
                    "moe_gmm": gmm.moe_gmm.launches,
                    "moe_gmm_down": gmm.moe_gmm_down.launches}
    n_moe = depth if cfg.moe else 0
    for name, n in fwd_launches.items():
        want = depth if name == "flash_attention" else n_moe
        if n != want:
            fail(f"{arch}: {name} launched {n} times in one forward, not "
                 f"{want}")
    held = {name: [r for r in fwd_held.records if r["name"] == name]
            for name in wrappers}
    for name, recs in held.items():
        if len(recs) != fwd_launches[name]:
            fail(f"{arch}: held {len(recs)} {name} launches of the warm-up "
                 f"forward, not {fwd_launches[name]}")
    if tuple(logits.shape) != (Bf, Sf, cfg.padded_vocab):
        fail(f"{arch}: forward gave logits of shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        fail(f"{arch}: non-finite logits from the forward")
    del logits
    forward_ms = []
    for _ in range(REGISTRY_FWD_CALLS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            out = model.forward(params, batch, train=False)[0]
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t1) * 1e3)
        del out
    p50 = float(np.percentile(forward_ms, 50))
    report["forward"] = dict(
        batch=Bf, positions=Sf, launches=fwd_launches,
        forward_ms={"p50": p50, "p90": float(np.percentile(forward_ms, 90)),
                    "calls": REGISTRY_FWD_CALLS},
        tokens_per_s=Bf * Sf / (p50 / 1e3),
        held={name: held_summary(recs) for name, recs in held.items()})
    checks, max_err = hold_flash(torch, (q, k, v), prefixes=(RAGGED_S,),
                                 seeded=False)
    report["forward"]["kernel_checks"] = checks
    timing = flash_times(torch, (q, k, v), plain_reps=PREFIX_PLAIN_REPS)
    timing.update(max_abs_err=max(max_err, report["forward"]["held"][
        "flash_attention"]["max_abs_err"]), launches=fwd_launches[
            "flash_attention"], held=report["forward"]["held"]["flash_attention"])
    timings["flash_attention"] = timing
    if cfg.moe:
        for name in gmm_wrappers:
            timings[name]["forward"] = dict(
                C=int(fwd_held.first[(name, "forward")][0].shape[1]),
                launches=fwd_launches[name],
                held=report["forward"]["held"][name])
    del fwd_held, q, k, v
    seconds["forward"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    exact = []
    fwd_dev = layerwise(torch, cfg, ref_cfg, params, batch["tokens"],
                        cached=False, exact=exact)[0]
    tol = REGISTRY_FWD_LAYER_TOL[arch]
    worst = max(fwd_dev + [e[0] for e in exact])
    report["forward"]["layerwise_update_rel_dev"] = dict(
        tolerance=tol, worst=worst, b4_vs_plain=fwd_dev,
        b4_vs_float32=[e[0] for e in exact],
        plain_vs_float32=[e[1] for e in exact])
    if worst > tol:
        fail(f"{arch}: a layer's update through B4 differs from the plain "
             f"route's or the float32 layer's by {worst:.3g} of its norm "
             f"(> {tol})")
    seconds["layers"] = time.perf_counter() - t0
    report["peak_bytes"] = torch.cuda.max_memory_allocated()
    del params, batch
    torch.cuda.empty_cache()
    report["seconds"] = seconds
    report["phase_s"] = time.perf_counter() - t_start
    launches = {name: serve_launches[name] + fwd_launches[name]
                for name in serve_launches}
    return launches, timings, report


def registry_lines(rg: dict, timings: dict, card: str) -> list[str]:
    """The registry phase's summary lines for one architecture."""
    sv, fw = rg["serve"], rg["forward"]
    b4 = timings["flash_attention"]
    heads = "{} over {} heads of {}".format(*rg["heads"])
    lines = [
        f"{rg['arch']} ({card}): {rg['layers']} of {rg['published_layers']} "
        f"layers (cuts: {', '.join(rg['cuts']) or 'none'}), {heads}, "
        f"{rg['params']} parameters, {rg['param_bytes_allocated'] / 1e9:.2f} "
        f"GB allocated, peak {rg['peak_bytes'] / 1e9:.2f} GB of "
        f"{rg['device_bytes'] / 1e9:.2f} GB; {rg['phase_s']:.1f} s (budget "
        f"{REGISTRY_BUDGET_S:.0f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in rg["seconds"].items()) + ")",
        f"{rg['arch']} serve ({card}): {sv['batch']} x {sv['prompt']} prefill "
        f"{sv['prefill_ms']:.2f} ms, decode p50 / p90 "
        f"{sv['decode_ms']['p50']:.2f} / {sv['decode_ms']['p90']:.2f} ms "
        f"(weight-read floor {sv['weight_read_floor_ms']:.2f} ms, "
        f"{sv['decode_p50_over_floor']:.2f}x), {sv['decode_tokens_per_s']:.1f} "
        f"tokens/s a step, {sv['tokens_per_s']:.1f} tokens/s served; launches "
        + ", ".join(f"{k} {v}" for k, v in sv["launches"].items())
        + f"; layers ({sv['layerwise_update_rel_dev']['gate']}) within "
        f"{sv['layerwise_update_rel_dev']['worst']:.4g} (limit {LAYER_TOL})",
        f"{rg['arch']} forward ({card}): {fw['batch']} x {fw['positions']} "
        f"p50 / p90 {fw['forward_ms']['p50']:.2f} / "
        f"{fw['forward_ms']['p90']:.2f} ms, {fw['tokens_per_s']:.0f} tokens/s;"
        " launches " + ", ".join(f"{k} {v}" for k, v in fw["launches"].items())
        + ", held " + ", ".join(f"{k} {v['held']} (max |d| "
                                f"{v['max_abs_err']:.3g})"
                                for k, v in fw["held"].items())
        + f"; B4 at {tuple(b4['shape'])}, KV {b4['kv_heads']}: "
        f"{b4['ms']:.4f} ms (bound {b4['bound_ms']:.4f} by {b4['bound_by']}, "
        f"plain {b4['plain_ms']:.3f}, SDPA {b4['library_ms']:.4f}); layers "
        f"within {fw['layerwise_update_rel_dev']['worst']:.4g} (limit "
        f"{fw['layerwise_update_rel_dev']['tolerance']})"]
    for name in ("moe_gmm", "moe_gmm_down"):
        if name not in timings:
            continue
        for phase, t in timings[name]["shapes"].items():
            lines.append(
                f"{rg['arch']} {name} {phase} ({card}): E={t['E']} C={t['C']} "
                f"K={t['K']} N={t['N']}: {t['ms']:.4f} ms (bound "
                f"{t['bound_ms']:.4f} by {t['bound_by']}, plain "
                f"{t['plain_ms']:.3f}"
                + (f", torch.bmm {t['library_ms']:.4f}" if t["library_ms"]
                   else f", bmm products {t['products_bmm_ms']:.4f}") + ")")
    return lines


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


# ---------------------------------------------------------------------------
# mesh phase: four gloo ranks on the one card
# ---------------------------------------------------------------------------

MESH_SHAPE = (2, 2)              # ("data", "model"): four ranks on cuda:0
MESH_ARCH = "deepseek-v2-lite-16b"
MESH_SEED = 11                   # a layer's weights: MESH_SEED + its index
MESH_BATCHES = {"prefill": (LM_BATCH, LM_PROMPT), "decode": (LM_BATCH, 1)}
MESH_Y_ULPS = 2.0                # y against the per-shard one-device path
MESH_AUX_TOL = 1e-6
MESH_STEP_ARCH = ELASTIC_ARCH    # qwen2-0.5b, full width
MESH_STEP_BATCH, MESH_STEP_SEQ, MESH_STEP_ACCUM = 8, 512, 2
MESH_LOSS_RTOL = 1e-6
MESH_BUDGET_S = 90.0
MESH_TIMEOUT_S = 600.0
MESH_REDUCED = False             # reduced widths: a CPU rehearsal only


def mesh_ep(torch, mesh) -> dict:
    """Every MoE layer of ``MESH_ARCH`` at full width through the
    expert-parallel path (B7/B8) on this rank, at the LM phase's prefill
    batch and a decode batch; each layer drawn whole from its seed on every
    rank, which keeps its shard.  Each EP call has the kernels' counters
    set to 0 just before and read just after; each launch is held against
    its plain version right after it; y (gathered over "data") against the
    one-device path run on each data shard, aux against the mean of the
    shards' aux.  Wall times only: four ranks time-slice the card."""
    from dataclasses import replace

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.models import lm
    from repro_torch.models import moe as tmoe
    from repro_torch.models.param import init_params
    from repro_torch.parallel.collectives import full_tensor
    from repro_torch.parallel.sharding import (NamedSharding, P, dp_size,
                                               shard_tree)

    dev = torch.device(DEVICE)
    base = replace(get_config(MESH_ARCH), use_pallas=True)
    cfg, one = replace(base, mesh=mesh), base
    layers = [i for i in range(cfg.num_layers) if lm._is_moe_layer(cfg, i)]
    specs = tmoe._moe_specs(cfg.moe)
    shardings = {k: NamedSharding(mesh, v) for k, v in specs.items()}
    x_shd = NamedSharding(mesh, P(("data",), None, None))
    n_dp = dp_size(mesh)
    gen = torch.Generator(device=dev)
    xs = {name: torch.randn((B, S, cfg.d_model), generator=gen.manual_seed(
              MESH_SEED + k), device=dev).bfloat16()
          for k, (name, (B, S)) in enumerate(MESH_BATCHES.items())}

    real = {name: getattr(tmoe, name) for name in ("moe_gmm", "moe_gmm_down")}
    held = {name: dict(checked=0, beyond_one_ulp=0, max_abs_err=0.0)
            for name in real}
    shapes = {}

    def holding(name):
        def wrapper(*args):
            out = real[name](*args)
            plain = real[name](*args, backend="torch")
            far, bad, err = bf16_closeness(out, plain)
            if bad:
                fail(f"mesh phase: {name} at {tuple(args[0].shape)} differs "
                     f"from its plain version in {bad} elements")
            h = held[name]
            h["checked"] += 1
            h["beyond_one_ulp"] += far
            h["max_abs_err"] = max(h["max_abs_err"], err)
            shapes.setdefault(name, set()).add(tuple(args[0].shape))
            return out
        return wrapper

    launches = {name: 0 for name in real}
    worst = {name: dict(ulps=0.0, aux=0.0) for name in MESH_BATCHES}
    wall = {name: [] for name in MESH_BATCHES}
    capacity = {}
    for i in layers:
        full = init_params(tmoe.moe_specs(cfg),
                           gen.manual_seed(MESH_SEED + 100 + i), device=dev)
        p = shard_tree(full, shardings)
        for name, x in xs.items():
            xd = shard_tree(x, x_shd)
            for attr in real:
                setattr(tmoe, attr, holding(attr))
            try:
                gmm.moe_gmm.launches = gmm.moe_gmm_down.launches = 0
                mesh_sync(torch)
                t0 = time.perf_counter()
                with torch.no_grad():
                    y, aux = tmoe.apply_moe(cfg, p, xd)
                mesh_sync(torch)
                wall[name].append(time.perf_counter() - t0)
                launches["moe_gmm"] += gmm.moe_gmm.launches
                launches["moe_gmm_down"] += gmm.moe_gmm_down.launches
            finally:
                for attr, fn in real.items():
                    setattr(tmoe, attr, fn)
            got = full_tensor(y)
            with torch.no_grad():
                refs = [tmoe.apply_moe(one, full, s) for s in x.chunk(n_dp)]
            y_ref = torch.cat([r[0] for r in refs])
            aux_ref = torch.stack([r[1] for r in refs]).mean()
            mag = float(y_ref.float().abs().max())
            ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
            ulps = float((got.float() - y_ref.float()).abs().max()) / ulp
            aux_err = abs(float(aux.to_local()) - float(aux_ref))
            if not np.isfinite(mag) or ulps > MESH_Y_ULPS \
                    or aux_err > MESH_AUX_TOL:
                fail(f"mesh phase: layer {i} {name}: y {ulps:.3g} bf16 ulps "
                     f"of max|y| (> {MESH_Y_ULPS}) or aux {aux_err:.3g} "
                     f"(> {MESH_AUX_TOL}) from the per-shard one-device path")
            worst[name] = dict(ulps=max(worst[name]["ulps"], ulps),
                               aux=max(worst[name]["aux"], aux_err))
            capacity[name] = tmoe.capacity_of(cfg, x.numel() // x.shape[-1]
                                              // n_dp)
        del full, p
    per = len(layers) * len(MESH_BATCHES)
    for name, n in launches.items():
        if DEVICE == "cpu":                     # a CPU rehearsal launches none
            continue
        if n != per:
            fail(f"mesh phase: {name} launched {n} times on this rank, not "
                 f"one a layer and batch: {len(layers)} x "
                 f"{len(MESH_BATCHES)} = {per}")
        if held[name]["checked"] != n:
            fail(f"mesh phase: {held[name]['checked']} of {n} {name} "
                 "launches held against the plain version")
    return dict(layers=len(layers), launches=launches, per_formula=per,
                held=held, shapes={k: sorted(v) for k, v in shapes.items()},
                capacity=capacity, worst=worst,
                wall_ms_p50={k: 1e3 * float(np.median(v))
                             for k, v in wall.items()})


def mesh_restore(torch, mesh, root: str) -> dict:
    """``restore(shardings=)`` of the saved qwen2-0.5b ``TrainState``: each
    leaf a DTensor of its sharding, its local shard of the spec's shape and
    bit-equal to its slice of the leaf restored whole on the card."""
    from repro_torch._tree import tree_flatten, tree_map
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model
    from repro_torch.parallel.sharding import local_shape, local_slices
    from repro_torch.train import TrainState
    from repro_torch.train.optim import OptState
    from repro_torch.train.step import train_state_shardings

    dev = torch.device(DEVICE)
    tcfg = TrainConfig()
    model = get_model(get_config(MESH_STEP_ARCH), device=dev)
    shardings = train_state_shardings(model, mesh, tcfg)
    meta = lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta")  # noqa: E731
    p = tree_map(meta, model.structure())
    f32 = tree_map(lambda s: torch.empty(s.shape, dtype=torch.float32,
                                         device="meta"), model.structure())
    like = TrainState(p, OptState(mu=f32, nu=f32,
                                  master=f32 if tcfg.master_weights else None,
                                  count=torch.empty((), dtype=torch.int32,
                                                    device="meta")))
    mesh_sync(torch)
    t0 = time.perf_counter()
    got, step = ckpt.restore(root, like, shardings=shardings)
    mesh_sync(torch)
    seconds = time.perf_counter() - t0
    d = Path(root) / f"step_{step:09d}"
    read = whole = 0
    leaves = tree_flatten(got)[0]
    for i, (g, s, tgt) in enumerate(zip(leaves, tree_flatten(shardings)[0],
                                        tree_flatten(like)[0])):
        shape = tuple(tgt.shape)
        local = g.to_local()
        if tuple(g.placements) != s.placements or g.dtype != tgt.dtype \
                or tuple(local.shape) != local_shape(shape, s):
            fail(f"mesh phase: restored leaf {i} is {g.placements} "
                 f"{tuple(local.shape)} {g.dtype}, not {s.placements} "
                 f"{local_shape(shape, s)} {tgt.dtype}")
        one = torch.from_numpy(np.load(d / f"leaf_{i:05d}.npy")).to(
            device=dev, dtype=tgt.dtype)            # the one-device restore
        if not torch.equal(local, one[local_slices(shape, s)]):
            fail(f"mesh phase: restored leaf {i}'s shard is not its slice "
                 "of the one-device restore")
        read += local.numel() * 4                  # stored as float32 / int32
        whole += one.numel() * 4
        del one
    return dict(step=step, leaves=len(leaves), seconds=seconds,
                bytes_read=read, bytes_whole=whole)


def mesh_step_bound(torch, lr: float, s: float, A, w_new):
    """Per element, how far float32 reassociation can move a master weight
    in one AdamW step from zero moments: the accumulated gradients part by
    at most 2u * A (A = sum of |microbatch gradient| / G, u = 2^-24); the
    update g s / (|g s| + eps) by at most s / eps times that (never more
    than 2), plus 76 u for its own rounding and the norm's; the weight by
    lr times that plus one ulp of the result."""
    u = 2.0 ** -24
    dupd = torch.clamp(s * 2 * u * A.double() / 1e-8, max=2.0) + 76 * u
    w = w_new.double().abs().clamp_min(1e-38)
    return lr * dupd + torch.exp2(torch.floor(torch.log2(w)) - 23)


def mesh_step(torch, mesh) -> dict:
    """One qwen2-0.5b step (8 x 512 tokens, ``grad_accum=2``, plain route)
    with ``grad_shardings = opt_shardings``, each rank its ``batch_pspec``
    shard.  Rank 0 holds it against the one-device step on the whole batch
    with the same microbatches (``grad_accum = 2 x dp``): loss within
    ``MESH_LOSS_RTOL``, its master shard within ``mesh_step_bound`` and the
    gathered parameters within one bf16 ulp."""
    from dataclasses import replace

    import torch.distributed as dist

    from repro_torch._tree import tree_flatten
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models import get_model
    from repro_torch.parallel.sharding import (batch_shardings, dp_size,
                                               local_slices, shard_tree)
    from repro_torch.train import TrainState, build_train_step, init_train_state
    from repro_torch.train.optim import OptState
    from repro_torch.train.step import (make_loss_fn, train_state_shardings,
                                        value_and_grad)

    dev = torch.device(DEVICE)
    cfg = get_config(MESH_STEP_ARCH)
    model = get_model(cfg, device=dev)
    tcfg = TrainConfig(grad_accum=MESH_STEP_ACCUM)
    state = init_train_state(model, tcfg,
                             torch.Generator(device=dev).manual_seed(LM_SEED))
    batch = make_pipeline(cfg, MESH_STEP_SEQ, MESH_STEP_BATCH, seed=0,
                          device=dev).batch(0)
    oshard = train_state_shardings(model, mesh, tcfg).opt.mu
    bshard = batch_shardings(batch, mesh)
    opt = OptState(mu=shard_tree(state.opt.mu, oshard),
                   nu=shard_tree(state.opt.nu, oshard),
                   master=shard_tree(state.opt.master, oshard),
                   count=state.opt.count)
    rank0 = dist.get_rank() == 0
    if not rank0:
        state = TrainState(state.params, None)   # only rank 0 keeps it whole
    dbatch = {k: shard_tree(v, bshard[k]) for k, v in batch.items()}
    step_fn = build_train_step(model, tcfg, grad_shardings=oshard)
    mesh_sync(torch)
    t0 = time.perf_counter()
    new, metrics = step_fn(TrainState(state.params, opt), dbatch)
    mesh_sync(torch)
    step_s = time.perf_counter() - t0
    flat_shd = tree_flatten(oshard)[0]
    acc_bytes = sum(4 * int(np.prod([sl.stop - sl.start for sl in
                                     local_slices(tuple(s.shape), shd)]))
                    for s, shd in zip(tree_flatten(model.structure())[0],
                                      flat_shd))
    whole = 4 * model.num_params()
    report = dict(step_s=step_s, loss=float(metrics["loss"]),
                  grad_norm=float(metrics["grad_norm"]),
                  accumulator_bytes=acc_bytes, accumulator_bytes_whole=whole)
    if not rank0:
        return report
    G = MESH_STEP_ACCUM * dp_size(mesh)
    want, wm = build_train_step(model, replace(tcfg, grad_accum=G))(state,
                                                                    batch)
    rel = abs(float(metrics["loss"]) - float(wm["loss"])) / abs(float(wm["loss"]))
    if not rel <= MESH_LOSS_RTOL:
        fail(f"mesh phase: sharded step's loss {float(metrics['loss'])!r} is "
             f"{rel:.3g} off the one-device step's {float(wm['loss'])!r}")
    grad_fn = value_and_grad(make_loss_fn(model))
    rows = MESH_STEP_BATCH // G
    A = None
    for i in range(G):
        _, g = grad_fn(state.params, {k: v[rows * i:rows * (i + 1)]
                                      for k, v in batch.items()})
        a = [x.float().abs() / G for x in tree_flatten(g)[0]]
        A = a if A is None else [x + y for x, y in zip(A, a)]
        del g
    s = min(1.0, tcfg.grad_clip / (float(wm["grad_norm"]) + 1e-9))
    lr = float(wm["lr"])
    worst, apart = 0.0, 0
    for got, ref, a, shd in zip(tree_flatten(new.opt.master)[0],
                                tree_flatten(want.opt.master)[0], A, flat_shd):
        sl = local_slices(tuple(ref.shape), shd)
        d = (got.to_local().double() - ref[sl].double()).abs()
        ratio = float((d / mesh_step_bound(torch, lr, s, a[sl], ref[sl]))
                      .max())
        worst = max(worst, ratio)
        apart += int((d > 0).sum())
    if not worst <= 1.0:
        fail(f"mesh phase: a master weight of rank 0's shard lies {worst:.3g}"
             " of its reassociation bound from the one-device step's")
    p_apart = 0
    for got, ref in zip(tree_flatten(new.params)[0],
                        tree_flatten(want.params)[0]):
        far, bad, _ = bf16_closeness(got, ref, floor=0.0)
        if far:
            fail(f"mesh phase: {far} parameters beyond one bf16 ulp of the "
                 "one-device step's")
        p_apart += int((got != ref).sum())
    report.update(one_device_loss=float(wm["loss"]), loss_rel=rel,
                  master_worst_of_bound=worst, master_apart=apart,
                  params_apart=p_apart, oracle_grad_accum=G)
    return report


def mesh_sync(torch) -> None:
    if DEVICE != "cpu":
        torch.cuda.synchronize()


def mesh_rank(rank: int, world: int, store: str, root: str, out_dir: str,
              device: str, reduced: bool) -> None:
    """One rank of the mesh phase: a gloo process group on a ``FileStore``
    (every rank on ``device``: the one card, or the CPU in a rehearsal),
    the (2, 2) mesh, then :func:`mesh_ep`, :func:`mesh_restore` and
    :func:`mesh_step`; its report goes to ``out_dir/rank<r>.json``.
    ``reduced`` (a CPU rehearsal) takes every configuration's reduced
    widths."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    global DEVICE
    DEVICE = device
    if reduced:
        from repro_torch.configs import registry
        full = registry.get_config
        registry.get_config = lambda arch: full(arch).reduced()
    if device != "cpu":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh(torch.device(device).type, MESH_SHAPE,
                                mesh_dim_names=("data", "model"))
        t0 = time.perf_counter()
        report = dict(rank=rank, coordinate=list(mesh.get_coordinate()))
        report["ep"] = mesh_ep(torch, mesh)
        report["restore"] = mesh_restore(torch, mesh, root)
        report["step"] = mesh_step(torch, mesh)
        report["rank_s"] = time.perf_counter() - t0
        if device != "cpu":
            report["peak_bytes"] = torch.cuda.max_memory_allocated()
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def mesh_phase(torch) -> tuple:
    """The device mesh (see the module docstring): a full-width qwen2-0.5b
    ``TrainState`` saved once, then four spawned gloo ranks on ``cuda:0``
    (:func:`mesh_rank`).  The parent built every kernel; the ranks load the
    libraries.  A rank that fails fails the phase.  B7's and B8's device
    times at the EP path's shapes (E_loc = 32 experts, C = 120 at prefill,
    8 at decode) are then taken here, alone on the card."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import moe_gmm as gmm
    from repro_torch.models import get_model
    from repro_torch.train import init_train_state

    t_start = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="mesh_phase_"))
    try:
        model = get_model(get_config(MESH_STEP_ARCH), device=DEVICE)
        state = init_train_state(
            model, TrainConfig(),
            torch.Generator(device=DEVICE).manual_seed(LM_SEED))
        t0 = time.perf_counter()
        ckpt.save(work / "ckpt", state, 1)
        save_s = time.perf_counter() - t0
        del state, model
        torch.cuda.empty_cache()
        world = int(np.prod(MESH_SHAPE))
        t0 = time.perf_counter()
        ctx = mp.start_processes(
            mesh_rank, args=(world, str(work / "store"), str(work / "ckpt"),
                             str(work), DEVICE, MESH_REDUCED),
            nprocs=world, start_method="spawn", join=False)
        try:
            while not ctx.join(timeout=1.0):
                if time.perf_counter() - t0 > MESH_TIMEOUT_S:
                    fail(f"mesh phase: ranks still running after "
                         f"{MESH_TIMEOUT_S:.0f} s")
        except ProcessException as err:
            fail(f"mesh phase: a rank failed: {err}")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                    proc.join(5)
        ranks_s = time.perf_counter() - t0
        reports = [json.loads((work / f"rank{r}.json").read_text())
                   for r in range(world)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_start

    ep = [r["ep"] for r in reports]
    launches = {name: sum(e["launches"][name] for e in ep)
                for name in ("moe_gmm", "moe_gmm_down")}
    dev = torch.device(DEVICE)
    cfg = get_config(MESH_ARCH)
    E_loc = cfg.moe.num_experts // MESH_SHAPE[1]
    D, Fe = cfg.d_model, cfg.moe.d_ff
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev  # noqa: E731
                                     ).bfloat16()
    times = {}
    for phase, C in ep[0]["capacity"].items():
        x, h = rnd(E_loc, C, D), rnd(E_loc, C, Fe)
        w1, w3, w2 = rnd(E_loc, D, Fe), rnd(E_loc, D, Fe), rnd(E_loc, Fe, D)
        times[phase] = {
            "moe_gmm": gmm_times(torch, gmm, "moe_gmm", (x, w1, w3), C),
            "moe_gmm_down": gmm_times(torch, gmm, "moe_gmm_down", (h, w2), C)}
        del x, h, w1, w3, w2
    torch.cuda.empty_cache()
    report = dict(shape=list(MESH_SHAPE), backend="gloo", arch=MESH_ARCH,
                  save_s=save_s, ranks_s=ranks_s, phase_s=phase_s,
                  budget_s=MESH_BUDGET_S, ranks=reports, launches=launches,
                  kernel_times=times)
    return launches, report


# ---------------------------------------------------------------------------
# launch phase: the launch cells on one rank
# ---------------------------------------------------------------------------

LAUNCH_BUDGET_S = 150.0
LAUNCH_MOE_ARCH = "deepseek-v2-lite-16b"
# key -> (arch, shape, cut batch, cut sequence, through the kernels);
# prefill_32k at S = 32768 took 14.9 s a call on the card (the plain MLA
# attend's float32 scores), three calls past the phase's budget, so its
# sequence is cut to 8192
LAUNCH_CELLS = {"a": ("qwen2-0.5b", "train_4k", 8, 4096, False),
                "b": (LAUNCH_MOE_ARCH, "prefill_32k", 1, 8192, True),
                "c": (LAUNCH_MOE_ARCH, "decode_32k", 16, 32768, True)}
LAUNCH_TIMED = {"train": 3, "prefill": 2, "decode": 5}   # after one warm call
LAUNCH_SEED = 3
ALLOC_GRANULE = 512           # the caching allocator's block rounding
LAUNCH_ENTRY_TIMEOUT_S = 900.0
# a rank of the dry-run's DeepSeek-V2-Lite decode_32k cell on 16 x 16 holds
# 9.43 GiB of arguments and one layer's per-head K / V shard (~0.17 GB)
LAUNCH_DRYRUN_LIMIT_GIB = 12.0
LAUNCH_ENTRY_POINTS = {
    "dryrun": ["--arch", LAUNCH_MOE_ARCH, "--shape", "decode_32k",
               "--single-pod-only"],
    "roofline": ["--arch", "qwen2-0.5b", "--shape", "train_4k"],
}


def host_process(args, **kw):
    """A process on the host with the repo's packages and no card."""
    import os
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, **kw)


def entry_point(name: str, args):
    """``python -m repro_torch.launch.<name>`` on the host."""
    return host_process(["-m", f"repro_torch.launch.{name}", *args])


def finish_entry_point(name: str, proc, timeout: float) -> list[str]:
    """Wait for ``proc``; fail unless it exits 0.  Returns its summary
    lines (``[ok]`` / ``[skip]`` / ``[FAIL]``, the dry-run summary, table
    rows)."""
    try:
        out, err = proc.communicate(timeout=max(timeout, 1.0))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{name} still running after {timeout:.0f} s")
    if proc.returncode != 0:
        fail(f"{name} exited {proc.returncode}: {out[-1500:]} {err[-1500:]}")
    return [line for line in out.splitlines()
            if line.startswith(("[ok]", "[skip]", "[FAIL]", "dry-run summary",
                                "|"))]


def hold_dryrun(lines: list[str], since: float) -> dict:
    """The dry-run entry point's DeepSeek-V2-Lite ``decode_32k`` cell on
    the production mesh, traced on this host's torch: fail unless its
    ``[ok]`` line reports at most ``LAUNCH_DRYRUN_LIMIT_GIB`` a device and
    no summary line lists it over the card.  Returns the cell's record
    (written by the entry point since ``since``, the epoch seconds)."""
    import re

    import torch
    from repro_torch.launch.dryrun import ART_DIR
    arch, shape = LAUNCH_ENTRY_POINTS["dryrun"][1], \
        LAUNCH_ENTRY_POINTS["dryrun"][3]
    cell = f"{arch} × {shape} × single"
    ok = [ln for ln in lines if ln.startswith("[ok]") and cell in ln]
    if len(ok) != 1:
        fail(f"dryrun: no [ok] line for {cell}: {lines}")
    gib = float(re.search(r"~([0-9.]+) GiB/device", ok[0]).group(1))
    if gib > LAUNCH_DRYRUN_LIMIT_GIB:
        fail(f"dryrun: {cell} at {gib} GiB a device on torch "
             f"{torch.__version__}, over {LAUNCH_DRYRUN_LIMIT_GIB} GiB")
    over = [ln for ln in lines if "over the card" in ln]
    if over:
        fail(f"dryrun: cells over the card on torch {torch.__version__}: "
             f"{over}")
    path = ART_DIR / f"{arch}__{shape}__single.json"
    if not path.exists() or path.stat().st_mtime < since:
        fail(f"dryrun: {path} was not written by this run")
    mem = json.loads(path.read_text())["memory"]
    return dict(cell=cell, torch=torch.__version__,
                peak_gib=mem["peak_estimate_bytes"] / 2 ** 30,
                argument_gib=mem["argument_bytes"] / 2 ** 30,
                line_gib=gib, limit_gib=LAUNCH_DRYRUN_LIMIT_GIB)


def launch_spec(key: str, device: str):
    """(config, cut shape) of launch cell ``key``; on ``device="meta"``
    the plain route (the trace counts a kernel's work through its plain
    version)."""
    from dataclasses import replace

    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_config
    arch, name, batch, seq, kernels = LAUNCH_CELLS[key]
    cfg = replace(get_config(arch), use_pallas=kernels and device != "meta")
    return cfg, replace(SHAPES[name], global_batch=batch, seq_len=seq)


def launch_traces(out_path: str, keys) -> None:
    """Host side of the launch phase, in a process of its own: each cut
    cell's ``roofline_cell`` (one rank's step traced on meta tensors, its
    peak by ``trace.rank_mem_tracker``) and ``argument_bytes``, on a
    one-rank mesh over a fake group, as JSON at ``out_path``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.cells import (argument_bytes, build_cell,
                                          pick_grad_accum)
    from repro_torch.launch.roofline import roofline_cell

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        out = {}
        for key in keys:
            t0 = time.perf_counter()
            cfg, shape = launch_spec(key, "meta")
            ga = (pick_grad_accum(cfg.with_parallelism(1), shape, mesh)
                  if shape.kind == "train" else 1)
            roof = roofline_cell(cfg.arch_id, shape.name, mesh=mesh,
                                 cfg_override=cfg, shape=shape, grad_accum=ga,
                                 save=False, memory=True)
            cell = build_cell(cfg, shape, mesh, TrainConfig(), grad_accum=ga,
                              device="meta")
            out[key] = dict(
                grad_accum=ga, flops=roof.flops_dev,
                model_flops=roof.model_flops, compute_s=roof.compute_s,
                memory_floor_s=roof.memory_floor_s, memory_s=roof.memory_s,
                peak_bytes=roof.detail["trace"]["peak_bytes"],
                argument_bytes=argument_bytes(cell),
                trace_s=time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()
    Path(out_path).write_text(json.dumps(out))


def arg_tensors(torch, args) -> list:
    from repro_torch._tree import tree_flatten
    return [t for t in tree_flatten(list(args))[0]
            if isinstance(t, torch.Tensor)]


def launch_cell(torch, mesh, key: str, *, params=None, hold=None,
                before_timing=None):
    """Launch cell ``key`` on the card (module docstring, phase 8c): the
    arguments from ``materialize_cell`` (``params`` reused if given) and
    the allocator's bytes for them, a warm call (through ``hold``'s
    wrappers, or counted by ``FlopCounterMode`` for training),
    ``before_timing()`` if given, timed calls, finite outputs.  Returns
    (measurements, args); the checks against the host's trace come in
    :func:`hold_launch_cell`."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.cells import build_cell, materialize_cell

    cfg, shape = launch_spec(key, DEVICE)
    cell = build_cell(cfg, shape, mesh, TrainConfig(), device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    stat = "requested_bytes.all.current"
    req0 = torch.cuda.memory_stats().get(stat)
    alloc0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    args = materialize_cell(
        cell, torch.Generator(device=DEVICE).manual_seed(LAUNCH_SEED),
        params=params)
    torch.cuda.synchronize()
    materialize_s = time.perf_counter() - t0
    req1 = torch.cuda.memory_stats().get(stat)
    alloc1 = torch.cuda.memory_allocated()
    shared = {id(t) for t in arg_tensors(torch, [params])} if params else set()
    leaves = arg_tensors(torch, args)
    fresh = [t for t in leaves if id(t) not in shared]
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    held = dict(whole=sum(nbytes(t) for t in leaves),
                fresh=sum(nbytes(t) for t in fresh),
                requested=None if req0 is None else req1 - req0,
                rounded=sum(-(-nbytes(t) // ALLOC_GRANULE) * ALLOC_GRANULE
                            for t in fresh),
                allocated=alloc1 - alloc0)

    fn = cell.fn
    counter = FlopCounterMode(display=False) if shape.kind == "train" \
        else contextlib.nullcontext()
    t0 = time.perf_counter()
    with hold if hold is not None else contextlib.nullcontext(), counter:
        out = fn(*args)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    del out
    if before_timing is not None:
        before_timing()
    torch.cuda.reset_peak_memory_stats()     # the peak of the timed calls
    step_s = []
    for _ in range(LAUNCH_TIMED[shape.kind]):
        if hold is not None:
            hold.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if hold is not None:
            hold.read()
        if shape.kind == "train":
            vals = [float(v) for v in out[1].values()]
            if not all(np.isfinite(v) for v in vals):
                fail(f"launch ({key}): metrics not finite: {out[1]}")
        elif not bool(torch.isfinite(out[0]).all()):
            fail(f"launch ({key}): non-finite logits")
        del out
    report = dict(
        arch=cfg.arch_id, shape=shape.name, kind=shape.kind,
        batch=shape.global_batch, seq=shape.seq_len,
        grad_accum=cell.tcfg.grad_accum if shape.kind == "train" else 1,
        materialize_s=materialize_s, warm_s=warm_s, step_s=step_s,
        step_s_p50=float(np.percentile(step_s, 50)), argument_bytes=held,
        counted_flops=int(counter.get_total_flops())
        if shape.kind == "train" else None,
        # the cell's own peak: less what earlier phases left allocated
        # (the reused weights are the cell's)
        peak_bytes=torch.cuda.max_memory_allocated()
        - (alloc0 - (held["whole"] - held["fresh"])))
    return report, args


def hold_launch_cell(key: str, rep: dict, host: dict) -> None:
    """Cell ``key``'s card run (``rep``) against the host's trace of the
    same cut cell (``host``): the arguments' bytes, the FLOPs of a
    training step, no step faster than its bound; adds the shares."""
    held = rep["argument_bytes"]
    if rep["grad_accum"] != host["grad_accum"]:
        fail(f"launch ({key}): G = {rep['grad_accum']} on the card, "
             f"{host['grad_accum']} in the trace")
    if held["whole"] != host["argument_bytes"]:
        fail(f"launch ({key}): the arguments hold {held['whole']} bytes, the "
             f"dry-run's argument_bytes of the cut cell is "
             f"{host['argument_bytes']}")
    if held["requested"] is not None and held["requested"] != held["fresh"]:
        fail(f"launch ({key}): the allocator holds {held['requested']} "
             f"requested bytes for the arguments, not their {held['fresh']}")
    if held["allocated"] < held["rounded"]:
        fail(f"launch ({key}): {held['allocated']} bytes allocated, under "
             f"the 512-byte-rounded sum {held['rounded']}")
    if rep["counted_flops"] is not None \
            and rep["counted_flops"] != int(host["flops"]):
        fail(f"launch ({key}): FlopCounterMode counts {rep['counted_flops']} "
             f"FLOPs on the card, the meta trace {int(host['flops'])}")
    p50 = rep["step_s_p50"]
    bound_s = max(host["compute_s"], host["memory_floor_s"])
    if p50 < bound_s:
        fail(f"launch ({key}): a step of {p50:.6f} s is faster than its "
             f"bound {bound_s:.6f} s: the count is wrong")
    rep.update(host=host, bound_s=bound_s,
               compute_share=host["compute_s"] / p50,
               floor_share=host["memory_floor_s"] / p50)
    print(f"launch ({key}) ({card_line()}): {rep['arch']} {rep['shape']} B = "
          f"{rep['batch']}, S = {rep['seq']}, G = {rep['grad_accum']}: step "
          f"p50 {p50:.6f} s over {len(rep['step_s'])}; compute "
          f"{host['compute_s']:.6f} s ({rep['compute_share']:.4f} of the "
          f"step), memory floor {host['memory_floor_s']:.6f} s "
          f"({rep['floor_share']:.4f}); arguments {held['whole']} bytes "
          f"(dry-run {host['argument_bytes']}, requested {held['requested']} "
          f"of {held['fresh']} new, allocated {held['allocated']}, "
          f"512-rounded {held['rounded']}); peak {rep['peak_bytes'] / 1e9:.3f}"
          f" GB against the estimate {host['peak_bytes'] / 1e9:.3f} GB; "
          f"seconds: materialize {rep['materialize_s']:.1f}, warm "
          f"{rep['warm_s']:.1f}, host trace {host['trace_s']:.1f}")


class GmmHold:
    """B7 and B8 through the MoE module with each launch held against its
    plain version right after it (entered), and the launch counters set to
    0 (``reset``) and read (``read``) around a counted call."""

    def __init__(self, torch, label: str):
        from repro_torch.kernels import moe_gmm
        from repro_torch.models import moe
        self.label, self.module = label, moe
        self.fns = {"moe_gmm": moe_gmm.moe_gmm,
                    "moe_gmm_down": moe_gmm.moe_gmm_down}
        self.held = {name: dict(launches=0, beyond_one_ulp=0, max_abs_err=0.0)
                     for name in self.fns}
        self.counted = []

    def __enter__(self):
        for name, real in self.fns.items():
            setattr(self.module, name, self._holding(name, real))
        return self

    def __exit__(self, *exc):
        for name, real in self.fns.items():
            setattr(self.module, name, real)

    def _holding(self, name, real):
        def wrapper(*args, **kw):
            got = real(*args, **kw)
            plain = real(*args, backend="torch")
            far, bad, err = bf16_closeness(got, plain)
            if bad:
                fail(f"launch {self.label}: {name} differs from its plain "
                     f"version in {bad} elements beyond one bf16 ulp and "
                     "1e-3 * max")
            h = self.held[name]
            h["launches"] += 1
            h["beyond_one_ulp"] += far
            h["max_abs_err"] = max(h["max_abs_err"], err)
            return got
        return wrapper

    def reset(self):
        for fn in self.fns.values():
            fn.launches = 0

    def read(self):
        self.counted.append({name: fn.launches
                             for name, fn in self.fns.items()})


def launch_host() -> tuple:
    """Start the launch phase's host work: the dry-run and roofline entry
    points and the traces of the cut cells (two processes, cell (a)'s
    alone: its eight microbatches take the longest).  It runs beside cell
    (a)'s arguments and warm call, and every timed call waits for it (four
    CPU-heavy processes would slow the host-bound steps).  Returns
    (processes, their work directory, the start time)."""
    import atexit
    import shutil
    import tempfile
    work = Path(tempfile.mkdtemp(prefix="launch_phase_"))
    code = ("import sys, chip_smoke; "
            "chip_smoke.launch_traces(*sys.argv[1:2], sys.argv[2:])")
    procs = {name: entry_point(name, args)
             for name, args in LAUNCH_ENTRY_POINTS.items()}
    procs.update({f"traces {keys}": host_process(
        ["-c", code, str(work / f"{keys}.json"), *keys])
        for keys in ("a", "bc")})

    def stop():                    # also when an earlier phase fails
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(work, ignore_errors=True)

    atexit.register(stop)
    return procs, work, time.perf_counter()


def launch_phase(torch) -> tuple:
    """The launch cells on the card (module docstring, phase 8c) with the
    host work of :func:`launch_host` finished before the first timed call,
    then the checks against it; the report entry point runs once the rest
    is done."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_host_mesh

    t_start, epoch = time.perf_counter(), time.time()
    procs, work, host_t0 = launch_host()
    entry, host_s = {}, {}

    def wait_for_host():
        t0 = time.perf_counter()
        for name, proc in procs.items():
            left = LAUNCH_ENTRY_TIMEOUT_S - (time.perf_counter() - host_t0)
            entry[name] = finish_entry_point(name, proc, left)
        host_s.update(host=time.perf_counter() - host_t0,
                      wait=time.perf_counter() - t0)

    cells, launches, held = {}, {}, {}
    n_moe = get_config(LAUNCH_MOE_ARCH).num_layers \
        - get_config(LAUNCH_MOE_ARCH).moe.first_dense_layers
    try:
        mesh = make_host_mesh(device=DEVICE)
        try:
            cells["a"], args = launch_cell(torch, mesh, "a",
                                           before_timing=wait_for_host)
            del args
            torch.cuda.empty_cache()
            params = None
            for key in ("b", "c"):
                hold = GmmHold(torch, f"({key})")
                cells[key], args = launch_cell(torch, mesh, key,
                                               params=params, hold=hold)
                params = args[0]
                del args
                torch.cuda.empty_cache()
                for counted in hold.counted:
                    for kname, n in counted.items():
                        if n != n_moe:
                            fail(f"launch ({key}): {kname} launched {n} "
                                 f"times in one step, not once per MoE "
                                 f"layer ({n_moe})")
                kind = cells[key]["kind"]
                for kname, h in hold.held.items():
                    if h["launches"] != n_moe:
                        fail(f"launch ({key}): {h['launches']} {kname} "
                             f"launches held on the warm call, not {n_moe}")
                    launches[kname] = launches.get(kname, 0) \
                        + hold.counted[0][kname]
                    held.setdefault(kname, {})[kind] = h
                cells[key]["launches"] = hold.counted
            del params
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
        cards_s = time.perf_counter() - t_start - host_s["wait"]
        dryrun = hold_dryrun(entry["dryrun"], epoch)
        host = {}
        for keys in ("a", "bc"):
            host.update(json.loads((work / f"{keys}.json").read_text()))
            del entry[f"traces {keys}"]
        for key, rep in cells.items():
            hold_launch_cell(key, rep, host[key])
        entry["report"] = finish_entry_point(
            "report", entry_point("report", []), 120.0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        import shutil
        shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_start
    report = dict(cells=cells, held=held, cards_s=cards_s,
                  entry_points=entry, dryrun=dryrun, phase_s=phase_s,
                  host_s=host_s["host"], wait_s=host_s["wait"],
                  budget_s=LAUNCH_BUDGET_S)
    return launches, report


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

    sim_launches, sim, sim_world_after = sim_phase(torch)
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

    op_launches, op = operator_phase(torch, *sim_world_after)
    print("operator phase: " + json.dumps(op))
    mc = op["multicloud"]
    print(f"operator phase: {op['phase_s']:.1f} s (budget {OP_BUDGET_S:.0f} "
          "s): " + ", ".join(f"{k} {v:.1f}" for k, v in op["seconds"].items())
          + f"; multicloud K = {mc['K']} in {mc['regions']} region shards, "
          f"{mc['warmup_cycles']} cycles (two days) primed into a ring of "
          f"{mc['ring']}: the one cut in depth")
    runs = {"control": op["operator"]["control"],
            "faults": op["operator"]["faults"], "multicloud": mc["replay"]}
    print("operator phase reconcile_once on the host clock (ms), p50 / p90: "
          + "; ".join(f"{k} {v['reconcile_ms']['p50']:.2f} / "
                      f"{v['reconcile_ms']['p90']:.2f}"
                      for k, v in runs.items()))
    print("operator phase, simulator outcomes (not card numbers): " + "; ".join(
        f"{k} delivered {v['report']['delivered_availability']:.4f} "
        f"recommended {v['report']['recommended_availability']:.4f}, "
        f"{v['report']['rerecommendations']} re-recommendations, "
        f"{v['report']['migrations_planned']} plans, "
        f"{v['report']['launches']} launches, "
        f"{v['report']['retirements']} retirements, "
        f"{v['report']['interruptions']} interruptions"
        for k, v in runs.items()))
    for line in compare_lines(op["compare"], op["seconds"]["compare"],
                              card):
        print(line)
    timings["score_fuse"]["operator_phase"] = dict(
        launches={"phase0": op_launches["score_fuse_phase0"],
                  "emit": op_launches["score_fuse"]},
        max_abs_err={"phase0": op["max_abs_err"]["score_fuse_phase0"],
                     "emit": op["max_abs_err"]["score_fuse"]})
    for name in ("pool_scan", "stats_update"):
        timings[name]["operator_phase"] = dict(
            launches=op_launches[name], max_abs_err=op["max_abs_err"][name])

    an_launches, an = analysis_phase(torch, cands, *sim_world_after)
    print("analysis phase: " + json.dumps(an))
    sv, rp = an["serving"], an["replay"]
    print(f"analysis phase ({card}): {an['phase_s']:.1f} s (budget "
          f"{ANALYSIS_BUDGET_S:.0f} s): "
          + ", ".join(f"{k} {v:.2f}" for k, v in an["seconds"].items())
          + f"; spotlint 0 findings in {an['lint']['files']} files in "
          f"{an['lint']['s']:.2f} s")
    print(f"analysis phase ({card}): {sv['ticks_pumped']} ticks pumped at "
          f"K = {sv['K']} while {sv['requests']} requests were served in "
          f"{sv['serve_calls']} calls ({sv['drains']} drains) at "
          f"{sv['versions_served']['distinct']} versions; tickets p50 "
          f"{sv['ticket_ms']['p50']:.3f} ms, p90 {sv['ticket_ms']['p90']:.3f}"
          f" ms; acquisition-order edges {sv['edges']}; the replay's "
          f"{rp['edges']}; 0 race reports, 0 cycles; controls: "
          f"{an['controls']['report']}; cycle {an['controls']['cycle']}")
    for name in ("score_fuse", "pool_scan", "stats_update"):
        timings[name]["analysis_phase"] = dict(
            launches=an_launches[name], max_abs_err=an["max_abs_err"][name])

    el_launches, el = elastic_phase(torch, *sim_world_after)
    del sim_world_after
    print("elastic phase: " + json.dumps(el))
    print(f"elastic phase: {el['phase_s']:.1f} s (budget "
          f"{ELASTIC_BUDGET_S:.0f} s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in el["seconds"].items())
          + f"; {el['arch']} ({el['params']} parameters) on "
          f"{el['nodes_wanted']} nodes over K = {el['K']}, step p50 "
          f"{el['step_s_p50']:.4f} s ("
          + ", ".join(f"{k} {v:.4f}"
                      for k, v in el["step_parts_s_p50"].items())
          + f"), {el['tokens_per_s']:.0f} tokens/s, a node's gradient "
          f"call idle {el['grad_profile']['idle_share']:.3f}, "
          f"peak {el['peak_bytes'] / 1e9:.2f} GB; B2 launched "
          f"{el_launches['pool_scan']} times; wire bytes "
          f"{el['wire_bytes']['compressed']} compressed against "
          f"{el['wire_bytes']['exact']} exact")
    print("elastic phase checkpoints (bytes, s): " + "; ".join(
        [f"save @ {c['step']} {c['bytes']} in {c['s']:.2f}"
         for c in el["saves"]]
        + [f"restore @ {c['step']} {c['bytes']} in {c['s']:.2f}"
           for c in el["restores"]]))
    timings["pool_scan"]["elastic_phase"] = dict(
        launches=el_launches["pool_scan"],
        max_abs_err=el["max_abs_err"]["pool_scan"])

    for arch in LM_ARCHS:
        t0 = time.perf_counter()
        lm_launches, lm_timings, lm = lm_phase(torch, arch)
        lm["phase_s"] = time.perf_counter() - t0
        print(f"{arch}: " + json.dumps({**lm, "kernel_times": lm_timings}))
        launches.update(lm_launches)
        timings.update(lm_timings)

    prefix_t0 = time.perf_counter()
    prefix_timings = {}
    for arch in PREFIX_ARCHS:
        t0 = time.perf_counter()
        pf_launches, prefix_timings[arch], pf = prefix_phase(torch, arch)
        pf["phase_s"] = time.perf_counter() - t0
        print(f"{arch}: " + json.dumps({**pf, "b4": prefix_timings[arch]}))
        sv, fw, b4 = pf["serve"], pf["forward"], prefix_timings[arch]
        print(f"{arch} ({card}): prefill {sv['batch']} x ({sv['prompt']} + "
              f"{sv['frontend_positions']} {pf['frontend']}) "
              f"{sv['prefill_ms']:.2f} ms, decode p50 / p90 "
              f"{sv['decode_ms']['p50']:.2f} / {sv['decode_ms']['p90']:.2f} ms,"
              f" {sv['decode_tokens_per_s']:.1f} tokens/s; forward "
              f"{fw['batch']} x {fw['positions']} p50 / p90 "
              f"{fw['forward_ms']['p50']:.2f} / {fw['forward_ms']['p90']:.2f} "
              f"ms; B4 {pf_launches} launches a forward at "
              f"{tuple(b4['shape'])}, KV {b4['kv_heads']}: {b4['ms']:.4f} ms "
              f"(bound {b4['bound_ms']:.4f} by {b4['bound_by']}, plain "
              f"{b4['plain_ms']:.3f}, SDPA {b4['library_ms']:.4f}); peak "
              f"{pf['peak_bytes'] / 1e9:.2f} GB; {pf['phase_s']:.1f} s")
    prefix_s = time.perf_counter() - prefix_t0
    print(f"prefix phase: {prefix_s:.1f} s (budget {PREFIX_BUDGET_S:.0f} s)")

    registry_launches, registry_timings = {}, {}
    for arch in REGISTRY_ARCHS:
        rg_launches, registry_timings[arch], rg = registry_phase(torch, arch)
        print(f"{arch}: " + json.dumps({**rg, "kernel_times":
                                        registry_timings[arch]}))
        for line in registry_lines(rg, registry_timings[arch], card):
            print(line)
        for name, n in rg_launches.items():
            registry_launches[name] = registry_launches.get(name, 0) + n

    t0 = time.perf_counter()
    fwd_launches, fwd_timings, fwd = forward_phase(torch)
    fwd["phase_s"] = time.perf_counter() - t0
    print(f"{FWD_ARCH} forward: " + json.dumps({**fwd,
                                               "kernel_times": fwd_timings}))
    launches.update(fwd_launches)
    timings.update(fwd_timings)
    timings["flash_attention"]["prefix_phase"] = prefix_timings
    for name, n in registry_launches.items():
        launches[name] += n
        timings[name]["registry_phase"] = dict(launches=n, **{
            arch: t[name] for arch, t in registry_timings.items() if name in t})
    t0 = time.perf_counter()
    train = train_phase(torch, fwd["cross_entropy"])
    train["phase_s"] = time.perf_counter() - t0
    print(f"{FWD_ARCH} train: " + json.dumps(train))

    torch.cuda.empty_cache()
    print(f"mesh phase: {torch.cuda.memory_allocated()} bytes allocated "
          "before it")
    mesh_launches, mesh = mesh_phase(torch)
    print("mesh phase: " + json.dumps(mesh))
    r0 = mesh["ranks"][0]
    print(f"mesh phase ({card}): {mesh['phase_s']:.1f} s (budget "
          f"{MESH_BUDGET_S:.0f} s), wall times only (four ranks time-slice "
          f"the card): save {mesh['save_s']:.1f} s, ranks {mesh['ranks_s']:.1f}"
          " s; B7 / B8 launches a rank "
          + ", ".join(f"{r['ep']['launches']['moe_gmm']} / "
                      f"{r['ep']['launches']['moe_gmm_down']}"
                      for r in mesh["ranks"])
          + f" against {r0['ep']['layers']} layers x {len(MESH_BATCHES)} "
          f"batches = {r0['ep']['per_formula']}; y within "
          + ", ".join(f"{k} {max(r['ep']['worst'][k]['ulps'] for r in mesh['ranks']):.3g}"
                      for k in MESH_BATCHES)
          + f" bf16 ulps of max|y| (limit {MESH_Y_ULPS}); EP call wall ms "
          "p50 " + ", ".join(f"{k} {v:.2f}" for k, v in
                             r0["ep"]["wall_ms_p50"].items()))
    print("mesh phase restore per rank (s, bytes read of whole): " + "; ".join(
        f"{r['restore']['seconds']:.2f}, {r['restore']['bytes_read']} of "
        f"{r['restore']['bytes_whole']}" for r in mesh["ranks"]))
    st = r0["step"]
    print(f"mesh phase step: loss {st['loss']!r} against the one-device "
          f"step's {st['one_device_loss']!r} (rel {st['loss_rel']:.3g}); "
          f"rank 0's master shard at {st['master_worst_of_bound']:.3g} of "
          f"its bound ({st['master_apart']} elements apart), parameters "
          f"apart {st['params_apart']}; step wall s "
          + ", ".join(f"{r['step']['step_s']:.2f}" for r in mesh["ranks"])
          + "; accumulator bytes a rank "
          + ", ".join(str(r["step"]["accumulator_bytes"])
                      for r in mesh["ranks"])
          + f" of {st['accumulator_bytes_whole']} unsharded")
    for name in ("moe_gmm", "moe_gmm_down"):
        timings[name]["mesh_phase"] = dict(
            launches=mesh_launches[name],
            launches_per_rank=[r["ep"]["launches"][name]
                               for r in mesh["ranks"]],
            max_abs_err=max(r["ep"]["held"][name]["max_abs_err"]
                            for r in mesh["ranks"]),
            shapes={k: v[name] for k, v in mesh["kernel_times"].items()})

    torch.cuda.empty_cache()
    launch_launches, launch = launch_phase(torch)
    print("launch phase: " + json.dumps(launch))
    print(f"launch phase ({card}): {launch['phase_s']:.1f} s, the cells "
          f"{launch['cards_s']:.1f} s (budget {LAUNCH_BUDGET_S:.0f} s) and "
          f"{launch['wait_s']:.1f} s waiting for its host work ("
          f"{launch['host_s']:.1f} s from the phase's start); "
          + "; ".join(f"({k}) {c['arch']} {c['shape']} B = {c['batch']}: step "
                      f"p50 {c['step_s_p50']:.6f} s, compute share "
                      f"{c['compute_share']:.4f}, floor share "
                      f"{c['floor_share']:.4f}, peak "
                      f"{c['peak_bytes'] / 1e9:.3f} GB (estimate "
                      f"{c['host']['peak_bytes'] / 1e9:.3f})"
                      for k, c in launch["cells"].items()))
    for name, lines in launch["entry_points"].items():
        for line in lines if name != "report" else lines[:4]:
            print(f"launch phase, python -m repro_torch.launch.{name}: {line}")
    dry = launch["dryrun"]
    print(f"launch phase, dry-run on this host's torch {dry['torch']}: "
          f"{dry['cell']} peak {dry['peak_gib']:.4f} GiB a rank, arguments "
          f"{dry['argument_gib']:.4f} GiB (limit {dry['limit_gib']:.0f} GiB)")
    for name in ("moe_gmm", "moe_gmm_down"):
        launches[name] += launch_launches[name]
        timings[name]["launch_phase"] = dict(
            launches=launch_launches[name], held=launch["held"][name])

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
