"""Spot-elastic data-parallel training cluster.

PyTorch counterpart of ``repro.elastic.cluster``: where the paper's engine
becomes a training-infrastructure feature.  The cluster provisions its
node pool through the SpotVista recommendation engine
(:meth:`RecommendationEngine.recommend` on the trainer's device, so on the
card Algorithm 1 runs kernel B2 for a catalog of 512 candidates or more),
trains data-parallel across the pool, and reacts to market events:

- **interruption**  → drop the node, re-provision replacement capacity
  through the engine (availability-aware, so replacements come from
  currently stable pools), restore the latest checkpoint and resume with
  the new data-parallel width;
- **straggler**     → nodes whose recent step times run persistently
  slower than k x the median are ejected and replaced (same engine path);
- **gradient exchange** → optional int8-compressed all-reduce with error
  feedback (:mod:`repro_torch.parallel.compression`).

Each node's gradients are computed for real on its slice of the batch
(``train.step.value_and_grad``); the network between nodes is
process-local, as the simulator stands in for the cloud.  Node speeds and
step times are the reference's numpy draws in its order, so a run's events
match the reference's for the same market and seed.  As in the reference,
``train`` counts steps from 0 on every call and a restore rewinds the
count to the checkpoint's step.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..ckpt import checkpoint as ckpt
from ..cloudsim.market import SpotMarket
from ..core.engine import RecommendationEngine
from ..core.types import CandidateSet, ResourceRequest
from ..parallel.compression import (ErrorFeedback, allreduce_compressed,
                                    allreduce_exact)
from ..train import optim as optim_lib
from ..train.step import TrainState, init_train_state, make_loss_fn, value_and_grad


@dataclass
class ElasticConfig:
    required_cpus: float = 64.0
    nodes_wanted: int = 4           # DP width target
    checkpoint_every: int = 10
    heartbeat_window: int = 5
    straggler_factor: float = 2.5
    compress_grads: bool = True
    weight: float = 0.5             # engine W


@dataclass
class Node:
    node_id: int
    pool: tuple                     # (type, region, az)
    speed: float                    # simulated relative step speed
    market_ids: list[int] = field(default_factory=list)
    step_times: list[float] = field(default_factory=list)
    feedback: ErrorFeedback = field(default_factory=ErrorFeedback)


@dataclass
class StepEvent:
    step: int
    kind: str                       # "interruption" | "straggler" | "checkpoint" | "restore"
    detail: str


class SpotElasticTrainer:
    """Drives training of ``model`` on a SpotVista-provisioned spot pool.

    ``device`` (CUDA unless ``"cpu"`` is asked for) holds the model's state
    and runs the engine; the initial parameters are drawn from a
    ``torch.Generator`` on that device seeded with ``seed``, which also
    seeds the node speed and step-time draws, as in the reference.
    """

    def __init__(self, model, tcfg, market: SpotMarket, candidates: CandidateSet,
                 ecfg: ElasticConfig, pipeline, ckpt_dir, *, seed: int = 0,
                 device=None):
        self.model = model
        self.tcfg = tcfg
        self.market = market
        self.candidates = candidates
        self.ecfg = ecfg
        self.pipeline = pipeline
        self.ckpt_dir = ckpt_dir
        self.device = resolve_device(device)
        self.engine = RecommendationEngine(device=self.device)
        self.rng = np.random.default_rng(seed)
        self.events: list[StepEvent] = []
        self.wire_bytes = 0
        self._next_node_id = 0

        self._grad_fn = value_and_grad(make_loss_fn(model))
        self.state = init_train_state(
            model, tcfg, torch.Generator(device=self.device).manual_seed(seed))
        self.nodes: list[Node] = []
        self._provision(self.ecfg.nodes_wanted)

    # ------------------------------------------------------------------
    # provisioning through the paper's engine
    # ------------------------------------------------------------------

    def _provision(self, n_nodes: int) -> int:
        """Acquire up to n_nodes through the recommendation engine."""
        req = ResourceRequest(cpus=self.ecfg.required_cpus,
                              weight=self.ecfg.weight)
        rec = self.engine.recommend(self.candidates, req)
        acquired = 0
        for name, region, az in zip(rec.names, rec.regions, rec.azs):
            while acquired < n_nodes:
                ok, ids = self.market.request_spot(name, region, az, 1)
                if not ok:
                    break
                node = Node(self._next_node_id, (name, region, az),
                            speed=float(self.rng.uniform(0.8, 1.2)),
                            market_ids=ids)
                self._next_node_id += 1
                self.nodes.append(node)
                acquired += 1
            if acquired >= n_nodes:
                break
        return acquired

    def _alive_market_ids(self) -> set[int]:
        return {rec.node_id for rec in self.market.records if rec.alive}

    def _handle_interruptions(self, step: int) -> bool:
        """Drop reclaimed nodes; returns True if the pool changed."""
        alive = self._alive_market_ids()
        lost = [n for n in self.nodes if not set(n.market_ids) <= alive]
        if not lost:
            return False
        for n in lost:
            self.nodes.remove(n)
            self.events.append(StepEvent(step, "interruption",
                                         f"node {n.node_id} on {n.pool[0]}@{n.pool[2]}"))
        got = self._provision(self.ecfg.nodes_wanted - len(self.nodes))
        if got:
            self.events.append(StepEvent(
                step, "restore", f"re-provisioned {got} node(s) via engine"))
        return True

    def _handle_stragglers(self, step: int) -> None:
        if len(self.nodes) < 2:
            return
        med = np.median([np.mean(n.step_times[-self.ecfg.heartbeat_window:])
                         for n in self.nodes if n.step_times])
        for n in list(self.nodes):
            recent = n.step_times[-self.ecfg.heartbeat_window:]
            if (len(recent) >= self.ecfg.heartbeat_window
                    and np.mean(recent) > self.ecfg.straggler_factor * med):
                self.nodes.remove(n)
                self.market.terminate(n.market_ids)
                self.events.append(StepEvent(step, "straggler",
                                             f"ejected node {n.node_id}"))
                self._provision(self.ecfg.nodes_wanted - len(self.nodes))

    # ------------------------------------------------------------------
    # the training loop
    # ------------------------------------------------------------------

    def _node_shards(self, batch: dict) -> list[dict]:
        n = max(len(self.nodes), 1)
        B = next(iter(batch.values())).shape[0]
        per = max(B // n, 1)
        return [{k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                for i in range(n)]

    def train(self, steps: int, *, minutes_per_step: float = 1.0) -> dict:
        losses = []
        restored_from = None
        step = 0
        while step < steps:
            # market time advances; reclaims may hit our nodes
            self.market.advance(self.market.now + minutes_per_step)
            if self._handle_interruptions(step):
                latest = ckpt.latest_step(self.ckpt_dir)
                if latest is not None:
                    self.state, restored = ckpt.restore(self.ckpt_dir, self.state)
                    step = restored
                    restored_from = restored
                    self.events.append(StepEvent(step, "restore",
                                                 f"rewound to checkpoint @ {restored}"))
            if not self.nodes:
                raise RuntimeError("pool empty and re-provision failed")

            batch = self.pipeline.batch(step)
            shards = self._node_shards(batch)
            worker_grads, losses_step = [], []
            for node, shard in zip(self.nodes, shards):
                (loss, _), grads = self._grad_fn(self.state.params, shard)
                worker_grads.append(grads)
                losses_step.append(float(loss))
                node.step_times.append(
                    float(self.rng.gamma(20.0, node.speed / 20.0)))
            if self.ecfg.compress_grads:
                grads, wire = allreduce_compressed(
                    worker_grads, [n.feedback for n in self.nodes])
            else:
                grads, wire = allreduce_exact(worker_grads)
            del worker_grads
            self.wire_bytes += wire
            new_params, new_opt, _ = optim_lib.adamw_update(
                grads, self.state.params, self.state.opt, self.tcfg)
            self.state = TrainState(new_params, new_opt)
            losses.append(float(np.mean(losses_step)))

            self._handle_stragglers(step)
            step += 1
            if step % self.ecfg.checkpoint_every == 0:
                ckpt.save(self.ckpt_dir, self.state, step)
                self.events.append(StepEvent(step, "checkpoint", f"step {step}"))
        return {
            "losses": losses,
            "events": self.events,
            "wire_bytes": self.wire_bytes,
            "final_nodes": len(self.nodes),
            "restored_from": restored_from,
        }
