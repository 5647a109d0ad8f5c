"""Data pipeline: deterministic synthetic LM token streams.

PyTorch counterpart of ``repro.data.pipeline``: a seeded order-1 Markov
stream over the vocabulary with noise, so that training loss measurably
decreases.  The numpy draws are the reference's, so a batch's tokens equal
the reference's for the same (seed, step); they land as int32 tensors on
the pipeline's device (CUDA unless the caller passes ``device="cpu"``).
Deterministic per (seed, step): a restart at step N reproduces the stream.
The audio and vision frontends' embedding stubs are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import resolve_device


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_order: int = 1
    noise: float = 0.15
    frontend: str | None = None
    frontend_len: int = 0
    d_model: int = 0


class SyntheticLM:
    """Seeded order-1 Markov stream: next-token structure a model can learn."""

    def __init__(self, cfg: DataConfig, device=None):
        if cfg.frontend is not None:
            raise NotImplementedError(f"the {cfg.frontend} frontend's inputs "
                                      "are not ported yet (ROADMAP A.9)")
        self.cfg = cfg
        self.device = resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # sparse-ish row-stochastic transition structure
        self._succ = rng.integers(0, V, size=(V, 4))

    def batch(self, step: int) -> dict:
        """Batch for ``step`` (deterministic, restart-safe):
        ``{"tokens", "labels"}``, each (B, S) int32."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, B)
        choice = rng.integers(0, self._succ.shape[1], size=(B, S))
        noise = rng.random((B, S)) < cfg.noise
        noise_tok = rng.integers(0, cfg.vocab_size, size=(B, S))
        for t in range(S):
            nxt = self._succ[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], noise_tok[:, t], nxt)
        on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        return {"tokens": on(toks[:, :-1]), "labels": on(toks[:, 1:])}


def make_pipeline(model_cfg, seq_len: int, global_batch: int, seed: int = 0,
                  *, device=None) -> SyntheticLM:
    dcfg = DataConfig(
        vocab_size=model_cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=seed,
        frontend=model_cfg.frontend, frontend_len=model_cfg.frontend_len,
        d_model=model_cfg.d_model)
    return SyntheticLM(dcfg, device=device)
