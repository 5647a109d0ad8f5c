"""Data pipeline: deterministic synthetic LM token streams.

PyTorch counterpart of ``repro.data.pipeline``: a seeded order-1 Markov
stream over the vocabulary with noise, so that training loss measurably
decreases.  The numpy draws are the reference's, so a batch's tokens equal
the reference's for the same (seed, step); they land as int32 tensors on
the pipeline's device (CUDA unless the caller passes ``device="cpu"``).
Deterministic per (seed, step): a restart at step N reproduces the stream.
The vision and audio frontends are stubs, as in the reference: after the
token draws, the same generator draws ``prefix_embeds`` (vision) or
``frames`` (audio) of shape (B, ``frontend_len``, ``d_model``), rounded to
bf16 as the reference rounds them.
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


#: the batch key of each frontend's stub embeddings
_FRONTEND_KEY = {"vision": "prefix_embeds", "audio": "frames"}


def bf16_embeddings(a: np.ndarray, device) -> torch.Tensor:
    """A float64 host array as a bf16 tensor on ``device``, rounded as the
    reference's ``jnp.asarray(a, jnp.bfloat16)`` rounds it: to float32
    first, then to bf16 (the two roundings can land one bf16 ulp from a
    direct one, and the reference's do)."""
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).to(device)


class SyntheticLM:
    """Seeded order-1 Markov stream: next-token structure a model can learn."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # sparse-ish row-stochastic transition structure
        self._succ = rng.integers(0, V, size=(V, 4))

    def batch(self, step: int) -> dict:
        """Batch for ``step`` (deterministic, restart-safe):
        ``{"tokens", "labels"}``, each (B, S) int32, and the frontend's
        ``"prefix_embeds"`` or ``"frames"`` (B, F, D) bf16 where it has
        one."""
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
        out = {"tokens": on(toks[:, :-1]), "labels": on(toks[:, 1:])}
        if cfg.frontend in _FRONTEND_KEY:
            out[_FRONTEND_KEY[cfg.frontend]] = bf16_embeddings(
                rng.standard_normal((B, cfg.frontend_len, cfg.d_model)),
                self.device)
        return out


def make_pipeline(model_cfg, seq_len: int, global_batch: int, seed: int = 0,
                  *, device=None) -> SyntheticLM:
    dcfg = DataConfig(
        vocab_size=model_cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=seed,
        frontend=model_cfg.frontend, frontend_len=model_cfg.frontend_len,
        d_model=model_cfg.d_model)
    if model_cfg.frontend == "vision":
        # the patches take frontend_len of the sequence
        dcfg.seq_len = seq_len - model_cfg.frontend_len
    return SyntheticLM(dcfg, device=device)
