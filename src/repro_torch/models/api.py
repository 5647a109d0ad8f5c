"""Model facade: family dispatch for the forward and serving paths.

PyTorch counterpart of ``repro.models.api``.  ``get_model(cfg)`` returns a
:class:`Model` bound to a device (CUDA unless the caller passes
``device="cpu"``); ``init`` draws parameters from a seeded
``torch.Generator`` on that device, ``forward`` runs a full sequence
(training and evaluation) and ``prefill`` / ``decode_step`` serve a batch.
Encoder-decoder models and modality frontends are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from . import lm
from .param import count_params, init_params


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

    # -- structure -----------------------------------------------------
    def structure(self):
        return lm.structure(self.cfg)

    def init(self, generator: torch.Generator):
        """Parameters on the model's device, drawn from ``generator`` (a
        seeded ``torch.Generator`` on that device)."""
        return init_params(self.structure(), generator, self.device)

    def num_params(self) -> int:
        return count_params(self.structure())

    def init_cache(self, batch: int, max_len: int):
        return lm.init_cache(self.cfg, batch, max_len, self.device)

    # -- compute -------------------------------------------------------
    def forward(self, params, batch, *, train=True):
        """``batch``: ``{"tokens": (B, S) ids, ...}``.  Returns the logits
        (B, S, V) and the MoE auxiliary loss."""
        if self.cfg.encdec:
            raise NotImplementedError("encoder-decoder models are not ported "
                                      "yet (ROADMAP A.9)")
        return lm.forward(self.cfg, params, batch["tokens"],
                          batch.get("prefix_embeds"), train=train)

    def prefill(self, params, batch, cache):
        """``batch``: ``{"tokens": (B, S) ids}``.  Returns the last
        position's logits (B, 1, V) and the cache, written in place."""
        return lm.prefill(self.cfg, params, batch["tokens"], cache,
                          batch.get("prefix_embeds"))

    def decode_step(self, params, token, cache, index):
        return lm.decode_step(self.cfg, params, token, cache, index)


def get_model(cfg: ModelConfig, *, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (CUDA when ``None``)."""
    if cfg.encdec:
        raise NotImplementedError("encoder-decoder models are not ported yet "
                                  "(ROADMAP A.9)")
    if cfg.frontend is not None:
        raise NotImplementedError("modality frontends are not ported yet "
                                  "(ROADMAP A.9)")
    return Model(cfg, resolve_device(device))
