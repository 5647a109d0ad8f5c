"""Model facade: family dispatch for the forward and serving paths.

PyTorch counterpart of ``repro.models.api``.  ``get_model(cfg)`` returns a
:class:`Model` bound to a device (CUDA unless the caller passes
``device="cpu"``); ``init`` draws parameters from a seeded
``torch.Generator`` on that device, ``forward`` runs a full sequence
(training and evaluation) and ``prefill`` / ``decode_step`` serve a batch.
Encoder-decoder models (``cfg.encdec``) dispatch to :mod:`.encdec` and take
the audio frontend's precomputed frames (``batch["frames"]``); the others
to :mod:`.lm`, the vision frontend's patch embeddings as
``batch["prefix_embeds"]``.  The frontends are stubs, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from . import encdec, lm
from .param import count_params, init_params


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

    # -- structure -----------------------------------------------------
    @property
    def _family(self):
        return encdec if self.cfg.encdec else lm

    def structure(self):
        return self._family.structure(self.cfg)

    def init(self, generator: torch.Generator):
        """Parameters on the model's device, drawn from ``generator`` (a
        seeded ``torch.Generator`` on that device)."""
        return init_params(self.structure(), generator, self.device)

    def num_params(self) -> int:
        return count_params(self.structure())

    def init_cache(self, batch: int, max_len: int):
        return self._family.init_cache(self.cfg, batch, max_len, self.device)

    # -- compute -------------------------------------------------------
    def forward(self, params, batch, *, train=True):
        """``batch``: ``{"tokens": (B, S) ids, ...}`` with ``"frames"`` (B,
        F, D) for an encoder-decoder model, optionally ``"prefix_embeds"``
        (B, P, D) for the others.  Returns the logits (B, S, V), over the
        prefix too, and the MoE auxiliary loss."""
        if self.cfg.encdec:
            return encdec.forward(self.cfg, params, batch["tokens"],
                                  batch["frames"], train=train)
        return lm.forward(self.cfg, params, batch["tokens"],
                          batch.get("prefix_embeds"), train=train)

    def prefill(self, params, batch, cache):
        """``batch`` as for :meth:`forward`.  Returns the last position's
        logits (B, 1, V) and the cache, written in place."""
        if self.cfg.encdec:
            return encdec.prefill(self.cfg, params, batch["tokens"],
                                  batch["frames"], cache)
        return lm.prefill(self.cfg, params, batch["tokens"], cache,
                          batch.get("prefix_embeds"))

    def decode_step(self, params, token, cache, index):
        return self._family.decode_step(self.cfg, params, token, cache, index)


def get_model(cfg: ModelConfig, *, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (CUDA when ``None``)."""
    return Model(cfg, resolve_device(device))
