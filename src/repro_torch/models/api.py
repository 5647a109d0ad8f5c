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
``shape_structs`` / ``input_specs`` give the launch cells' meta stand-ins
(no storage), ``realize_inputs`` seeded inputs of the same shapes.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .._device import resolve_device
from ..configs.base import ModelConfig, ShapeConfig
from . import encdec, lm
from .param import count_params, init_params, shape_structs


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

    def shape_structs(self):
        """Meta tensors of every parameter's shape and dtype."""
        return shape_structs(self.structure())

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

    # -- input specs (meta stand-ins, no storage) ------------------------
    def input_specs(self, shape: ShapeConfig) -> dict:
        """Meta tensors of the inputs of ``shape``'s step function, the
        reference's shapes and dtypes: int32 ids, bf16 ``frames`` /
        ``prefix_embeds`` (the frontends are stubs that take precomputed
        embeddings), the vision cell's text cut to ``S - frontend_len``,
        and decode's one new token a sequence."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def tok(b, s):
            return torch.empty((b, s), dtype=torch.int32, device="meta")

        def emb(b, s):
            return torch.empty((b, s, cfg.d_model), dtype=torch.bfloat16,
                               device="meta")

        if shape.kind == "train":
            if cfg.encdec:
                return {"tokens": tok(B, S), "labels": tok(B, S),
                        "frames": emb(B, cfg.frontend_len)}
            if cfg.frontend == "vision":
                s_text = S - cfg.frontend_len
                return {"tokens": tok(B, s_text), "labels": tok(B, s_text),
                        "prefix_embeds": emb(B, cfg.frontend_len)}
            return {"tokens": tok(B, S), "labels": tok(B, S)}
        if shape.kind == "prefill":
            if cfg.encdec:
                return {"tokens": tok(B, S), "frames": emb(B, cfg.frontend_len)}
            if cfg.frontend == "vision":
                return {"tokens": tok(B, S - cfg.frontend_len),
                        "prefix_embeds": emb(B, cfg.frontend_len)}
            return {"tokens": tok(B, S)}
        return {"token": tok(B, 1)}

    def realize_inputs(self, shape: ShapeConfig,
                       generator: torch.Generator | None) -> dict:
        """Inputs of :meth:`input_specs`' shapes and dtypes on the model's
        device, drawn in their order from ``generator`` (a seeded
        ``torch.Generator`` on that device): ids uniform in ``[0,
        vocab_size)``, embeddings float32 normals cast to bf16.  The stream
        is not ``jax.random``'s, so the values are not the reference's for
        the same seed.  On the meta device these are the specs."""
        specs = self.input_specs(shape)
        if self.device.type == "meta":
            return specs
        out = {}
        for name, s in specs.items():
            if s.dtype == torch.int32:
                out[name] = torch.randint(0, self.cfg.vocab_size, s.shape,
                                          generator=generator,
                                          device=self.device,
                                          dtype=torch.int32)
            else:
                out[name] = torch.randn(s.shape, generator=generator,
                                        device=self.device,
                                        dtype=torch.float32).to(s.dtype)
        return out


def get_model(cfg: ModelConfig, *, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (CUDA when ``None``)."""
    return Model(cfg, resolve_device(device))
