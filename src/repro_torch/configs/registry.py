"""Assigned architecture registry: ``get_config(arch_id)`` / ``--arch <id>``."""
from __future__ import annotations

from .base import MLAConfig, ModelConfig, MoEConfig, SHAPES, ShapeConfig
from . import (qwen2_0_5b, qwen1_5_0_5b, qwen3_32b, qwen1_5_4b,
               seamless_m4t_medium, llama4_scout_17b_a16e, deepseek_v2_lite_16b,
               llava_next_mistral_7b, rwkv6_7b, recurrentgemma_2b)

_MODULES = {
    "qwen2-0.5b": qwen2_0_5b,
    "qwen1.5-0.5b": qwen1_5_0_5b,
    "qwen3-32b": qwen3_32b,
    "qwen1.5-4b": qwen1_5_4b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "rwkv6-7b": rwkv6_7b,
    "recurrentgemma-2b": recurrentgemma_2b,
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    return _MODULES[arch_id].CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_cells():
    """All 40 (arch, shape) cells with applicability verdicts."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = s.applicable(cfg)
            out.append((a, s.name, ok, why))
    return out
