"""Llama-4-Scout-17B-16E [hf:meta-llama; unverified] — MoE 16e top-1 + shared.

40 heads don't divide a 16-way TP axis; with_parallelism pads to 48 q-heads
(documented compute overhead) and replicates kv 8→16.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    rope_theta=5e5,
    moe=MoEConfig(num_experts=16, num_shared_experts=1, top_k=1, d_ff=8192),
)
