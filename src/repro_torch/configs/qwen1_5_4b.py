"""Qwen1.5-4B [hf:Qwen/Qwen1.5-4B] — dense, QKV bias, 20 heads (kv=20)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20, head_dim=128,
    d_ff=6912, vocab_size=151936,
    qkv_bias=True, rope_theta=5e6,
    # 20 heads don't shard over 16-way TP (attention replicated); bound the
    # per-microbatch score transients with a small KV chunk.
    attn_chunk=512,
)
