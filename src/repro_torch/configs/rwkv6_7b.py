"""RWKV6-7B "Finch" [arXiv:2404.05892] — attention-free, data-dependent decay.

64 heads of size 64 (d_model / 64); channel-mix d_ff per task sheet.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64, head_dim=64,
    d_ff=14336, vocab_size=65536,
    block_pattern=("rwkv",),
)
