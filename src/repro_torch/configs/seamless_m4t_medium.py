"""SeamlessM4T-medium [arXiv:2308.11596] — audio enc-dec backbone.

The speech frontend (conformer feature extractor) is a STUB per the task
spec: ``input_specs()`` supplies precomputed frame embeddings of length
``frontend_len`` feeding the 12-layer encoder; the 12-layer decoder consumes
text tokens with cross-attention.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="seamless-m4t-medium", family="audio",
    num_layers=12, enc_layers=12, encdec=True,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206,
    frontend="audio", frontend_len=1536,
)
