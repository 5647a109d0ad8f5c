"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Vision frontend (anyres tiling → patch embeddings) is a STUB: input_specs()
provides ``frontend_len`` precomputed patch embeddings (base 576 + 4 tiles
× 576 = 2880) prepended to the text sequence.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    rope_theta=1e6,
    frontend="vision", frontend_len=2880,
)
