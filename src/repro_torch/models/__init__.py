"""Model zoo of the port: the decoder-only LM stack on one device.

Slice 3 brings DeepSeek-V2-Lite serving (MLA attention, dense and MoE
FFNs; the MoE expert MLP through kernels B7/B8); slice 4 RWKV6-7B (the
WKV6 scan through kernel B5) and RecurrentGemma-2B (the RG-LRU scan
through kernel B6, windowed MQA attention), and GQA attention; slice 6
the full-sequence forward (``Model.forward``, attention through the
flash-attention kernel B4 under ``use_pallas``) that training runs on;
slice 12 the encoder-decoder model (``encdec``: seamless-m4t-medium) and
prefix embeddings in front of the tokens (llava-next-mistral-7b), both
frontends stubs fed precomputed embeddings, as in the reference.
"""
from .api import Model, get_model  # noqa: F401
from .param import ParamSpec, count_params, init_params  # noqa: F401
