"""Model zoo of the port: the decoder-only LM stack on one device.

Slice 3 brings DeepSeek-V2-Lite serving (MLA attention, dense and MoE
FFNs; the MoE expert MLP through kernels B7/B8).
"""
from .api import Model, get_model  # noqa: F401
from .param import ParamSpec, count_params, init_params  # noqa: F401
