"""Config system: model architecture + input shapes + parallelism knobs.

A copy of ``repro.configs.base`` (framework-free data), kept field for
field so that a configuration means the same in both packages.  ``mesh``
stays ``None`` off a mesh; the launch cells set it to a ``DeviceMesh``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0           # routed experts
    num_shared_experts: int = 0
    top_k: int = 1
    d_ff: int = 0                  # per-expert hidden size
    first_dense_layers: int = 0    # leading dense layers (deepseek style)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False

    moe: MoEConfig | None = None
    mla: MLAConfig | None = None

    # hybrid / ssm
    block_pattern: tuple[str, ...] = ("attn",)   # repeat unit, e.g. ("rglru","rglru","attn")
    window: int = 0                # local-attention window (0 = full)
    rnn_width: int = 0             # RG-LRU recurrent width (0 = d_model)
    conv_width: int = 4            # RG-LRU temporal conv

    # encoder-decoder
    encdec: bool = False
    enc_layers: int = 0

    # modality frontend stub: number of prefix embeddings prepended to text
    frontend: str | None = None    # None | "audio" | "vision"
    frontend_len: int = 0

    # numerics / execution
    use_scan: bool = True
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots (save matmul outputs)
    use_pallas: bool = False       # Mosaic kernels on real TPU; pure-JAX otherwise
    attn_chunk: int = 2048         # KV-chunked flash-style attention block
    wkv_chunk: int = 32            # RWKV6 chunk length (quadratic-in-chunk form)
    rglru_chunk: int = 512         # RG-LRU chunked associative-scan block
    mesh: object = None            # device mesh for activation constraints (set by launch)
    sp: bool = True                # sequence-parallel boundary activations
    moe_impl: str = "auto"         # auto | shardmap | scatter (perf A/B knob)
    tp_impl: str = "gspmd"         # gspmd | shardmap (explicit reduce-scatter)
    fused_ce: bool = False         # chunked-vocab CE (never materialise logits)
    ce_chunk: int = 16384          # vocab chunk for fused CE
    dp_only: bool = False          # pure data-parallel: fold "model" into DP
                                   # (small models where TP collectives dominate)

    # parallelism-time padding (filled by with_parallelism)
    tp_size: int = 1
    padded_heads: int = 0
    kv_repeat: int = 1
    padded_vocab: int = 0

    def __post_init__(self):
        if self.padded_heads == 0:
            object.__setattr__(self, "padded_heads", self.num_heads)
        if self.padded_vocab == 0:
            object.__setattr__(self, "padded_vocab", self.vocab_size)
        if self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)

    # ------------------------------------------------------------------
    def with_parallelism(self, tp_size: int) -> "ModelConfig":
        """Finalise TP-dependent padding/replication decisions.

        - vocab padded to a multiple of tp_size (e.g. seamless 256206→256256);
        - if heads don't divide tp and attention is large, pad head count
          (llama4 40→48 at tp=16); small models just replicate attention;
        - kv heads replicated up to tp when tp % kv == 0 (standard TP-GQA
          kv-replication) so the KV cache shards cleanly.
        """
        v = self.vocab_size
        padded_vocab = ((v + tp_size - 1) // tp_size) * tp_size
        heads = self.num_heads
        padded_heads = heads
        kv_repeat = 1
        if tp_size > 1:
            attn_params = self.d_model * heads * self.head_dim
            if heads % tp_size != 0 and attn_params >= 2 ** 24:  # >= ~16M weights
                padded_heads = ((heads + tp_size - 1) // tp_size) * tp_size
            if padded_heads % tp_size == 0:
                kv = self.num_kv_heads
                if kv < tp_size and tp_size % kv == 0:
                    kv_repeat = tp_size // kv
        return replace(self, tp_size=tp_size, padded_vocab=padded_vocab,
                       padded_heads=padded_heads, kv_repeat=kv_repeat)

    @property
    def kv_heads_effective(self) -> int:
        return self.num_kv_heads * self.kv_repeat

    @property
    def repeat_unit(self) -> int:
        """Layers per scan step (hybrid patterns scan whole repeat units)."""
        return len(self.block_pattern)

    @property
    def num_units(self) -> int:
        """Whole repeat units covered by the layer scan."""
        return self.num_layers // self.repeat_unit

    @property
    def remainder_layers(self) -> int:
        """Trailing layers outside the scan (e.g. recurrentgemma's 26 % 3 = 2)."""
        return self.num_layers % self.repeat_unit

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        changes: dict = dict(
            num_layers=2 * self.repeat_unit,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            window=min(self.window, 16) if self.window else 0,
            rnn_width=64 if self.rnn_width else 0,
            frontend_len=min(self.frontend_len, 8) if self.frontend_len else 0,
            attn_chunk=32, wkv_chunk=8, rglru_chunk=16,
            tp_size=1, padded_heads=0, kv_repeat=1, padded_vocab=0, mesh=None,
        )
        if self.encdec:
            changes["enc_layers"] = 2
        if self.moe is not None:
            changes["moe"] = replace(
                self.moe, num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2), d_ff=64,
                first_dense_layers=min(self.moe.first_dense_layers, 1))
        changes.update(overrides)
        return replace(self, **changes)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    def applicable(self, cfg: ModelConfig) -> tuple[bool, str]:
        if self.name == "long_500k":
            subquad = cfg.family in ("ssm", "hybrid")
            if not subquad:
                return False, ("long_500k requires sub-quadratic attention; "
                               f"{cfg.arch_id} is pure full-attention (skip per task spec)")
        return True, ""


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters + distributed-execution knobs."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    grad_accum: int = 1            # microbatches per step
    master_weights: bool = True    # fp32 master copy (ZeRO-1 sharded)
    zero1: bool = True             # shard optimizer state over data axis
    grad_compression: bool = False # int8 all-reduce with error feedback
    seed: int = 0
