"""Model configuration dataclasses: a copy of ``repro/configs/base.py``.

One :class:`ModelConfig` per ported architecture lives in
``repro_torch/configs/<arch>.py``, with the reference's values; every
config also provides a ``smoke()`` reduction of the same family for CPU
tests.  ``ShapeConfig`` / ``LM_SHAPES`` size the co-simulated training
step (:mod:`repro_torch.cosim`); ``RunConfig`` holds a training launch's
hyperparameters (:mod:`repro_torch.train`), every field with the
reference's default.  The port has no mesh yet (ROADMAP.md queue 1), so
its sharding knobs have no effect, as in the reference without a mesh;
of the rest the trainer reads the optimizer's fields, ``remat``,
``microbatches``, ``grad_compression``, the schedule's steps and
``seed``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden size
    n_shared_experts: int = 0      # always-active shared experts (DeepSeek/Kimi)
    first_k_dense: int = 0         # leading dense layers (Kimi: 1)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int
    # encoder frames come from the modality stub at d_model width
    encoder_bidirectional: bool = True


@dataclass(frozen=True)
class VLMConfig:
    # anyres tiling stub: patch embeddings are precomputed (frontend stub)
    n_image_tokens: int = 1024
    image_token_dtype: str = "bfloat16"


@dataclass(frozen=True)
class HybridConfig:
    """Block pattern for SSM/hybrid stacks.

    ``pattern`` is the repeating unit, e.g. ("rec", "rec", "attn") for
    RecurrentGemma (1 local-attn : 2 RG-LRU), or ("mlstm", "slstm") for
    alternating xLSTM.  ``n_layers`` need not be a multiple of the unit;
    the trailing remainder is taken from the unit prefix.
    """

    pattern: tuple[str, ...]
    lru_width: int | None = None       # RG-LRU recurrent width (None = d_model)
    conv_width: int = 4                # temporal conv in recurrent block
    mlstm_proj_factor: float = 2.0     # xLSTM mLSTM up-projection
    slstm_proj_factor: float = 4.0 / 3.0
    chunk_size: int = 256              # chunkwise-parallel scan chunk


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                    # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention flavor
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # SWA window (tokens), None = full
    local_window: int = 2048               # hybrid local-attention window
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # sub-configs
    moe: Optional[MoEConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # numerics
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    logits_dtype: str = "float32"

    def __post_init__(self):
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.family == "moe" and self.moe is None:
            raise ValueError("moe family requires MoEConfig")
        if self.family == "audio" and self.encdec is None:
            raise ValueError("audio family requires EncDecConfig")
        if self.family in ("ssm", "hybrid") and self.hybrid is None:
            raise ValueError(f"{self.family} family requires HybridConfig")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm" and self.hybrid is not None and \
            all(k in ("mlstm", "slstm", "rec") for k in self.hybrid.pattern)

    @property
    def subquadratic(self) -> bool:
        """Can this arch run ``long_500k`` (bounded decode state)?"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---------------------------------------------------------- params ----

    def param_count(self) -> int:
        """Total parameters N (analytic; used for MODEL_FLOPS = 6*N*D)."""
        from ..models.registry import get_model
        return get_model(self, device="meta").param_count()

    def active_param_count(self) -> int:
        """Parameters one token reads (MoE: the routed experts count
        ``top_k / n_experts``); the co-simulator's 6ND compute term."""
        from ..models.registry import get_model
        return get_model(self, device="meta").active_param_count()


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per-architecture shape set)."""

    shape_id: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


LM_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class RunConfig:
    """Distribution / training hyperparameters for a launch."""

    arch: str = "yi-9b"
    shape: str = "train_4k"
    multi_pod: bool = False
    # sharding knobs (no effect without a mesh)
    fsdp_params: bool = True           # ZeRO-3 param sharding on data axis
    fsdp_pod: bool = False             # extend ZeRO over the pod (DCN) axis
    sequence_parallel: bool = False    # shard activations' seq dim on model
    remat: str = "none"                # none | full | dots
    microbatches: int = 1              # gradient accumulation
    ep_moe: bool = True                # expert-parallel MoE via shard_map A2A
    moe_tp_f: bool = False             # few-expert MoE: f-sharded experts
    moe_weight_stationary: bool = False  # shard expert FFN dim over fsdp
    grad_compression: str = "none"     # none | int8_ef (cross-pod axis)
    decomposed_allreduce: bool = False # RS+AG instead of AR (plane analogue)
    # optimizer
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1000
    adam_dtype: str = "float32"        # bf16 for the 1T config to fit HBM
    master_weights: bool = False
    seed: int = 0
