"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768.  SWA makes ``long_500k`` runnable (window KV cache)."""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32_768,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=16384),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="mixtral-8x22b",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        sliding_window=8,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=128,
                      capacity_factor=4.0),
        param_dtype="float32",
        activation_dtype="float32",
    )
