"""kimi-k2-1t-a32b [moe] — Kimi K2 trillion-param MoE (paper-table)
[arXiv:2501.kimi2; unverified]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 (+1 shared expert, first layer dense)."""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163_840,
    moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048,
                  n_shared_experts=1, first_k_dense=1),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="kimi-k2-1t-a32b",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=96,
                      n_shared_experts=1, first_k_dense=1,
                      capacity_factor=4.0),
        param_dtype="float32",
        activation_dtype="float32",
    )
