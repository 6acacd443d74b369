"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2
[arXiv:2402.19427; hf]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000.  Unit (rec, rec, attn) x8 + 2 trailing rec; local window 2048;
bounded state -> long_500k runs."""

from .base import HybridConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256_000,
    local_window=2048,
    tie_embeddings=True,
    hybrid=HybridConfig(pattern=("rec", "rec", "attn"), lru_width=2560,
                        conv_width=4),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="recurrentgemma-2b",
        family="hybrid",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=512,
        local_window=8,
        tie_embeddings=True,
        hybrid=HybridConfig(pattern=("rec", "rec", "attn"), lru_width=64,
                            conv_width=4),
        param_dtype="float32",
        activation_dtype="float32",
    )
