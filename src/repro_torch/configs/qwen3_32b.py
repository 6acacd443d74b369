"""qwen3-32b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]:
64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936."""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151_936,
    qk_norm=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen3-32b",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=512,
        qk_norm=True,
        param_dtype="float32",
        activation_dtype="float32",
    )
