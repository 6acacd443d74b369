"""phi3-medium-14b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219; unverified]:
40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352."""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100_352,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="phi3-medium-14b",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=192,
        vocab_size=512,
        param_dtype="float32",
        activation_dtype="float32",
    )
