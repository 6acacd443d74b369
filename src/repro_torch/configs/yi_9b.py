"""yi-9b [dense] — llama-arch GQA [arXiv:2403.04652; hf]:
48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000."""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64_000,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="yi-9b",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=512,
        param_dtype="float32",
        activation_dtype="float32",
    )
