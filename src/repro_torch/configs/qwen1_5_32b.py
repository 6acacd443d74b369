"""qwen1.5-32b [dense] — QKV bias, MHA (kv=40) [hf:Qwen/Qwen1.5-0.5B; hf]:
64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064."""

from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152_064,
    qkv_bias=True,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="qwen1.5-32b",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=160,
        vocab_size=512,
        qkv_bias=True,
        param_dtype="float32",
        activation_dtype="float32",
    )
