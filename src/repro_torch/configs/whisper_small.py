"""whisper-small [audio] — enc-dec, conv frontend (STUB)
[arXiv:2212.04356; unverified]: 12L d_model=768 12H (kv=12) d_ff=3072
vocab=51865.  12 encoder + 12 decoder layers; the mel/conv frontend is a
stub — the encoder takes precomputed frame embeddings
(B, seq_len//2, d_model), the conv stack's 2x downsampling ratio."""

from .base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    encdec=EncDecConfig(n_encoder_layers=12),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-small",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        encdec=EncDecConfig(n_encoder_layers=2),
        param_dtype="float32",
        activation_dtype="float32",
    )
