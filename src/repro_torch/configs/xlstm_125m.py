"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]:
12L d_model=768 4H d_ff=0 vocab=50304.  d_ff=0: xLSTM blocks carry their own
internal up-projections (mLSTM pf=2.0, sLSTM post-FFN pf=4/3).
Alternating (mlstm, slstm) units; attention-free -> long_500k runs."""

from .base import HybridConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    tie_embeddings=True,
    hybrid=HybridConfig(pattern=("mlstm", "slstm"), chunk_size=256),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="xlstm-125m",
        family="ssm",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=512,
        tie_embeddings=True,
        hybrid=HybridConfig(pattern=("mlstm", "slstm"), chunk_size=16),
        param_dtype="float32",
        activation_dtype="float32",
    )
