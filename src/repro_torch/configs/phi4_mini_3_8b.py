"""Phi-4-mini 3.8B: 32L d3072 24H (GQA kv=8) d_ff 8192 vocab 200064,
RoPE SwiGLU GQA, tied embeddings  [arXiv:2412.08905; hf]."""
from ..config import ModelConfig
from ._common import PAPER_TTD, reduced_common

ARCH = "phi4-mini-3.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=32, d_model=3072, n_heads=24,
        n_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=200064,
        tie_embeddings=True, rope_theta=10000.0, ttd=PAPER_TTD,
    )


def reduced() -> ModelConfig:
    return reduced_common(config())
