"""TinyLlama 1.1B: 22L d2048 32H (GQA kv=4) d_ff 5632 vocab 32000
[arXiv:2401.02385; hf]."""
from ..config import ModelConfig
from ._common import PAPER_TTD, reduced_common

ARCH = "tinyllama-1.1b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=22, d_model=2048, n_heads=32,
        n_kv_heads=4, head_dim=64, d_ff=5632, vocab_size=32000,
        rope_theta=10000.0, ttd=PAPER_TTD,
    )


def reduced() -> ModelConfig:
    return reduced_common(config())
