"""Granite-3 8B: 40L d4096 32H (GQA kv=8) d_ff 12800 vocab 49155
[hf:ibm-granite/granite-3.0-8b-base; hf]."""
from ..config import ModelConfig
from ._common import PAPER_TTD, reduced_common

ARCH = "granite-3-8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=40, d_model=4096, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=12800, vocab_size=49155,
        rope_theta=10000.0, ttd=PAPER_TTD,
    )


def reduced() -> ModelConfig:
    return reduced_common(config())
