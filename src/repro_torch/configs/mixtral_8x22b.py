"""Mixtral 8x22B: 56L d6144 48H (GQA kv=8) MoE 8e top-2, d_ff 16384,
vocab 32768, sliding-window attention  [arXiv:2401.04088; hf]."""
from ..config import ModelConfig
from ._common import PAPER_TTD, reduced_common

ARCH = "mixtral-8x22b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe", n_layers=56, d_model=6144, n_heads=48,
        n_kv_heads=8, head_dim=128, d_ff=16384, d_ff_expert=16384,
        n_experts=8, experts_per_token=2, vocab_size=32768,
        window=4096, rope_theta=1e6, ttd=PAPER_TTD,
    )


def reduced() -> ModelConfig:
    return reduced_common(config(), n_experts=4, experts_per_token=2,
                          d_ff_expert=32, window=16, moe_impl="dense")
