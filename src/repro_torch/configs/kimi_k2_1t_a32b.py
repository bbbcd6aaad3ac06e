"""Kimi K2 — trillion-param MoE: 61L d7168 64H (GQA kv=8) MoE 384e top-8,
expert d_ff 2048, vocab 163840  [arXiv:2501.kimi2; paper-table]."""
from ..config import ModelConfig
from ._common import PAPER_TTD, reduced_common

ARCH = "kimi-k2-1t-a32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe", n_layers=61, d_model=7168, n_heads=64,
        n_kv_heads=8, head_dim=112, d_ff=2048, d_ff_expert=2048,
        n_experts=384, experts_per_token=8, vocab_size=163840,
        rope_theta=50000.0, ttd=PAPER_TTD,
    )


def reduced() -> ModelConfig:
    return reduced_common(config(), n_experts=8, experts_per_token=2,
                          d_ff_expert=32, moe_impl="dense")
