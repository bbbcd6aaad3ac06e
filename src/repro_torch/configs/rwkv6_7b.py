"""RWKV6 "Finch" 7B: 32L d4096 attention-free, d_ff 14336, vocab 65536,
data-dependent decay  [arXiv:2404.05892; hf]."""
from ..config import ModelConfig
from ._common import PAPER_TTD, reduced_common

ARCH = "rwkv6-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="rwkv", n_layers=32, d_model=4096, n_heads=64,
        n_kv_heads=64, head_dim=64, d_ff=14336, vocab_size=65536,
        rwkv_head_dim=64, ttd=PAPER_TTD,
    )


def reduced() -> ModelConfig:
    return reduced_common(config(), n_heads=4, n_kv_heads=4, head_dim=16,
                          rwkv_head_dim=16, rwkv_lora_mix=8, rwkv_lora_decay=8)
