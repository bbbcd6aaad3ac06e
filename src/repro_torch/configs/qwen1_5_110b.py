"""Qwen1.5-110B: 80L d8192 64H (GQA kv=8) d_ff 49152 vocab 152064,
QKV bias  [hf:Qwen/Qwen1.5-110B; hf]."""
from ..config import ModelConfig
from ._common import PAPER_TTD, reduced_common

ARCH = "qwen1.5-110b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=80, d_model=8192, n_heads=64,
        n_kv_heads=8, head_dim=128, d_ff=49152, vocab_size=152064,
        qkv_bias=True, rope_theta=1e6, ttd=PAPER_TTD,
    )


def reduced() -> ModelConfig:
    return reduced_common(config(), qkv_bias=True)
