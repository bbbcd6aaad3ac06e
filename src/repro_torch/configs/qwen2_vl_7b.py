"""Qwen2-VL 7B backbone: 28L d3584 28H (GQA kv=4) d_ff 18944 vocab 152064,
M-RoPE  [arXiv:2409.12191; hf].  The paged and ring serving backends refuse
M-RoPE (as the JAX package's do); the config is registered for compression
and its accounting."""
from ..config import ModelConfig
from ._common import PAPER_TTD, reduced_common

ARCH = "qwen2-vl-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=28, d_model=3584, n_heads=28,
        n_kv_heads=4, head_dim=128, d_ff=18944, vocab_size=152064,
        pos_type="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
        ttd=PAPER_TTD,
    )


def reduced() -> ModelConfig:
    return reduced_common(config(), pos_type="mrope", mrope_sections=(2, 3, 3))
