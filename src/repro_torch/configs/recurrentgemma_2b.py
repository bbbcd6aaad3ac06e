"""RecurrentGemma-2B (Griffin): 26L d2560 10H (MQA kv=1, hd 256) GeGLU
d_ff 7680, vocab 256000, RG-LRU + local attention (window 2048), pattern
(rec, rec, attn)  [arXiv:2402.19427; hf]."""
from ..config import ModelConfig, TTDConfig
from ._common import reduced_common

# TT on the MLP and attn-O (the parameter mass); the RG-LRU in/out
# projections stay dense (int4 in the serving config).
GRIFFIN_TTD = TTDConfig(enabled=True, rank=16, d=4,
                        roles=("attn_o", "mlp_gate", "mlp_up", "mlp_down"))

ARCH = "recurrentgemma-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="griffin", n_layers=26, d_model=2560, n_heads=10,
        n_kv_heads=1, head_dim=256, d_ff=7680, vocab_size=256000,
        act="geglu", window=2048, lru_width=2560, conv_width=4,
        pattern=("rec", "rec", "attn"), tie_embeddings=True,
        rope_theta=10000.0, ttd=GRIFFIN_TTD,
    )


def reduced() -> ModelConfig:
    return reduced_common(config(), n_layers=4, n_heads=2, n_kv_heads=1,
                          head_dim=32, lru_width=64, window=16,
                          pattern=("rec", "rec", "attn"), act="geglu")
