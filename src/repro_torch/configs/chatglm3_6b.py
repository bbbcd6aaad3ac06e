"""ChatGLM3-6B — the paper's own benchmark (Table I): 28L d4096 32H
(multi-query kv=2) d_ff 13696 vocab 65024; TTD on LinearO + MLP with the
paper's exact factorizations, 15 of 28 blocks compressed."""
from ..config import ModelConfig, TTDConfig, TTLayerOverride
from ._common import reduced_common

ARCH = "chatglm3-6b"

TT_OVERRIDES = (
    ("attn_o", TTLayerOverride(in_modes=(16, 8, 8, 4), out_modes=(4, 8, 8, 16), rank=16)),
    ("mlp_gate", TTLayerOverride(in_modes=(8, 8, 8, 8), out_modes=(4, 4, 8, 107), rank=16)),
    ("mlp_up", TTLayerOverride(in_modes=(8, 8, 8, 8), out_modes=(4, 4, 8, 107), rank=16)),
    ("mlp_down", TTLayerOverride(in_modes=(107, 8, 4, 4), out_modes=(8, 8, 8, 8), rank=16)),
)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=28, d_model=4096, n_heads=32,
        n_kv_heads=2, head_dim=128, d_ff=13696, vocab_size=65024,
        qkv_bias=True, partial_rotary=0.5,
        ttd=TTDConfig(enabled=True, rank=16, d=4, overrides=TT_OVERRIDES,
                      first_tt_block=13),  # blocks 13..27 TT'd (15 of 28)
    )


def reduced() -> ModelConfig:
    return reduced_common(config(), qkv_bias=True, partial_rotary=0.5)
