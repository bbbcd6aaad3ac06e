"""LLaMA2-7B — the paper's own benchmark (Table I): 32L d4096 32H MHA
d_ff 11008 vocab 32000; TTD on LinearO + MLP with the paper's exact
factorizations, 19 of 32 blocks compressed."""
from ..config import ModelConfig, TTDConfig, TTLayerOverride
from ._common import reduced_common

ARCH = "llama2-7b"

TT_OVERRIDES = (
    ("attn_o", TTLayerOverride(in_modes=(16, 8, 8, 4), out_modes=(4, 8, 8, 16), rank=16)),
    ("mlp_gate", TTLayerOverride(in_modes=(16, 8, 8, 4), out_modes=(4, 4, 16, 43), rank=16)),
    ("mlp_up", TTLayerOverride(in_modes=(16, 8, 8, 4), out_modes=(4, 4, 16, 43), rank=16)),
    ("mlp_down", TTLayerOverride(in_modes=(43, 16, 4, 4), out_modes=(4, 8, 8, 16), rank=16)),
)


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=32, head_dim=128, d_ff=11008, vocab_size=32000,
        ttd=TTDConfig(enabled=True, rank=16, d=4, overrides=TT_OVERRIDES,
                      first_tt_block=13),  # blocks 13..31 TT'd (19 of 32)
    )


def reduced() -> ModelConfig:
    return reduced_common(config())
