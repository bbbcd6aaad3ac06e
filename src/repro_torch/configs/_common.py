"""Shared helpers for architecture config files."""
from __future__ import annotations

from ..config import ModelConfig, QuantConfig, TTDConfig

# Paper-recipe TTD: attn output + all MLP / expert linears, Q/K/V excluded, d=4,
# rank=16.
PAPER_TTD = TTDConfig(enabled=True, rank=16, d=4)
REDUCED_TTD = TTDConfig(enabled=True, rank=4, d=3)
INT4 = QuantConfig(enabled=True, bits=4, group_size=128)


def reduced_common(cfg: ModelConfig, **kw) -> ModelConfig:
    """Shrink a config to a CPU-test size, keeping the family's structure
    (TT path stays on, with rank 4 and power-of-two dims)."""
    base = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        max_seq_len=128,
        ttd=REDUCED_TTD,
        quant=QuantConfig(enabled=False),
        q_block=32,
        kv_block=32,
    )
    base.update(kw)
    return cfg.replace(**base)
