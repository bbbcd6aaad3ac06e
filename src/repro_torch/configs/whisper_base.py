"""Whisper-base backbone: 6L enc + 6L dec, d512 8H d_ff 2048 vocab 51865,
enc-dec with the conv frontend a stub (precomputed frame embeddings);
decoder positions extended to the assigned lengths  [arXiv:2212.04356]."""
from ..config import ModelConfig, TTDConfig
from ._common import reduced_common

ARCH = "whisper-base"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="encdec", n_layers=6, n_enc_layers=6, d_model=512,
        n_heads=8, n_kv_heads=8, head_dim=64, d_ff=2048, vocab_size=51865,
        norm_type="layernorm", act="gelu_mlp", pos_type="learned",
        enc_len=1500, tie_embeddings=True, max_seq_len=32768,
        ttd=TTDConfig(enabled=True, rank=16, d=3),  # d=3: small dims
    )


def reduced() -> ModelConfig:
    return reduced_common(config(), n_layers=2, n_enc_layers=2, enc_len=16,
                          n_kv_heads=4, norm_type="layernorm", act="gelu_mlp",
                          pos_type="learned")
