"""Model / TTD / quant / train configs: a plain-Python mirror of ``repro.config``.

The dataclasses have the same fields and defaults as the JAX package's, so
one ``config_to_dict`` dict round-trips between the two packages.  The
``kernel_backend`` field is carried for that round trip only: the port's
kernels follow the tensor's device (``repro_torch.kernels.dispatch``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping


@dataclass(frozen=True)
class TTLayerOverride:
    """Explicit per-role factorization (paper Table I rows)."""

    in_modes: tuple[int, ...]
    out_modes: tuple[int, ...]
    rank: int = 16


@dataclass(frozen=True)
class TTDConfig:
    """Which linear roles get TT-compressed and how (paper §II.D, Table I)."""

    enabled: bool = False
    rank: int = 16
    d: int = 4
    roles: tuple[str, ...] = (
        "attn_o",
        "mlp_gate",
        "mlp_up",
        "mlp_down",
        "expert_gate",
        "expert_up",
        "expert_down",
        "cm_key",
        "cm_value",
        "tm_out",
        "lru_in",
        "lru_out",
    )
    overrides: tuple[tuple[str, TTLayerOverride], ...] = ()
    first_tt_block: int = 0  # blocks [first_tt_block, n_layers) are TT'd
    embed: bool = False
    embed_rank: int = 0
    embed_d: int = 0

    def override_for(self, role: str) -> TTLayerOverride | None:
        return dict(self.overrides).get(role)


@dataclass(frozen=True)
class QuantConfig:
    """INT4 weight-only quantization (paper: Wt INT4 / Act FP16)."""

    enabled: bool = False
    bits: int = 4
    group_size: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | rwkv | griffin | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    n_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    moe_impl: str = "ep"
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    rope_theta: float = 10000.0
    window: int = 0
    qkv_bias: bool = False
    pos_type: str = "rope"
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    partial_rotary: float = 1.0
    norm_type: str = "rmsnorm"
    act: str = "swiglu"
    tie_embeddings: bool = False
    max_seq_len: int = 32768

    lru_width: int = 0
    conv_width: int = 4
    pattern: tuple[str, ...] = ()

    rwkv_head_dim: int = 64
    rwkv_lora_decay: int = 64
    rwkv_lora_mix: int = 32

    n_enc_layers: int = 0
    enc_len: int = 1500

    ttd: TTDConfig = field(default_factory=TTDConfig)
    quant: QuantConfig = field(default_factory=QuantConfig)

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    kernel_backend: str = "auto"

    q_block: int = 1024
    kv_block: int = 1024

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Training knobs, as ``repro.config.TrainConfig`` (``grad_compression``
    is carried for the round trip: it belongs to ``dist/``, not ported)."""

    global_batch: int = 256
    seq_len: int = 4096
    microbatches: int = 1  # gradient accumulation steps inside train_step
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    optimizer: str = "adamw"  # adamw | adafactor
    remat: str = "full"  # full | dots | none
    grad_compression: str = "none"
    seed: int = 0


def config_to_dict(cfg: ModelConfig) -> dict:
    """JSON-serializable form of a ``ModelConfig``."""
    return dataclasses.asdict(cfg)


def config_from_dict(d: Mapping[str, Any]) -> ModelConfig:
    """Inverse of :func:`config_to_dict`, tolerant of a JSON round trip
    (tuples come back as lists)."""
    d = dict(d)
    ttd = d.pop("ttd", None)
    quant = d.pop("quant", None)
    if isinstance(ttd, Mapping):
        t = dict(ttd)
        t["roles"] = tuple(t.get("roles", ()))
        t["overrides"] = tuple(
            (role, ov if isinstance(ov, TTLayerOverride) else TTLayerOverride(
                in_modes=tuple(ov["in_modes"]),
                out_modes=tuple(ov["out_modes"]),
                rank=ov.get("rank", 16)))
            for role, ov in (tuple(pair) for pair in t.get("overrides", ())))
        ttd = TTDConfig(**t)
    if isinstance(quant, Mapping):
        quant = QuantConfig(**quant)
    for k in ("mrope_sections", "pattern"):
        if d.get(k) is not None:
            d[k] = tuple(d[k])
    return ModelConfig(**d, ttd=ttd or TTDConfig(), quant=quant or QuantConfig())
