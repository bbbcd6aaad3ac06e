"""Typed serving session (counterpart of ``repro.models.sessions``).

Only the paged K/V backend of the dense family is ported: shared block pools
plus per-slot block tables.  Every other family or backend raises the
reference's ``NotImplementedError``.  ``tokens``/``positions`` follow the
reference's convention: rows are decode slots, positions are per-sequence
absolute indices, ``-1`` marks padding/inactive rows.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .._device import resolve_device
from ..config import ModelConfig
from . import transformer

CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int8": torch.int8}


def canonical_cache_dtype(dtype) -> str:
    """Normalize a cache dtype (str or torch dtype) to its name."""
    if isinstance(dtype, str):
        if dtype not in CACHE_DTYPES:
            raise ValueError(f"unknown cache dtype {dtype!r}")
        return dtype
    for name, d in CACHE_DTYPES.items():
        if d == dtype:
            return name
    raise ValueError(f"unknown cache dtype {dtype!r}")


@dataclass(frozen=True)
class SessionSpec:
    """Static geometry of one serving session (same fields as the reference)."""
    slots: int
    max_len: int
    prefill_chunk: int = 32
    block_size: int = 16
    num_blocks: int | None = None
    cache_dtype: str = "float32"

    def resolved_num_blocks(self) -> int:
        from ..serve.kv_cache import blocks_for
        if self.num_blocks is not None:
            return self.num_blocks
        return 1 + self.slots * blocks_for(self.max_len, self.block_size)

    def table_width(self) -> int:
        from ..serve.kv_cache import blocks_for
        return blocks_for(self.max_len, self.block_size)


class PagedKVSession:
    """Shared K/V block pools + block tables (dense, full attention).  The
    pools in ``state["kv"]`` are updated in place by every step."""

    def __init__(self, cfg: ModelConfig, spec: SessionSpec, device=None):
        self.cfg = cfg
        self.spec = spec
        self.device = resolve_device(device)

    def init_state(self):
        sp = self.spec
        return {
            "kv": transformer.init_paged_cache(
                self.cfg, sp.resolved_num_blocks(), sp.block_size,
                CACHE_DTYPES[canonical_cache_dtype(sp.cache_dtype)], device=self.device),
            "block_tables": torch.zeros((sp.slots, sp.table_width()), dtype=torch.int32,
                                        device=self.device),
        }

    def prefill_chunk(self, params, state, tokens, positions, logit_cols=None):
        """tokens (B, C), positions (B, C) -> (logits (B, C, V) f32, state);
        logits (B, V) at column ``logit_cols[b]`` of each row when given."""
        logits, kv = transformer.prefill_paged_chunk(
            params, self.cfg, state["kv"], tokens, state["block_tables"], positions,
            logit_cols)
        return logits, dict(state, kv=kv)

    def decode_step(self, params, state, tokens, positions):
        """tokens (B, 1), positions (B,) -> (logits (B, V) f32, state)."""
        logits, kv = transformer.decode_step_paged(
            params, self.cfg, state["kv"], tokens, state["block_tables"], positions)
        return logits, dict(state, kv=kv)

    def with_tables(self, state, block_tables):
        """Swap host-packed (slots, W) block tables into the state."""
        bt = torch.as_tensor(block_tables, dtype=torch.int32).to(self.device)
        return dict(state, block_tables=bt)


FAMILY_BACKENDS: dict[str, tuple[str, ...]] = {
    "dense": ("paged", "ring"),
    "moe": ("paged", "ring"),
    "griffin": ("recurrent",),
    "rwkv": ("recurrent",),
    "encdec": ("encdec",),
}


def default_backend(cfg: ModelConfig) -> str:
    if cfg.family in ("dense", "moe"):
        return "ring" if cfg.window else "paged"
    if cfg.family in ("griffin", "rwkv"):
        return "recurrent"
    if cfg.family == "encdec":
        return "encdec"
    raise ValueError(f"unknown family {cfg.family!r}")


def make_session(cfg: ModelConfig, spec: SessionSpec | None = None, *,
                 backend: str | None = None, device=None, **spec_kw) -> PagedKVSession:
    """Build the typed session for a config; unsupported or not-yet-ported
    combinations raise ``NotImplementedError`` naming the family."""
    if spec is None:
        spec = SessionSpec(**spec_kw)
    allowed = FAMILY_BACKENDS.get(cfg.family)
    if allowed is None:
        raise ValueError(f"unknown family {cfg.family!r}")
    backend = backend or default_backend(cfg)
    if backend not in allowed:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) has no {backend!r} state "
            f"backend; available: {', '.join(allowed)}")
    if backend == "paged" and cfg.window:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) uses sliding-window "
            f"attention (window={cfg.window}); the paged backend assumes "
            "full attention — use the 'ring' backend")
    if backend in ("paged", "ring") and cfg.pos_type not in ("rope", "none"):
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) has pos_type "
            f"{cfg.pos_type!r}; the {backend!r} backend supports rope|none")
    if (cfg.family, backend) != ("dense", "paged"):
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) with the {backend!r} backend is "
            "not ported to repro_torch yet; ported: dense/paged")
    canonical_cache_dtype(spec.cache_dtype)
    return PagedKVSession(cfg, spec, device=device)
