"""Typed serving sessions (counterpart of ``repro.models.sessions``).

Ported: the dense and MoE families' paged backend (shared block pools plus
per-slot block tables) and ring backend (per-slot K/V rings), griffin's recurrent
backend (RG-LRU state, conv tails and windowed attention rings) and rwkv's
(wkv matrices and token-shift tails).  Every
other family or backend raises the reference's ``NotImplementedError``.
``tokens``/``positions`` follow the reference's convention: rows are decode
slots, positions are per-sequence absolute indices, ``-1`` marks
padding/inactive rows.

A session declares what the engine needs to know about its state:
``uses_blocks`` (block-pool capacity accounting applies) and ``slot_axis``,
the axis of every state leaf that indexes slots (``None`` when no leaf has
one: paged pools are shared and block ownership isolates sequences).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .._device import resolve_device
from ..config import ModelConfig
from ..kernels.dispatch import check_card_support
from . import griffin, rwkv, transformer

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


class InferenceSession:
    """Base session: cfg + spec + device and the uniform step surface
    ``init_state`` / ``prefill_chunk`` / ``decode_step``.  States are updated
    in place by every step."""
    backend = "?"
    uses_blocks = False
    slot_axis: int | None = 0

    def __init__(self, cfg: ModelConfig, spec: SessionSpec, device=None):
        self.cfg = cfg
        self.spec = spec
        self.device = resolve_device(device)

    def _dtype(self):
        return CACHE_DTYPES[canonical_cache_dtype(self.spec.cache_dtype)]

    def with_tables(self, state, block_tables):
        """Swap host-packed block tables into the state (block backends)."""
        return state


class PagedKVSession(InferenceSession):
    """Shared K/V block pools + block tables (dense and MoE, full attention)."""
    backend = "paged"
    uses_blocks = True
    slot_axis = None

    def init_state(self):
        sp = self.spec
        return {
            "kv": transformer.init_paged_cache(
                self.cfg, sp.resolved_num_blocks(), sp.block_size, self._dtype(),
                device=self.device),
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


class RingKVSession(InferenceSession):
    """Per-slot K/V rings (dense and MoE; the sliding-window backend)."""
    backend = "ring"

    def init_state(self):
        sp = self.spec
        return {"kv": transformer.init_ring_cache(self.cfg, sp.slots, sp.max_len,
                                                  sp.prefill_chunk, self._dtype(),
                                                  device=self.device)}

    def prefill_chunk(self, params, state, tokens, positions, logit_cols=None):
        logits, kv = transformer.prefill_ring_chunk(params, self.cfg, state["kv"], tokens,
                                                    positions, logit_cols)
        return logits, {"kv": kv}

    def decode_step(self, params, state, tokens, positions):
        logits, kv = transformer.decode_step_ring(params, self.cfg, state["kv"], tokens,
                                                  positions)
        return logits, {"kv": kv}


class GriffinSession(InferenceSession):
    """Constant-size recurrent state: RG-LRU h + conv tails + windowed
    attention rings (griffin / recurrentgemma)."""
    backend = "recurrent"

    def init_state(self):
        sp = self.spec
        return griffin.init_session_state(self.cfg, sp.slots, sp.max_len, sp.prefill_chunk,
                                          self._dtype(), device=self.device)

    def prefill_chunk(self, params, state, tokens, positions, logit_cols=None):
        return griffin.prefill_session_chunk(params, self.cfg, state, tokens, positions,
                                             logit_cols)

    def decode_step(self, params, state, tokens, positions):
        return griffin.decode_session_step(params, self.cfg, state, tokens, positions)


class RwkvSession(InferenceSession):
    """Constant-size recurrent state: wkv matrices + token-shift tails."""
    backend = "recurrent"

    def init_state(self):
        return rwkv.init_session_state(self.cfg, self.spec.slots, self._dtype(),
                                       device=self.device)

    def prefill_chunk(self, params, state, tokens, positions, logit_cols=None):
        return rwkv.prefill_session_chunk(params, self.cfg, state, tokens, positions,
                                          logit_cols)

    def decode_step(self, params, state, tokens, positions):
        return rwkv.decode_session_step(params, self.cfg, state, tokens, positions)


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


_SESSION_TYPES: dict[tuple[str, str], type[InferenceSession]] = {
    ("dense", "paged"): PagedKVSession,
    ("dense", "ring"): RingKVSession,
    ("moe", "paged"): PagedKVSession,
    ("moe", "ring"): RingKVSession,
    ("griffin", "recurrent"): GriffinSession,
    ("rwkv", "recurrent"): RwkvSession,
}


def make_session(cfg: ModelConfig, spec: SessionSpec | None = None, *,
                 backend: str | None = None, device=None, **spec_kw) -> InferenceSession:
    """Build the typed session for a config; unsupported or not-yet-ported
    combinations raise ``NotImplementedError`` naming the family, and on a
    CUDA device a config past a hand kernel's limits raises ``ValueError``
    naming the kernel (``dispatch.check_card_support``)."""
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
    if (cfg.family, backend) not in _SESSION_TYPES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) with the {backend!r} backend is "
            "not ported to repro_torch yet; ported: "
            + ", ".join(f"{f}/{b}" for f, b in _SESSION_TYPES))
    canonical_cache_dtype(spec.cache_dtype)
    check_card_support(cfg, resolve_device(device), backend)
    return _SESSION_TYPES[cfg.family, backend](cfg, spec, device=device)
