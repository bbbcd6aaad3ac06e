"""One model protocol over every family (counterpart of ``repro.models.api``).

:class:`Model` is the functional protocol ``init`` / ``forward`` /
``head_weight`` plus the single-sequence ``init_cache`` / ``prefill`` /
``decode_step`` path: one request at a time, the reference the serving
engine is held against.  The typed serving surface is
``models.sessions.make_session``, which the ``Engine`` consumes.

``batch`` convention:
  {"tokens": (B, S) int}                                LM families
  {"tokens": ..., "positions": (3, B, S) int}           M-RoPE (qwen2-vl)
  {"tokens": ..., "enc_frames": (B, T_enc, D)}          enc-dec (whisper)
Decode batches carry tokens (B, 1) and a ``pos`` the batch shares (a Python
int or a device tensor).  ``init`` takes a seed or a ``torch.Generator`` and
a device; ``init`` and ``init_cache`` run on the card unless the caller
passes ``device="cpu"``, and raise when there is no card.  On a CUDA device
``init`` (and ``build_model`` handed one) refuses, through
``dispatch.check_card_support``'s ``"solo"`` backend, a config past a hand
kernel's limit.  Caches are updated in place by ``decode_step`` (rwkv's,
whose state is O(1), is replaced) and returned.
"""
from __future__ import annotations

import warnings
from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

import torch

from .._device import resolve_device
from ..config import ModelConfig
from ..kernels import dispatch
from . import griffin, rwkv, transformer, whisper

SOLO_BACKEND = "solo"


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]  # (seed=0, *, generator=None, device=None) -> params
    forward: Callable[..., tuple[torch.Tensor, torch.Tensor]]  # (params, batch, remat) -> (hidden, aux)
    head_weight: Callable[[Any], torch.Tensor]  # (params) -> (D, V)
    init_cache: Callable[..., Any]
    prefill: Callable[..., tuple[torch.Tensor, Any]]
    decode_step: Callable[..., tuple[torch.Tensor, Any]]


def _init_fn(mod, cfg: ModelConfig):
    def init(seed: int = 0, *, generator: torch.Generator | None = None, device=None):
        device = resolve_device(device)
        dispatch.check_card_support(cfg, device, SOLO_BACKEND)
        return mod.init_lm(cfg, seed=seed, generator=generator, device=device)
    return init


def _cache_fn(mod, cfg: ModelConfig):
    def init_cache(batch: int, max_len: int, dtype=torch.bfloat16, *, device=None):
        return mod.init_cache(cfg, batch, max_len, dtype, device=device)
    return init_cache


def _lm_adapter(mod, cfg: ModelConfig) -> Model:
    def forward(params, batch, remat="none"):
        return mod.forward(params, cfg, batch["tokens"], positions=batch.get("positions"),
                           remat=remat)

    def prefill_fn(params, batch, cache_dtype=torch.bfloat16, max_len=None):
        return mod.prefill(params, cfg, batch["tokens"], positions=batch.get("positions"),
                           cache_dtype=cache_dtype, max_len=max_len)

    def decode_fn(params, cache, batch, pos):
        return mod.decode_step(params, cfg, cache, batch["tokens"], pos,
                               positions=batch.get("positions"))

    return Model(cfg=cfg, init=_init_fn(mod, cfg), forward=forward,
                 head_weight=lambda params: mod.head_weight(params, cfg),
                 init_cache=_cache_fn(mod, cfg), prefill=prefill_fn, decode_step=decode_fn)


def _whisper_adapter(cfg: ModelConfig) -> Model:
    def forward(params, batch, remat="none"):
        return whisper.forward(params, cfg, batch["tokens"], remat=remat,
                               enc_frames=batch.get("enc_frames"))

    def prefill_fn(params, batch, cache_dtype=torch.bfloat16, max_len=None):
        return whisper.prefill(params, cfg, batch["tokens"], cache_dtype=cache_dtype,
                               max_len=max_len, enc_frames=batch.get("enc_frames"))

    def decode_fn(params, cache, batch, pos):
        return whisper.decode_step(params, cfg, cache, batch["tokens"], pos)

    return Model(cfg=cfg, init=_init_fn(whisper, cfg), forward=forward,
                 head_weight=lambda params: whisper.head_weight(params, cfg),
                 init_cache=_cache_fn(whisper, cfg), prefill=prefill_fn,
                 decode_step=decode_fn)


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The Model of ``cfg``'s family.  Handed a CUDA ``device``, it first
    refuses a config past a hand kernel's limit (``check_card_support``;
    naming the device needs no card)."""
    if device is not None:
        dispatch.check_card_support(cfg, torch.device(device), SOLO_BACKEND)
    fam = cfg.family
    if fam in ("dense", "moe"):
        return _lm_adapter(transformer, cfg)
    if fam == "rwkv":
        return _lm_adapter(rwkv, cfg)
    if fam == "griffin":
        return _lm_adapter(griffin, cfg)
    if fam == "encdec":
        return _whisper_adapter(cfg)
    raise ValueError(f"unknown family {fam}")


def get_model(cfg: ModelConfig) -> Model:
    """Deprecated alias of :func:`build_model`; serving callers go through
    :func:`repro_torch.models.sessions.make_session`."""
    warnings.warn("get_model() is deprecated: use build_model() (train/eval) "
                  "or models.sessions.make_session() (serving)",
                  DeprecationWarning, stacklevel=2)
    return build_model(cfg)
