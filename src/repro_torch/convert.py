"""Param bridge between the JAX package's tree layout and the port's params.

``params_from_jax`` takes the tree ``repro.models.transformer.init_lm``
(dense and MoE; the paged and ring backends share it; an MoE layer's expert
leaves keep their expert axis), ``repro.models.griffin.init_lm``,
``repro.models.rwkv.init_lm`` or ``repro.models.whisper.init_lm`` builds,
with every leaf already a numpy array (e.g. after ``jax.device_get``) or a
CPU tensor (a restored checkpoint), and returns the port's params on
``device``: each stacked leading layer axis (dense segments, griffin's
pattern groups, rwkv's blocks, whisper's encoder and decoder blocks)
becomes a list of per-layer (per-group) dicts.  Lists of leaves (TT cores, a
TT embedding's included) stay lists.  ``params_to_jax`` is its inverse, the
layout a checkpoint is written in.  numpy holds bf16 leaves as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects, so they cross as
their uint16 bit patterns and are viewed back as ``torch.bfloat16``.
Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ._device import resolve_device
from .config import ModelConfig
from .models.griffin import pattern_plan
from .models.transformer import segment_plan


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True)  # its own allocation, not a view of the stack
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # copy: arrays that come from JAX are read-only
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _row(a, i):
    """Layer ``i`` of a stacked leaf (numpy array or tensor)."""
    return a[i] if isinstance(a, torch.Tensor) else np.asarray(a)[i]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _stack(layers: list, device):
    """Per-layer trees of one structure -> one tree of stacked leaves on
    ``device``, each layer moved there before it is stacked."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in layers], device) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack([t[i] for t in layers], device) for i in range(len(first))]
    return torch.stack([t.to(device) for t in layers])


def _stacked_leaves(cfg: ModelConfig) -> dict[str, int]:
    """The tree's keys whose leaves carry a leading layer axis, with its
    length (dense and MoE segments are handled apart)."""
    if cfg.family == "rwkv":
        return {"blocks": cfg.n_layers}
    if cfg.family == "griffin":
        return {"groups": pattern_plan(cfg)[0]}
    if cfg.family == "encdec":
        return {"enc_blocks": cfg.n_enc_layers, "dec_blocks": cfg.n_layers}
    return {}


def params_from_jax(tree: dict[str, Any], cfg: ModelConfig, *, device=None) -> dict[str, Any]:
    """Numpy-leaved JAX param tree -> the port's params on ``device``."""
    device = resolve_device(device)
    stacked = _stacked_leaves(cfg)
    if stacked:
        out = {k: _map(v, lambda a: _tensor(a, device))
               for k, v in tree.items() if k not in stacked}
        for k, n in stacked.items():
            if n:  # griffin with no whole pattern group has no "groups"
                out[k] = [_map(tree[k], lambda a, i=i: _tensor(_row(a, i), device))
                          for i in range(n)]
        return out
    plan = segment_plan(cfg)
    if len(tree["segments"]) != len(plan):
        raise ValueError(f"tree has {len(tree['segments'])} segments, cfg plans {len(plan)}")
    out = {k: _map(v, lambda a: _tensor(a, device))
           for k, v in tree.items() if k != "segments"}
    out["segments"] = [
        [_map(seg, lambda a, i=i: _tensor(_row(a, i), device)) for i in range(n)]
        for seg, (n, _) in zip(tree["segments"], plan)]
    return out


def params_to_jax(params: dict[str, Any], cfg: ModelConfig, *, device="cpu") -> dict[str, Any]:
    """The port's params -> the JAX package's tree layout, leaves on
    ``device`` (the host by default): each segment, griffin's pattern groups,
    rwkv's blocks and whisper's encoder and decoder blocks stacked along a
    leading layer axis, every other leaf as it is (moved to ``device``)."""
    stacked = _stacked_leaves(cfg)
    out = {k: _map(v, lambda t: t.to(device)) for k, v in params.items()
           if k not in stacked and k != "segments"}
    if cfg.family in ("dense", "moe"):
        out["segments"] = [_stack(seg, device) for seg in params["segments"]]
    for k in stacked:
        if k in params:
            out[k] = _stack(params[k], device)
    return out
