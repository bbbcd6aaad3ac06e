"""Param bridge between the JAX package's tree layout and the port's params.

``params_from_jax`` takes the tree ``repro.models.transformer.init_lm``
(dense; the paged and ring backends share it), ``repro.models.griffin.init_lm``
or ``repro.models.rwkv.init_lm`` builds, with every leaf already a numpy
array (e.g. after ``jax.device_get``) or a CPU tensor (a restored
checkpoint), and returns the port's params on ``device``: each stacked
leading layer axis (dense segments, griffin's pattern groups, rwkv's blocks)
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


def params_from_jax(tree: dict[str, Any], cfg: ModelConfig, *, device=None) -> dict[str, Any]:
    """Numpy-leaved JAX param tree -> the port's params on ``device``."""
    device = resolve_device(device)
    if cfg.family == "rwkv":
        out = {k: _map(v, lambda a: _tensor(a, device))
               for k, v in tree.items() if k != "blocks"}
        out["blocks"] = [_map(tree["blocks"], lambda a, i=i: _tensor(_row(a, i), device))
                         for i in range(cfg.n_layers)]
        return out
    if cfg.family == "griffin":
        n_groups = pattern_plan(cfg)[0]
        out = {k: _map(v, lambda a: _tensor(a, device))
               for k, v in tree.items() if k != "groups"}
        if n_groups:
            out["groups"] = [_map(tree["groups"], lambda a, i=i: _tensor(_row(a, i), device))
                             for i in range(n_groups)]
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
    ``device`` (the host by default): each segment, griffin's pattern groups
    and rwkv's blocks stacked along a leading layer axis, every other leaf as
    it is (moved to ``device``)."""
    stacked = {"dense": "segments", "griffin": "groups", "rwkv": "blocks"}[cfg.family]
    out = {k: _map(v, lambda t: t.to(device)) for k, v in params.items() if k != stacked}
    if cfg.family == "dense":
        out["segments"] = [_stack(seg, device) for seg in params["segments"]]
    elif stacked in params:
        out[stacked] = _stack(params[stacked], device)
    return out
