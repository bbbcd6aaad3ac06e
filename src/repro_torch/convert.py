"""Param bridge from the JAX package's trees to the port's params.

``params_from_jax`` takes the tree ``repro.models.transformer.init_lm``
(dense; the paged and ring backends share it), ``repro.models.griffin.init_lm``
or ``repro.models.rwkv.init_lm`` builds, with every leaf already a numpy
array (e.g. after ``jax.device_get``), and returns the port's params on
``device``: each stacked leading layer axis (dense segments, griffin's
pattern groups, rwkv's blocks) becomes a list of per-layer (per-group)
dicts.  Lists of leaves (TT cores, a TT embedding's included) stay lists.
numpy holds bf16 leaves as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
rejects, so they cross as their uint16 bit patterns and are viewed back as
``torch.bfloat16``.  Nothing here imports JAX.
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
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # copy: arrays that come from JAX are read-only
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_jax(tree: dict[str, Any], cfg: ModelConfig, *, device=None) -> dict[str, Any]:
    """Numpy-leaved JAX param tree -> the port's params on ``device``."""
    device = resolve_device(device)
    if cfg.family == "rwkv":
        out = {k: _map(v, lambda a: _tensor(a, device))
               for k, v in tree.items() if k != "blocks"}
        out["blocks"] = [_map(tree["blocks"], lambda a, i=i: _tensor(np.asarray(a)[i], device))
                         for i in range(cfg.n_layers)]
        return out
    if cfg.family == "griffin":
        n_groups = pattern_plan(cfg)[0]
        out = {k: _map(v, lambda a: _tensor(a, device))
               for k, v in tree.items() if k != "groups"}
        if n_groups:
            out["groups"] = [_map(tree["groups"], lambda a, i=i: _tensor(np.asarray(a)[i], device))
                             for i in range(n_groups)]
        return out
    plan = segment_plan(cfg)
    if len(tree["segments"]) != len(plan):
        raise ValueError(f"tree has {len(tree['segments'])} segments, cfg plans {len(plan)}")
    out = {k: _map(v, lambda a: _tensor(a, device))
           for k, v in tree.items() if k != "segments"}
    out["segments"] = [
        [_map(seg, lambda a, i=i: _tensor(np.asarray(a)[i], device)) for i in range(n)]
        for seg, (n, _) in zip(tree["segments"], plan)]
    return out
