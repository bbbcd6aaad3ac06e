"""Checkpoints in ``repro.checkpoint.store``'s on-disk format.

Layout:  <dir>/step_<k>/
           manifest.json           step, extra, and each leaf's shape and dtype
           shard_0.npz             leaf name (``/`` written as ``::``) -> array
           COMMIT                  written last: a checkpoint without it is
                                   never visible to ``latest_step``

Leaf names are the tree's paths joined by ``/``, dict keys in sorted order
and list items by index, as ``jax.tree_util.tree_flatten_with_path`` gives
them, so either package reads what the other wrote.  npz has no bfloat16: a
bf16 leaf is stored as raw 2-byte voids under the manifest dtype
``"bfloat16"`` and read back through its uint16 bit pattern.  Leaves are
tensors; a restored tree holds CPU tensors.  The reference's
``AsyncCheckpointer`` (training) is not ported yet.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

_SEP = "/"


def _flatten_with_paths(tree) -> list[tuple[str, Any]]:
    """(name, leaf) pairs in the order and with the names JAX gives a tree
    of dicts and lists (``None`` is an empty subtree)."""
    out: list[tuple[str, Any]] = []

    def walk(t, keys):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], keys + [str(k)])
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, keys + [str(i)])
        elif t is not None:
            out.append((_SEP.join(keys), t))

    walk(tree, [])
    return out


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor's host array as npz stores it, and its manifest dtype."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if str(a.dtype) != dtype:
        raise ValueError(f"npz leaf is {a.dtype}, the manifest says {dtype}")
    return torch.from_numpy(a.copy())


def save_checkpoint(ckpt_dir: str | Path, step: int, tree, *, extra: dict | None = None,
                    keep: int = 3) -> Path:
    """Write a checkpoint of a tree of tensors synchronously; returns its
    directory.  Keeps the newest ``keep`` committed steps."""
    ckpt_dir = Path(ckpt_dir)
    out = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    arrays = {}
    for name, leaf in _flatten_with_paths(tree):
        arr, dtype = _to_numpy(leaf)
        arrays[name.replace("/", "::")] = arr
        manifest["leaves"][name] = {"shape": list(arr.shape), "dtype": dtype}
    np.savez(tmp / "shard_0.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "COMMIT").write_text("ok")
    if out.exists():
        shutil.rmtree(out)
    tmp.rename(out)
    _gc(ckpt_dir, keep)
    return out


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(p for p in ckpt_dir.glob("step_*") if (p / "COMMIT").exists())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                   if (p / "COMMIT").exists())
    return steps[-1] if steps else None


def _rebuild(target, leaves):
    """``target``'s structure with its leaves replaced, in flatten order."""
    if isinstance(target, dict):
        return {k: _rebuild(target[k], leaves) for k in sorted(target)}
    if isinstance(target, (list, tuple)):
        return [_rebuild(v, leaves) for v in target]
    return None if target is None else next(leaves)


def restore_checkpoint(ckpt_dir: str | Path, step: int, target_tree) -> tuple[Any, dict]:
    """Restore into the structure of ``target_tree`` (its leaves' values are
    ignored: meta tensors do); returns (tree of CPU tensors, extra)."""
    path = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    names = [n for n, _ in _flatten_with_paths(target_tree)]
    with np.load(path / "shard_0.npz") as z:
        stored = {k.replace("::", "/") for k in z.files}
        missing = [n for n in names if n not in stored]
        if missing:
            raise KeyError(f"checkpoint missing leaves: {missing[:5]} …")
        leaves = [_from_numpy(z[n.replace("/", "::")], manifest["leaves"][n]["dtype"])
                  for n in names]
    return _rebuild(target_tree, iter(leaves)), manifest["extra"]
