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
tensors; a restored tree holds CPU tensors.

A node with ``checkpoint_tree(device)`` and ``from_checkpoint_tree(tree)``
(``train.step.TrainState``) stands in for the reference's pytree
registration of its ``TrainState``: ``save_checkpoint``,
``restore_checkpoint`` and ``host_snapshot`` flatten it through those two
methods, as ``jax.tree_util`` flattens a registered node through its
flatten and unflatten functions, so the store needs no knowledge of the
layout and a training state reads and writes the reference's leaf names.
``AsyncCheckpointer`` (training) snapshots a tree
to the host before it returns and writes it on one background thread.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..tree import flatten_with_paths as _flatten_with_paths
from ..tree import unflatten as _unflatten


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
    if hasattr(tree, "checkpoint_tree"):
        tree = tree.checkpoint_tree("cpu")
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


def restore_checkpoint(ckpt_dir: str | Path, step: int, target_tree) -> tuple[Any, dict]:
    """Restore into the structure of ``target_tree`` (its leaves' values are
    ignored: meta tensors do); returns (tree of CPU tensors, extra)."""
    path = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    node = target_tree if hasattr(target_tree, "checkpoint_tree") else None
    if node is not None:
        target_tree = node.checkpoint_tree("meta")
    names = [n for n, _ in _flatten_with_paths(target_tree)]
    with np.load(path / "shard_0.npz") as z:
        stored = {k.replace("::", "/") for k in z.files}
        missing = [n for n in names if n not in stored]
        if missing:
            raise KeyError(f"checkpoint missing leaves: {missing[:5]} …")
        leaves = [_from_numpy(z[n.replace("/", "::")], manifest["leaves"][n]["dtype"])
                  for n in names]
    tree = _unflatten(target_tree, leaves)
    return (tree if node is None else node.from_checkpoint_tree(tree)), manifest["extra"]


def host_snapshot(tree):
    """A copy of ``tree`` on the host, made before this returns (a node with
    ``checkpoint_tree`` in that layout): later in-place updates of the
    live tensors cannot reach it."""
    if hasattr(tree, "checkpoint_tree"):
        return tree.checkpoint_tree("cpu")
    return _unflatten(tree, [t.detach().to("cpu", copy=True)
                             for _, t in _flatten_with_paths(tree)])


class AsyncCheckpointer:
    """Background-thread checkpointing, as ``repro.checkpoint.store``'s:
    ``maybe_save`` copies the tree to the host, hands the write to one
    thread and returns; the previous write is joined before a new one
    starts (at most one checkpoint in flight)."""

    def __init__(self, ckpt_dir: str | Path, every: int = 100, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.every = every
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.saved_steps: list[int] = []

    def maybe_save(self, step: int, tree, extra: dict | None = None, force=False) -> bool:
        if not force and (self.every <= 0 or step % self.every != 0):
            return False
        self.wait()
        host_tree = host_snapshot(tree)

        def work():
            save_checkpoint(self.ckpt_dir, step, host_tree, extra=extra, keep=self.keep)
            self.saved_steps.append(step)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
