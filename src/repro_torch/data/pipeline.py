"""Deterministic, resumable data pipeline (the port's own copy of
``repro.data.pipeline``: numpy only, batches bitwise the reference's for
every (seed, step)).

Two sources:
  * ``SyntheticLM`` — a seeded Markov-ish token generator with enough
    structure to be learnable (bigram transition table), used by tests,
    examples, and the e2e train driver.  No external data gates.
  * ``PackedDocs``  — packs variable-length documents (any iterator of token
    lists) into fixed (B, S) training batches with loss masks.

Determinism/resume: every batch is a pure function of (seed, step), so
restoring a checkpoint at step k reproduces the exact stream — the trainer
stores only the step counter (checkpoint/ relies on this).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "synthetic"  # synthetic | packed


class SyntheticLM:
    """Learnable synthetic LM stream: tokens follow a fixed random bigram
    table with temperature, so cross-entropy has a known floor well below
    log(V) — training curves show real learning."""

    def __init__(self, cfg: DataConfig, branching: int = 4):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed ^ 0x5EED)
        v = cfg.vocab_size
        # each token can transition to `branching` successors
        self.next_tokens = rng.integers(0, v, size=(v, branching))

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        b, s = cfg.global_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=b)
        choices = rng.integers(0, self.next_tokens.shape[1], size=(b, s))
        for t in range(s):
            toks[:, t + 1] = self.next_tokens[toks[:, t], choices[:, t]]
        return {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:].astype(np.int32),
            "loss_mask": np.ones((b, s), np.float32),
        }


class PackedDocs:
    """Greedy packing of documents into fixed-length rows.

    Documents are delimited by ``eos``; loss_mask zeros out padding.  The
    packer is driven by a seeded generator so it's restartable from a step
    index (documents are re-derived, not stored)."""

    def __init__(self, cfg: DataConfig, doc_sampler=None, eos: int = 0):
        self.cfg = cfg
        self.eos = eos
        self._sampler = doc_sampler or self._default_sampler

    def _default_sampler(self, rng: np.random.Generator) -> np.ndarray:
        n = int(rng.integers(8, self.cfg.seq_len // 2 + 8))
        return rng.integers(1, self.cfg.vocab_size, size=n).astype(np.int32)

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ (step * 2 + 1))
        b, s = cfg.global_batch, cfg.seq_len
        toks = np.zeros((b, s + 1), np.int32)
        mask = np.zeros((b, s), np.float32)
        for i in range(b):
            fill = 0
            while fill < s + 1:
                doc = self._sampler(rng)
                take = min(len(doc), s + 1 - fill)
                toks[i, fill:fill + take] = doc[:take]
                fill += take
                if fill < s + 1:
                    toks[i, fill] = self.eos
                    fill += 1
            mask[i] = 1.0
        return {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:].astype(np.int32),
            "loss_mask": mask,
        }


def make_source(cfg: DataConfig):
    return SyntheticLM(cfg) if cfg.kind == "synthetic" else PackedDocs(cfg)


def make_batches(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    """Infinite stream resuming at ``start_step`` (checkpoint-resume path)."""
    src = make_source(cfg)
    step = start_step
    while True:
        yield src.batch(step)
        step += 1
