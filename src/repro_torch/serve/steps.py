"""Serving-side helpers (counterpart of ``repro.serve.steps``): the serving
config transform, the chunked-prefill driver and device-side greedy sampling.

PyTorch runs eagerly, so there is no per-(session, backend) program memo:
the session's step methods are called directly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig, QuantConfig


def serve_config_of(cfg: ModelConfig) -> ModelConfig:
    """Training config -> serving config: int4 (group 128) weights for the
    non-TT linears and bf16 params."""
    return cfg.replace(quant=QuantConfig(enabled=True, bits=4, group_size=128),
                       param_dtype="bfloat16")


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """(slots, V) logits -> (slots, 1) int32 argmax column, on the device."""
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def chunked_prefill(prefill_chunk_fn, params, state, prompts, *, chunk: int,
                    device=None):
    """Prefill several prompts through repeated fixed-width chunk calls.

    prompts: one token list per decode slot; ``None``/empty rows are idle
    slots riding along at position ``-1``.  Every call processes a
    (slots, chunk) tile and unembeds only each row's column that holds its
    prompt's last token.  Returns (last_logits (slots, V) f32 — zeros for
    idle rows — and the updated state).
    """
    b = len(prompts)
    lens = [len(p) if p else 0 for p in prompts]
    n_chunks = -(-max(max(lens), 1) // chunk)
    toks = np.zeros((b, n_chunks * chunk), np.int32)
    pos = np.full((b, n_chunks * chunk), -1, np.int32)
    for i, p in enumerate(prompts):
        if p:
            toks[i, :len(p)] = p
            pos[i, :len(p)] = np.arange(len(p))
    toks_d = torch.from_numpy(toks).to(device)
    pos_d = torch.from_numpy(pos).to(device)
    last = [None] * b
    logits = None
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        ends = [n and c * chunk <= n - 1 < (c + 1) * chunk for n in lens]
        cols = torch.tensor([(n - 1) % chunk if e else 0 for n, e in zip(lens, ends)],
                            device=device)
        logits, state = prefill_chunk_fn(params, state, toks_d[:, sl], pos_d[:, sl],
                                         logit_cols=cols)
        for i, e in enumerate(ends):
            if e:
                last[i] = logits[i]
    zero = torch.zeros(logits.shape[-1], dtype=logits.dtype, device=logits.device)
    return torch.stack([x if x is not None else zero for x in last]), state
