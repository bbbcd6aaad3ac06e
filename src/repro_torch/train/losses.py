"""Losses (counterpart of ``repro.train.losses``).  The cross-entropy is
chunked over the sequence and each chunk runs under
``torch.utils.checkpoint``, so no (B, S, V) logits live at once: a chunk's
(B, chunk, V) f32 logits are made in the forward, dropped, and made again
in the backward, as ``jax.checkpoint`` does in the reference's scan.

The head product is a plain large matrix product (the reference leaves it
to XLA): the operands rounded to bf16, multiplied in f32 (``torch.matmul``
on f32 copies of the bf16 values), so its gradients are autograd's."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _ce_chunk(hidden, head_w, targets, mask, z_coef: float):
    """(sum of (lse - gold) over the chunk's masked positions, z_coef times
    the sum of lse²), both f32."""
    logits = torch.matmul(hidden.to(torch.bfloat16).to(torch.float32),
                          head_w.to(torch.bfloat16).to(torch.float32))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].to(torch.int64))[..., 0]
    ce = (lse - gold) * mask
    z = torch.square(lse) * mask
    return ce.sum(), z.sum() * z_coef


def chunked_cross_entropy(hidden, head_w, targets, mask, *, chunk: int = 512,
                          z_coef: float = 0.0):
    """hidden (B, S, D), head_w (D, V), targets (B, S) int, mask (B, S).
    Returns (mean_ce + z_loss, {"ce", "tokens"}); a sequence that ``chunk``
    does not divide is taken as one chunk (the reference's fallback)."""
    b, s, d = hidden.shape
    mask = mask.to(torch.float32)
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s  # fall back for odd smoke shapes
    nc = s // chunk
    if nc == 1:
        ce_sum, z_sum = _ce_chunk(hidden, head_w, targets, mask, z_coef)
    else:
        ce_sum = z_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(nc):
            cols = slice(i * chunk, (i + 1) * chunk)
            ce, z = checkpoint(_ce_chunk, hidden[:, cols], head_w, targets[:, cols],
                               mask[:, cols], z_coef, use_reentrant=False)
            ce_sum, z_sum = ce_sum + ce, z_sum + z
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = ce_sum / denom + z_sum / denom
    return loss, {"ce": ce_sum / denom, "tokens": denom}
