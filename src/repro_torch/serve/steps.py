"""Serving-side helpers (counterpart of ``repro.serve.steps``): the serving
config transform, the chunked-prefill driver, device-side sampling and the
host/device staging a decode tick needs to stay asynchronous.

PyTorch runs eagerly, so there is no per-(session, backend) program memo:
the session's step methods are called directly.

On one CUDA stream any blocking copy waits for everything queued before it.
A blocking host-to-device copy from pageable memory is ``cudaMemcpyAsync``
followed by ``cudaStreamSynchronize``, and a blocking ``.cpu()`` of tick N's
tokens issued after tick N+1 was queued waits for tick N+1 too.  So a tick's
inputs go through :class:`HostStage` (pinned buffers, ``non_blocking``
copies) and its tokens come back through :func:`tokens_to_host` (a pinned
buffer and an event recorded after the copy), which is what lets the async
front end dispatch tick N+1 before it reads tick N.
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


def sample_tokens(logits: torch.Tensor, generator: torch.Generator | None = None, *,
                  temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """(slots, V) logits -> (slots, 1) int32, one seeded draw a row from
    ``softmax(logits / temperature)`` over the row's ``top_k`` largest logits
    (all of them when ``top_k`` is 0; entries tied with the k-th stay in).

    The draw is the one ``torch.multinomial(p, 1, generator=generator)``
    makes, ``argmax(p / q)`` with ``q ~ Exp(1)``, without the validity checks
    ``multinomial`` reads back from the device: the whole batch is sampled on
    the device with no host sync.  ``repro`` splits a JAX key a slot; the
    streams differ by design, the distribution is the same."""
    scaled = logits.to(torch.float32) / max(temperature, 1e-6)
    if top_k > 0:
        kth = torch.topk(scaled, min(top_k, scaled.shape[-1]), dim=-1).values[:, -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    p = torch.softmax(scaled, dim=-1)
    q = torch.empty_like(p).exponential_(1.0, generator=generator)
    return torch.argmax(p / q, dim=-1).to(torch.int32)[:, None]


class HostStage:
    """A tick's int32 host inputs (tokens, positions, block tables) copied to
    the device in one ``non_blocking`` copy from a pinned buffer (an ordinary
    one on the CPU, where pinning needs a card).

    Two buffers alternate.  The event recorded after each copy guards its
    buffer: it is rewritten only after the copy that read it has completed.
    With at most one tick in flight, that copy (two stagings back) has always
    completed by then, so the guard does not wait.  The device views
    returned alias the stage's device buffer of that turn; the stream orders
    their next overwrite after every kernel that reads them."""

    def __init__(self, n: int, device):
        device = torch.device(device)
        pin = device.type == "cuda"
        self._host = [torch.empty(n, dtype=torch.int32, pin_memory=pin) for _ in range(2)]
        self._dev = [torch.empty(n, dtype=torch.int32, device=device) for _ in range(2)]
        self._copied = [None, None]
        self._turn = 0

    def copy(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """Device int32 tensors shaped like ``arrays`` (host int32 arrays)."""
        i = self._turn
        self._turn ^= 1
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        host = self._host[i].numpy()
        ends = np.cumsum([0] + [a.size for a in arrays])
        for a, lo, hi in zip(arrays, ends[:-1], ends[1:]):
            host[lo:hi] = a.reshape(-1)
        dev = self._dev[i]
        dev[:ends[-1]].copy_(self._host[i][:ends[-1]], non_blocking=True)
        if dev.is_cuda:
            self._copied[i] = torch.cuda.Event()
            self._copied[i].record()
        return [dev[lo:hi].view(a.shape) for a, lo, hi in zip(arrays, ends[:-1], ends[1:])]


def tokens_to_host(tok_col: torch.Tensor, host: torch.Tensor):
    """Enqueue the copy of a tick's (slots, 1) token column into ``host``
    (pinned, (slots, 1) int32) with ``non_blocking=True`` and record an event
    after it.  Returns the event: waiting on it waits for the tick that made
    the column and its copy, not for anything queued later.  On the CPU the
    copy is done on return and the result is ``None``."""
    host.copy_(tok_col, non_blocking=True)
    if not tok_col.is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def begin_step(session, params, state, slot: int, frames, device):
    """The begin step beside prefill and decode (enc-dec sessions): encode one
    admitted request's (T_enc, D) frames and write its context into row
    ``slot`` of the state.  Frames from the host are copied from pinned
    memory with ``non_blocking`` (a tensor already on the device stays); a
    request without frames gets zeros made on the device, as ``repro``'s
    engine gives it.  Nothing is read back."""
    cfg = session.cfg
    if frames is None:
        x = torch.zeros((cfg.enc_len, cfg.d_model), dtype=torch.float32, device=device)
    else:
        x = torch.as_tensor(frames, dtype=torch.float32)
        if x.device.type == "cpu" and torch.device(device).type == "cuda":
            x = x.pin_memory()
        x = x.to(device, non_blocking=True)
    return session.begin_sequence(params, state, slot, x[None])


def chunked_prefill(prefill_chunk_fn, params, state, prompts, *, chunk: int,
                    device=None, on_chunk=None):
    """Prefill several prompts through repeated fixed-width chunk calls.

    prompts: one token list per decode slot; ``None``/empty rows are idle
    slots riding along at position ``-1``.  Every call processes a
    (slots, chunk) tile and unembeds only each row's column that holds its
    prompt's last token.  Returns (last_logits (slots, V) f32 — zeros for
    idle rows — and the updated state).  ``on_chunk(chunk_index, n_chunks)``,
    when given, is called after each chunk's dispatch (the engine's
    ``prefill_chunk`` trace events).
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
        if on_chunk is not None:
            on_chunk(c, n_chunks)
        for i, e in enumerate(ends):
            if e:
                last[i] = logits[i]
    zero = torch.zeros(logits.shape[-1], dtype=logits.dtype, device=logits.device)
    return torch.stack([x if x is not None else zero for x in last]), state
