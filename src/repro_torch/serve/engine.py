"""Continuous-batching serving engine over any ported session (counterpart
of ``repro.serve.engine``).

Requests join after batched chunked prefill; every decode tick advances all
active slots one token through one ragged decode call.  For block-pool
backends (``session.uses_blocks``: paged) the engine owns a
:class:`~repro_torch.serve.kv_cache.BlockManager`: admission is FCFS while
free blocks cover the prompt plus one lookahead token, tables grow on demand
each tick, finished sequences free their blocks immediately, and block
exhaustion preempts the newest-admitted sequence back to the head of the
queue (recompute-style: its emitted tokens are re-prefilled with the prompt
on re-admission, so greedy outputs are unchanged).  Backends without blocks
(ring, recurrent) keep a constant-size state per slot: admission needs only
a free slot, nothing is preempted, and a slot's state rows are reset before
a new occupant prefills.  Requests finish on eos, ``max_tokens`` or the
``max_len`` frontier.  Sampling is greedy, an argmax on the device.

Not ported yet: cancellation, deadlines, EDF admission, observability and the
async front-end's dispatch-ahead split.

``Request.t_first`` is stamped after the prefill's first token has been
copied to the host, so it includes the device work.  All stamps are
``time.perf_counter()``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import ModelConfig
from ..models.sessions import SessionSpec, canonical_cache_dtype, make_session
from . import steps
from .kv_cache import BlockManager, blocks_for, pack_block_tables


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_tokens: int
    eos: int | None = None
    out_tokens: list[int] = field(default_factory=list)
    done: bool = False
    finish_reason: str = ""  # eos | max_tokens | max_len
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class Engine:
    """Continuous-batching scheduler over the session of ``cfg`` (``backend``
    defaults to the family's); ``device`` follows the package rule (the card
    unless ``"cpu"``)."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4, max_len: int = 512,
                 backend: str | None = None, block_size: int = 16,
                 num_blocks: int | None = None, cache_dtype="float32",
                 prefill_batch: int = 2, prefill_chunk: int = 32, device=None):
        self.session = make_session(cfg, SessionSpec(
            slots=slots, max_len=max_len, prefill_chunk=max(1, prefill_chunk),
            block_size=block_size, num_blocks=num_blocks,
            cache_dtype=canonical_cache_dtype(cache_dtype)), backend=backend, device=device)
        self.cfg: ModelConfig = self.session.cfg
        self.device = self.session.device
        spec = self.session.spec
        self.params = params
        self.slots = spec.slots
        self.max_len = spec.max_len
        self.prefill_batch = max(1, prefill_batch)
        self.prefill_chunk = spec.prefill_chunk
        self.manager: BlockManager | None = None
        if self.session.uses_blocks:
            self.manager = BlockManager(spec.resolved_num_blocks(), spec.block_size)
        self.state = self.session.init_state()
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self._next_rid = 0
        self.slot_req: list[Request | None] = [None] * self.slots
        self.slot_pos = np.zeros(self.slots, np.int32)  # next position to decode
        self._admit_order: list[int] = []  # slots, oldest admission first

    # -- public API -----------------------------------------------------------
    def submit(self, prompt: list[int], max_tokens: int = 32,
               eos: int | None = None) -> Request:
        if not prompt:
            raise ValueError("empty prompt")
        if max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if len(prompt) + 1 > self.max_len:
            raise ValueError(f"prompt needs {len(prompt) + 1} positions "
                             f"> max_len {self.max_len}")
        if self.manager is not None:  # servable alone: prompt + output fit the pool
            worst = min(len(prompt) + max_tokens, self.max_len)
            need = blocks_for(worst, self.manager.block_size)
            if need > self.manager.num_blocks - 1:
                raise ValueError(f"request needs up to {need} blocks but the pool only "
                                 f"has {self.manager.num_blocks - 1}")
        req = Request(self._next_rid, list(prompt), max_tokens, eos,
                      t_submit=time.perf_counter())
        self._next_rid += 1
        self.queue.append(req)
        return req

    def pending(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def tick(self) -> None:
        """Admit waiting requests (batched chunked prefill), then decode one
        token for every active sequence."""
        self._admit()
        active = self._decode_schedule()
        if active:
            self._decode_collect(active, self._decode_dispatch(active))

    def run(self, max_ticks: int = 10_000) -> list[Request]:
        """Tick until drained; returns the requests finished by this call."""
        start = len(self.finished)
        ticks = 0
        while self.pending() and ticks < max_ticks:
            self.tick()
            ticks += 1
        return self.finished[start:]

    @property
    def num_free_blocks(self) -> int | None:
        return None if self.manager is None else self.manager.num_free

    # -- internals ------------------------------------------------------------
    def _emit(self, req: Request, tok: int) -> bool:
        """Record one token; True when the request is done."""
        req.out_tokens.append(tok)
        if req.eos is not None and tok == req.eos:
            self._finish(req, "eos")
            return True
        if len(req.out_tokens) >= req.max_tokens:
            self._finish(req, "max_tokens")
            return True
        return False

    def _finish(self, req: Request, reason: str) -> None:
        req.done = True
        req.finish_reason = reason
        req.t_done = time.perf_counter()
        self.finished.append(req)

    def _seq_tokens(self, req: Request) -> list[int]:
        return req.prompt + req.out_tokens

    def _remove_from_queue(self, req: Request) -> None:
        for i, r in enumerate(self.queue):
            if r is req:
                del self.queue[i]
                return

    def _reset_slots(self, slot_ids: list[int]) -> None:
        """Clear the state rows of ``slot_ids`` before new occupants prefill
        (a stale ring or recurrent state would otherwise leak into the next
        sequence): int32 leaves (ring positions) to -1, the rest to 0, in
        place along the session's ``slot_axis``."""
        axis = self.session.slot_axis
        if axis is None:
            return
        idx = torch.tensor(slot_ids, dtype=torch.int64, device=self.device)
        stack = [self.state]
        while stack:
            node = stack.pop()
            if isinstance(node, dict):
                stack.extend(node.values())
            elif isinstance(node, (list, tuple)):
                stack.extend(node)
            else:
                node.index_fill_(axis, idx, -1 if node.dtype == torch.int32 else 0)

    def _sync_tables(self, extra: dict[int, int] | None = None):
        if self.manager is None:
            return
        rids: list[int | None] = [r.rid if r is not None else None for r in self.slot_req]
        for s, rid in (extra or {}).items():
            rids[s] = rid
        bt = pack_block_tables(self.manager, rids, self.session.spec.table_width())
        self.state = self.session.with_tables(self.state, bt)

    def _admit(self):
        """FCFS: take waiting requests while a slot is free and (block
        backends) the pool covers their tokens plus one lookahead token, then
        prefill them together in fixed-width chunks."""
        free_slots = [s for s in range(self.slots) if self.slot_req[s] is None]
        batch: list[tuple[int, Request]] = []
        reserve = 0  # lookahead blocks promised to earlier batch members
        for req in list(self.queue):
            if not free_slots or len(batch) >= self.prefill_batch:
                break
            if self.manager is not None:
                n_tok = len(self._seq_tokens(req))
                bs = self.manager.block_size
                need = blocks_for(n_tok + 1, bs)
                if need + reserve > self.manager.num_free or \
                        not self.manager.allocate(req.rid, n_tok):
                    break  # head-of-line blocks
                reserve += need - blocks_for(n_tok, bs)
            self._remove_from_queue(req)
            batch.append((free_slots.pop(0), req))
        if not batch:
            return
        self._reset_slots([s for s, _ in batch])
        self._sync_tables(extra={s: req.rid for s, req in batch})
        prompts: list[list[int] | None] = [None] * self.slots
        for s, req in batch:
            prompts[s] = self._seq_tokens(req)
        logits, self.state = steps.chunked_prefill(
            self.session.prefill_chunk, self.params, self.state, prompts,
            chunk=self.prefill_chunk, device=self.device)
        toks = steps.greedy_tokens(logits)[:, 0].tolist()  # host copy waits for the device
        t_ready = time.perf_counter()
        for s, req in batch:
            if not req.t_first:
                req.t_first = t_ready
            if self._emit(req, toks[s]):  # eos on the first token / max_tokens=1
                self._release(req)
                continue
            self.slot_req[s] = req
            self.slot_pos[s] = len(prompts[s])
            self._admit_order.append(s)

    def _release(self, req: Request) -> None:
        if self.manager is not None:
            self.manager.free(req.rid)

    def _preempt_newest(self) -> int | None:
        """Free the most recently admitted sequence back to the queue head."""
        for s in reversed(self._admit_order):
            req = self.slot_req[s]
            if req is None:
                continue
            self.manager.free(req.rid)
            self.slot_req[s] = None
            self._admit_order.remove(s)
            self.queue.insert(0, req)
            return s
        return None

    def _decode_schedule(self) -> list[int]:
        """Grow each active table to cover its incoming token (block backends,
        preempting the newest on exhaustion); returns the active slots."""
        growing = list(self._admit_order) if self.manager is not None else []
        for s in growing:
            req = self.slot_req[s]
            if req is None:
                continue
            while not self.manager.ensure(req.rid, int(self.slot_pos[s]) + 1):
                victim = self._preempt_newest()
                if victim == s:
                    break
                if victim is None:
                    raise RuntimeError(
                        f"block pool too small: sequence {req.rid} alone cannot "
                        f"grow to {int(self.slot_pos[s]) + 1} tokens")
        return [s for s in range(self.slots) if self.slot_req[s] is not None]

    def _decode_dispatch(self, active: list[int]):
        self._sync_tables()
        toks = np.zeros((self.slots, 1), np.int32)
        positions = np.full((self.slots,), -1, np.int32)
        for s in active:
            toks[s, 0] = self.slot_req[s].out_tokens[-1]
            positions[s] = self.slot_pos[s]
        t = torch.from_numpy(toks).to(self.device)
        p = torch.from_numpy(positions).to(self.device)
        logits, self.state = self.session.decode_step(self.params, self.state, t, p)
        return steps.greedy_tokens(logits)

    def _decode_collect(self, active: list[int], tok_col):
        # analyze: allow[host-sync] one host copy of the tick's argmax column
        toks = tok_col[:, 0].tolist()
        for s in active:
            req = self.slot_req[s]
            self.slot_pos[s] += 1
            if self._emit(req, toks[s]) or self.slot_pos[s] >= self.max_len - 1:
                if not req.done:
                    self._finish(req, "max_len")
                self._release(req)
                self.slot_req[s] = None
                self._admit_order.remove(s)
