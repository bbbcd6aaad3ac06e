"""Continuous-batching serving engine over any ported session (counterpart
of ``repro.serve.engine``).

Requests join after batched chunked prefill; every decode tick advances all
active slots one token through one ragged decode call.  For block-pool
backends (``session.uses_blocks``: paged) the engine owns a
:class:`~repro_torch.serve.kv_cache.BlockManager`: admission takes waiting
requests while free blocks cover the prompt plus one lookahead token, tables
grow on demand each tick, finished sequences free their blocks immediately,
and block exhaustion preempts the newest-admitted sequence back to the head
of the queue (recompute-style: its emitted tokens are re-prefilled with the
prompt on re-admission, so greedy outputs are unchanged).  Backends without
blocks (ring, recurrent) keep a constant-size state per slot: admission
needs only a free slot, nothing is preempted, and a slot's state rows are
reset before a new occupant prefills.  Requests finish on eos,
``max_tokens`` or the ``max_len`` frontier.

Requests can be **cancelled** (``Engine.cancel``, queued or active: an
active occupant releases its slot and blocks as a preemption does, keeping
the tokens already emitted) and carry an optional completion **deadline**
(``submit(deadline_s=)``; ``tick`` cancels expired requests with a
``deadline_miss`` event before admitting).  Admission order is a pluggable
:class:`AdmissionPolicy` (FCFS default, EDF available), walked head-of-line
within the policy's order.  The decode tick is schedule → dispatch →
collect, so the async front end (``serve.frontend``) can dispatch tick N+1
before it reads tick N.

An enc-dec session (whisper) writes each request's encoder context at its
admission: ``submit(enc_frames=)`` takes the request's (T_enc, D) frames
(zeros when omitted), and the begin step encodes them on the device before
the request prefills, at every admission, so a preempted request replays its
encoder pass.

Sampling is greedy (an argmax) or seeded temperature / top-k, both on the
device for the whole batch with one host copy of the token column a tick
(``steps.sample_tokens``: one ``torch.Generator`` on the engine's device,
seeded by ``seed``).  A tick's host inputs go to the device through pinned
buffers and ``non_blocking`` copies (``steps.HostStage``), so dispatching a
tick never waits for the one in flight.

``Request.t_first`` is stamped after the prefill's first token has been
copied to the host, so it includes the device work.  All durations come
from ``time.perf_counter()`` stamps; the only wall-clock value kept is the
informational ``Request.t_submit_wall``.

Observability: pass ``obs=`` an :class:`~repro_torch.obs.Observer` or an
:class:`~repro_torch.obs.ObsConfig` and the engine emits ``repro``'s
scheduler events (submit / admit / prefill_chunk / first_token /
decode_tick / preempt / cancel / deadline_miss / finish / pool_sample),
queue-time / TTFT / inter-token histograms, token / tick / preemption /
cancellation / deadline-miss counters and pool gauges.  ``obs=None`` (the
default) means no observer: one ``is None`` check a site.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..config import ModelConfig
from ..kernels import dispatch
from ..models.sessions import SessionSpec, canonical_cache_dtype, make_session
from ..obs import resolve_observer
from . import steps
from .kv_cache import BlockManager, blocks_for, pack_block_tables

_NULL_CTX = contextlib.nullcontext()  # reusable no-op span (obs off)


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_tokens: int
    eos: int | None = None
    # (T_enc, D) encoder frames (enc-dec families); identity, not value, matters
    enc_frames: Any = field(default=None, compare=False, repr=False)
    deadline_s: float | None = None  # completion budget from submit (seconds)
    out_tokens: list[int] = field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    finish_reason: str = ""  # eos | max_tokens | max_len | user | deadline
    # perf_counter stamps: duration math only ever uses these
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    # informational wall-clock submit time (never used in arithmetic)
    t_submit_wall: float = 0.0


@dataclass
class TickPlan:
    """One decode tick's host-side schedule, frozen at dispatch time.

    ``active``/``rids`` pin which request occupied each scheduled slot when
    the tick launched: collection skips a slot whose occupant changed while
    the tick was in flight.  ``toks`` is the host token batch, or ``None``
    when the dispatcher is handed the previous tick's device token column
    instead (the dispatch-ahead path)."""

    active: list[int]            # scheduled slot ids
    rids: list[int]              # per-active-slot request id (staleness check)
    positions: np.ndarray        # (slots,) int32; -1 = idle row
    toks: np.ndarray | None      # (slots, 1) int32 host tokens, or None


class AdmissionPolicy:
    """Orders the waiting queue for admission.

    ``order`` returns the waiting requests in admission-priority order; the
    engine walks that order and stops at the first request that does not fit
    (head-of-line within the policy's order, so a policy reorders priorities
    but cannot break the pool-capacity invariants)."""

    name = "policy"

    def order(self, queue: list[Request], now: float) -> list[Request]:
        raise NotImplementedError


class FCFSAdmission(AdmissionPolicy):
    """First-come-first-served: the queue order is the admission order."""

    name = "fcfs"

    def order(self, queue: list[Request], now: float) -> list[Request]:
        return queue


class EDFAdmission(AdmissionPolicy):
    """Earliest-deadline-first: requests with the nearest absolute deadline
    admit first; deadline-free requests follow in FCFS order."""

    name = "edf"

    def order(self, queue: list[Request], now: float) -> list[Request]:
        return sorted(queue, key=lambda r: (
            (0, r.t_submit + r.deadline_s) if r.deadline_s is not None
            else (1, r.t_submit)))


@contextlib.contextmanager
def _timed_span(obs, name: str):
    with obs.annotate(name), dispatch.kernel_timing():
        yield


class Engine:
    """Continuous-batching scheduler over the session of ``cfg`` (``backend``
    defaults to the family's); ``device`` follows the package rule (the card
    unless ``"cpu"``).  ``greedy=False`` samples at ``temperature`` from the
    ``top_k`` largest logits (0: all) with a generator seeded by ``seed``."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4, max_len: int = 512,
                 backend: str | None = None, block_size: int = 16,
                 num_blocks: int | None = None, cache_dtype="float32",
                 prefill_batch: int = 2, prefill_chunk: int = 32, greedy: bool = True,
                 temperature: float = 1.0, top_k: int = 0, seed: int = 0, obs=None,
                 admission: AdmissionPolicy | None = None, device=None):
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
        self.greedy = greedy
        self.temperature = temperature
        self.top_k = top_k
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.manager: BlockManager | None = None
        if self.session.uses_blocks:
            self.manager = BlockManager(spec.resolved_num_blocks(), spec.block_size)
        width = spec.table_width() if self.manager is not None else 0
        self._stage = steps.HostStage(self.slots * (2 + width), self.device)
        self.state = self.session.init_state()
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.admission = admission if admission is not None else FCFSAdmission()
        self._any_deadline = False  # cheap guard for the per-tick expiry scan
        self._next_rid = 0
        self.slot_req: list[Request | None] = [None] * self.slots
        self.slot_pos = np.zeros(self.slots, np.int32)  # next position to decode
        self._admit_order: list[int] = []  # slots, oldest admission first

        self.obs = resolve_observer(obs)
        self._tick_no = 0
        self._t_last_tok: dict[int, float] = {}  # slot -> last token stamp
        if self.obs is not None:
            reg = self.obs.registry
            self._h_queue = reg.histogram("serve_queue_seconds")
            self._h_ttft = reg.histogram("serve_ttft_seconds")
            self._h_intertok = reg.histogram("serve_inter_token_seconds")
            self._c_tokens = reg.counter("serve_tokens_total")
            self._c_ticks = reg.counter("serve_decode_ticks_total")
            self._c_preempt = reg.counter("serve_preemptions_total")
            self._c_cancel = reg.counter("serve_cancellations_total")
            self._c_deadline = reg.counter("serve_deadline_miss_total")
            self._g_active = reg.gauge("serve_active_slots")
            if self.manager is not None:
                self._g_util = reg.gauge("serve_pool_utilization")
                self._g_free = reg.gauge("serve_pool_free_blocks")
                self._g_live = reg.gauge("serve_pool_live_tokens")

    # -- public API -----------------------------------------------------------
    def submit(self, prompt: list[int], max_tokens: int = 32, eos: int | None = None,
               enc_frames=None, deadline_s: float | None = None) -> Request:
        """Queue a request.  ``enc_frames`` (T_enc, D), for an enc-dec
        session, is encoded at each admission; a request without it gets
        zeros."""
        if not prompt:
            raise ValueError("empty prompt")
        if max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be a positive completion budget in seconds "
                f"(got {deadline_s!r} with max_tokens={max_tokens}); omit it "
                "for no deadline")
        if len(prompt) + 1 > self.max_len:
            raise ValueError(f"prompt needs {len(prompt) + 1} positions "
                             f"> max_len {self.max_len}")
        if enc_frames is not None:
            want = (self.cfg.enc_len, self.cfg.d_model)
            if not self.session.needs_encoder_ctx:
                raise ValueError(f"enc_frames given, but {self.cfg.name} "
                                 f"({self.cfg.family}) has no encoder")
            if tuple(enc_frames.shape) != want:
                raise ValueError(f"enc_frames must be {want} (T_enc, D); got "
                                 f"{tuple(enc_frames.shape)}")
        if self.manager is not None:  # servable alone: prompt + output fit the pool
            worst = min(len(prompt) + max_tokens, self.max_len)
            need = blocks_for(worst, self.manager.block_size)
            if need > self.manager.num_blocks - 1:
                raise ValueError(f"request needs up to {need} blocks but the pool only "
                                 f"has {self.manager.num_blocks - 1}")
        req = Request(self._next_rid, list(prompt), max_tokens, eos, enc_frames=enc_frames,
                      deadline_s=deadline_s,
                      t_submit=time.perf_counter(),
                      # analyze: allow[wall-clock] informational submit stamp; never enters duration math
                      t_submit_wall=time.time())
        self._next_rid += 1
        self._any_deadline |= deadline_s is not None
        self.queue.append(req)
        if self.obs is not None:
            self.obs.event("submit", t=req.t_submit, rid=req.rid,
                           prompt_len=len(req.prompt), max_tokens=max_tokens)
        return req

    def pending(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def tick(self) -> None:
        """One scheduler step: expire deadlines, admit waiting requests
        (batched chunked prefill), then decode one token for every active
        sequence (schedule → dispatch → collect)."""
        self._expire_deadlines()
        self._admit()
        plan = self._decode_schedule()
        if plan is not None:
            self._decode_collect(plan, self._decode_dispatch(plan))
        self._finish_tick()

    def run(self, max_ticks: int = 10_000) -> list[Request]:
        """Tick until drained; returns the requests finished by this call.
        The engine stays usable after draining."""
        start = len(self.finished)
        ticks = 0
        while self.pending() and ticks < max_ticks:
            self.tick()
            ticks += 1
        return self.finished[start:]

    def cancel(self, req: Request, reason: str = "user") -> bool:
        """Cancel a queued or active request, freeing its slot and blocks;
        emitted tokens stay on the request.  Returns ``False`` when the
        request already finished or is neither queued nor active."""
        if req.done:
            return False
        slot = -1
        if not self._remove_from_queue(req):
            for s, r in enumerate(self.slot_req):
                if r is req:
                    slot = s
                    self.slot_req[s] = None
                    self._admit_order.remove(s)
                    self._t_last_tok.pop(s, None)
                    self._release(req)
                    break
            else:
                return False
        req.cancelled = True
        req.done = True
        req.finish_reason = reason
        req.t_done = time.perf_counter()
        self.finished.append(req)
        if self.obs is not None:
            self._c_cancel.inc()
            self.obs.event("cancel", t=req.t_done, rid=req.rid, slot=slot,
                           tick=self._tick_no, reason=reason)
        return True

    @property
    def num_free_blocks(self) -> int | None:
        return None if self.manager is None else self.manager.num_free

    # -- internals ------------------------------------------------------------
    def _finish_tick(self) -> None:
        """Per-tick epilogue shared by ``tick`` and the async pump."""
        if self.obs is not None:
            self._sample_pool()
        self._tick_no += 1

    def _span(self, name: str):
        """A profiler span (and the fenced kernel timing) when obs asks."""
        if self.obs is None:
            return _NULL_CTX
        if self.obs.config.kernel_timing:
            return _timed_span(self.obs, name)
        return self.obs.annotate(name)

    def _expired_requests(self, now: float) -> list[Request]:
        live = self.queue + [r for r in self.slot_req if r is not None]
        return [r for r in live if r.deadline_s is not None
                and now - r.t_submit > r.deadline_s]

    def _deadline_due(self) -> bool:
        """True when some live request's deadline has passed (the async pump
        breaks its dispatch-ahead chain to expire it)."""
        return self._any_deadline and bool(self._expired_requests(time.perf_counter()))

    def _expire_deadlines(self) -> int:
        """Cancel every live request whose completion deadline has passed."""
        if not self._any_deadline:
            return 0
        now = time.perf_counter()
        expired = self._expired_requests(now)
        for req in expired:
            if self.obs is not None:
                self._c_deadline.inc()
                self.obs.event("deadline_miss", t=now, rid=req.rid, tick=self._tick_no,
                               deadline_s=req.deadline_s)
            self.cancel(req, reason="deadline")
        return len(expired)

    def _sample_pool(self) -> None:
        """Pool gauges and a pool_sample event (obs on)."""
        active = sum(r is not None for r in self.slot_req)
        self._g_active.set(active)
        if self.manager is None or self._tick_no % self.obs.config.pool_sample_every:
            return
        util = self.manager.utilization()
        free = self.manager.num_free
        live = self.manager.live_tokens()
        self._g_util.set(util)
        self._g_free.set(free)
        self._g_live.set(live)
        self.obs.event("pool_sample", tick=self._tick_no, utilization=util,
                       free_blocks=free, live_tokens=live, active_slots=active)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """(slots, V) logits -> (slots, 1) int32 tokens on the device."""
        if self.greedy:
            return steps.greedy_tokens(logits)
        return steps.sample_tokens(logits, self.generator, temperature=self.temperature,
                                   top_k=self.top_k)

    def _emit(self, req: Request, tok: int) -> bool:
        """Record one token; True when the request is done."""
        req.out_tokens.append(tok)
        if self.obs is not None:
            self._c_tokens.inc()
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
        if self.obs is not None:
            self.obs.event("finish", t=req.t_done, rid=req.rid, tick=self._tick_no,
                           reason=reason, n_out=len(req.out_tokens))

    def _seq_tokens(self, req: Request) -> list[int]:
        return req.prompt + req.out_tokens

    def _remove_from_queue(self, req: Request) -> bool:
        for i, r in enumerate(self.queue):
            if r is req:
                del self.queue[i]
                return True
        return False

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

    def _tables(self, extra: dict[int, int] | None = None) -> np.ndarray | None:
        """The (slots, W) host block tables of the slots' occupants (block
        backends; ``extra`` maps slots about to prefill to their rids)."""
        if self.manager is None:
            return None
        rids: list[int | None] = [r.rid if r is not None else None for r in self.slot_req]
        for s, rid in (extra or {}).items():
            rids[s] = rid
        return pack_block_tables(self.manager, rids, self.session.spec.table_width())

    def _admit(self):
        """Policy-ordered admission (FCFS by default): take waiting requests
        while a slot is free and (block backends) the pool covers their
        tokens plus one lookahead token, then prefill them together in
        fixed-width chunks."""
        free_slots = [s for s in range(self.slots) if self.slot_req[s] is None]
        batch: list[tuple[int, Request]] = []
        reserve = 0  # lookahead blocks promised to earlier batch members
        if self.queue and free_slots:
            for req in self.admission.order(list(self.queue), time.perf_counter()):
                if not free_slots or len(batch) >= self.prefill_batch:
                    break
                if self.manager is not None:
                    n_tok = len(self._seq_tokens(req))
                    bs = self.manager.block_size
                    need = blocks_for(n_tok + 1, bs)
                    if need + reserve > self.manager.num_free or \
                            not self.manager.allocate(req.rid, n_tok):
                        break  # head-of-line blocks, within the policy's order
                    reserve += need - blocks_for(n_tok, bs)
                self._remove_from_queue(req)
                batch.append((free_slots.pop(0), req))
        if not batch:
            return
        if self.obs is not None:
            t_admit = time.perf_counter()
            for s, req in batch:
                self.obs.event("admit", t=t_admit, rid=req.rid, slot=s, tick=self._tick_no,
                               n_tokens=len(self._seq_tokens(req)))
                if not req.t_first:  # first admission, not a preempt replay
                    self._h_queue.observe(t_admit - req.t_submit)
        self._reset_slots([s for s, _ in batch])
        if self.session.needs_encoder_ctx:  # every admission, preempt replays included
            with self._span("repro_torch/serve/begin"):
                for s, req in batch:
                    self.state = steps.begin_step(self.session, self.params, self.state, s,
                                                  req.enc_frames, self.device)
        bt = self._tables(extra={s: req.rid for s, req in batch})
        if bt is not None:
            self.state = self.session.with_tables(self.state, self._stage.copy(bt)[0])
        prompts: list[list[int] | None] = [None] * self.slots
        for s, req in batch:
            prompts[s] = self._seq_tokens(req)
        on_chunk = None
        if self.obs is not None:
            rids = [req.rid for _, req in batch]

            def on_chunk(c, n_chunks):
                self.obs.event("prefill_chunk", tick=self._tick_no, chunk=c,
                               n_chunks=n_chunks, rids=rids)
        with self._span("repro_torch/serve/prefill"):
            logits, self.state = steps.chunked_prefill(
                self.session.prefill_chunk, self.params, self.state, prompts,
                chunk=self.prefill_chunk, device=self.device, on_chunk=on_chunk)
            # first-token latency: the host copy waits for the device
            toks = self._sample(logits)[:, 0].tolist()
        t_ready = time.perf_counter()
        for s, req in batch:
            if not req.t_first:
                req.t_first = t_ready
                if self.obs is not None:
                    self._h_ttft.observe(t_ready - req.t_submit)
                    self.obs.event("first_token", t=t_ready, rid=req.rid, tick=self._tick_no,
                                   ttft_s=t_ready - req.t_submit)
            self._t_last_tok[s] = t_ready
            if self._emit(req, toks[s]):  # eos on the first token / max_tokens=1
                self._t_last_tok.pop(s, None)
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
            self._t_last_tok.pop(s, None)
            if self.obs is not None:
                self._c_preempt.inc()
                self.obs.event("preempt", rid=req.rid, slot=s, tick=self._tick_no)
            return s
        return None

    def _decode_schedule(self) -> TickPlan | None:
        """Grow each active table to cover its incoming token (block backends,
        preempting the newest on exhaustion), pick the active slots and build
        the token/position batch.  ``None`` when nothing is active."""
        if self.manager is not None:
            for s in list(self._admit_order):
                req = self.slot_req[s]
                if req is None:
                    continue
                while not self.manager.ensure(req.rid, int(self.slot_pos[s]) + 1):
                    victim = self._preempt_newest()
                    if victim == s:
                        break  # the grower was evicted; retries on re-admission
                    if victim is None:
                        raise RuntimeError(
                            f"block pool too small: sequence {req.rid} alone cannot "
                            f"grow to {int(self.slot_pos[s]) + 1} tokens")
        active = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not active:
            return None
        if self.obs is not None:
            self._c_ticks.inc()
            self.obs.event("decode_tick", tick=self._tick_no, active=len(active))
        toks = np.zeros((self.slots, 1), np.int32)
        positions = np.full((self.slots,), -1, np.int32)
        for s in active:
            toks[s, 0] = self.slot_req[s].out_tokens[-1]
            positions[s] = self.slot_pos[s]
        return TickPlan(active=active, rids=[self.slot_req[s].rid for s in active],
                        positions=positions, toks=toks)

    def _plan_ahead(self, plan: TickPlan) -> TickPlan | None:
        """Plan the tick after the in-flight ``plan`` without its token values
        (dispatch-ahead).

        Safe only when every in-flight slot survives its emission (no eos
        watch, not at the max_tokens / max_len frontier) and the pool grows
        one more token a sequence without preempting.  Sampling is on the
        device either way, so greedy and seeded sampling both chain (the
        generator's draws come in the same order as without the chain).
        Returns ``None`` otherwise; the caller collects the in-flight tick
        first."""
        for i, s in enumerate(plan.active):
            req = self.slot_req[s]
            if req is None or req.rid != plan.rids[i] or req.eos is not None:
                return None
            if len(req.out_tokens) + 1 >= req.max_tokens:
                return None
            if int(plan.positions[s]) + 1 >= self.max_len - 1:
                return None
        if self.manager is not None:
            for s in plan.active:
                # position p+1 writes token p+1 -> needs p+2 covered; bail to the
                # synchronous path rather than preempt around an uncollected tick
                if not self.manager.ensure(self.slot_req[s].rid, int(plan.positions[s]) + 2):
                    return None
        positions = np.full((self.slots,), -1, np.int32)
        for s in plan.active:
            positions[s] = plan.positions[s] + 1
        if self.obs is not None:
            self._c_ticks.inc()
            # the in-flight tick has not collected yet, so _tick_no still
            # names it; the ahead tick is the next one
            self.obs.event("decode_tick", tick=self._tick_no + 1, active=len(plan.active))
        return TickPlan(active=list(plan.active), rids=list(plan.rids), positions=positions,
                        toks=None)

    def _decode_dispatch(self, plan: TickPlan, device_toks: torch.Tensor | None = None):
        """Launch ``plan``'s decode step; returns its (slots, 1) int32 token
        column on the device, sampled there.  ``device_toks`` (the previous
        tick's column) takes the place of the host tokens on the
        dispatch-ahead path.  Issues no synchronizing call: the host inputs
        go through the pinned stage."""
        host = [plan.positions] if device_toks is not None else [plan.positions, plan.toks]
        bt = self._tables()
        staged = self._stage.copy(*host, *([bt] if bt is not None else []))
        if bt is not None:
            self.state = self.session.with_tables(self.state, staged[-1])
        toks = device_toks if device_toks is not None else staged[1]
        with self._span("repro_torch/serve/decode"):
            logits, self.state = self.session.decode_step(self.params, self.state, toks,
                                                          staged[0])
            return self._sample(logits)

    def _decode_collect(self, plan: TickPlan, tok_col: torch.Tensor, toks_host=None):
        """Record one token per scheduled slot and run the finish
        bookkeeping.  ``toks_host`` (a (slots,) int sequence already on the
        host, the dispatch-ahead path's) skips the copy of ``tok_col``.  Slots
        whose occupant changed since dispatch (cancelled in flight) are
        skipped; their token is discarded."""
        if toks_host is None:
            # analyze: allow[host-sync] one host copy of the tick's token column
            toks_host = tok_col[:, 0].tolist()
        for i, s in enumerate(plan.active):
            req = self.slot_req[s]
            if req is None or req.rid != plan.rids[i]:
                continue  # cancelled while the tick was in flight
            self.slot_pos[s] += 1
            if self.obs is not None:
                # tick-granular inter-token latency: the tokens are on the
                # host already, so the stamp costs no device sync
                now = time.perf_counter()
                last = self._t_last_tok.get(s)
                if last is not None:
                    self._h_intertok.observe(now - last)
                self._t_last_tok[s] = now
            if self._emit(req, int(toks_host[s])) or self.slot_pos[s] >= self.max_len - 1:
                if not req.done:
                    self._finish(req, "max_len")
                self._release(req)
                self.slot_req[s] = None
                self._admit_order.remove(s)
                self._t_last_tok.pop(s, None)


class PagedEngine(Engine):
    """Deprecated alias of :class:`Engine` (as in ``repro``): every family
    serves through the one session scheduler."""

    def __init__(self, *args, **kwargs):
        warnings.warn("PagedEngine is a deprecated alias; use serve.engine.Engine",
                      DeprecationWarning, stacklevel=2)
        super().__init__(*args, **kwargs)
