"""Asyncio serving front end: submit / stream / cancel over the engine
(counterpart of ``repro.serve.frontend``).

:class:`AsyncEngine` wraps :class:`~repro_torch.serve.engine.Engine` behind
an asyncio surface: ``submit()`` returns a :class:`RequestHandle` at once,
tokens arrive through ``async for tok in handle.stream()`` as the scheduler
emits them, ``handle.cancel()`` frees the request's slot and blocks, and
``submit(deadline_s=)`` rides the engine's deadline expiry.  One background
*pump* task drives the engine; consumers are coroutines on the same loop.

**Dispatch-ahead on one CUDA stream.**  The engine's decode tick is
schedule → dispatch → collect, and a CUDA launch returns while the device
computes.  When every in-flight slot survives its emission
(``Engine._plan_ahead``), the pump feeds tick N's token column, still on the
device, into tick N+1 and dispatches it before tick N's tokens reach the
host, so the host's bookkeeping for tick N runs while the device computes
tick N+1.  JAX tracks each array's readiness, so ``repro``'s pump reads tick
N after dispatching N+1 and waits for N alone.  On one CUDA stream a
blocking ``.cpu()`` of tick N issued after tick N+1 was queued waits for
N+1 as well.  So the pump here:

1. takes tick N's token column on the device (sampled at its dispatch);
2. enqueues its ``non_blocking`` copy into a pinned buffer and records an
   event after it (``steps.tokens_to_host``);
3. only then dispatches tick N+1 from the device column;
4. waits on the event (tick N and its copy, not tick N+1) before it
   collects tick N.

Nothing between steps 1 and 4 synchronizes: tick N+1's host inputs go
through the engine's pinned stage (``steps.HostStage``), and sampling draws
on the device.  When the guarantee fails (a request at its frontier or with
an eos watch, a pending cancel, an admission waiting on a free slot, an
expired deadline, a pool that would have to preempt), the pump falls back to
the synchronous collect-then-dispatch order, so the emitted tokens are the
same either way.  ``dispatch_ahead=False`` pins the synchronous order (the
control arm).

Invariants the pump keeps:

* at most one tick is in flight at any time (double buffering, not a queue);
* cancellations, deadline expiry and admissions are applied only while no
  tick is in flight: a cancel arriving mid-flight is applied before the
  next dispatch, and collection skips slots whose occupant changed;
* an in-flight ahead tick only extends sequences that the collection of its
  predecessor cannot finish, so no token is emitted for a dead request.

The front end is drained-reusable: the pump exits when the engine drains
and a later ``submit`` starts a fresh one.
"""
from __future__ import annotations

import asyncio
from collections.abc import AsyncIterator

import torch

from . import steps
from .engine import Engine, Request, TickPlan

_DONE = object()  # stream sentinel


class RequestHandle:
    """One submitted request: stream its tokens, await it, or cancel it."""

    def __init__(self, owner: AsyncEngine, req: Request):
        self._owner = owner
        self.req = req
        self._queue: asyncio.Queue = asyncio.Queue()
        self._done = asyncio.Event()
        self._n_sent = 0
        self._cancel_requested = False
        self._error: BaseException | None = None

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def out_tokens(self) -> list[int]:
        return list(self.req.out_tokens)

    @property
    def done(self) -> bool:
        return self.req.done

    @property
    def cancelled(self) -> bool:
        return self.req.cancelled

    @property
    def finish_reason(self) -> str:
        return self.req.finish_reason

    async def stream(self) -> AsyncIterator[int]:
        """Yield token ids as the scheduler emits them; ends at finish or
        cancellation (check :attr:`cancelled` to tell them apart)."""
        while True:
            item = await self._queue.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    async def wait_done(self) -> None:
        """Wait for finish or cancellation without consuming the stream."""
        await self._done.wait()

    async def result(self) -> list[int]:
        """Wait for the request to finish; returns all emitted tokens."""
        await self._done.wait()
        if self._error is not None:
            raise self._error
        return list(self.req.out_tokens)

    def cancel(self) -> None:
        """Request cancellation; the pump applies it at the next safe point
        (no tick in flight).  Idempotent; a no-op after finish."""
        if self.req.done or self._cancel_requested:
            return
        self._cancel_requested = True
        self._owner._cancel_q.append(self)


class AsyncEngine:
    """Asyncio front end over the serving engine.

    Construct like :class:`~repro_torch.serve.engine.Engine` (config, params
    and its keyword arguments, ``device`` included: the card unless
    ``"cpu"``), or wrap a built engine with ``engine=``.  ``submit`` must be
    called from a running event loop; it starts the pump task.
    ``stats["ticks"]`` counts collected decode ticks, ``stats["ahead_ticks"]``
    those dispatched ahead of their predecessor's collection.
    """

    def __init__(self, cfg=None, params=None, *, engine: Engine | None = None,
                 dispatch_ahead: bool = True, **engine_kwargs):
        if engine is not None:
            if cfg is not None or params is not None or engine_kwargs:
                raise ValueError("pass either a built engine= or cfg/params + engine "
                                 "kwargs, not both")
            self.engine = engine
        else:
            self.engine = Engine(cfg, params, **engine_kwargs)
        self.dispatch_ahead = dispatch_ahead
        self.stats = {"ticks": 0, "ahead_ticks": 0}
        self._handles: dict[int, RequestHandle] = {}
        self._cancel_q: list[RequestHandle] = []
        self._pump_task: asyncio.Task | None = None
        # tick N's tokens land here while tick N+1 computes
        self._tok_host = torch.empty((self.engine.slots, 1), dtype=torch.int32,
                                     pin_memory=self.engine.device.type == "cuda")

    # -- public API -----------------------------------------------------------
    def submit(self, prompt: list[int], max_tokens: int = 32, eos: int | None = None,
               enc_frames=None, deadline_s: float | None = None) -> RequestHandle:
        """Validate and enqueue a request and (re)start the pump.  Raises the
        engine's submit-time ``ValueError``s before any handle exists."""
        loop = asyncio.get_running_loop()  # raises outside an event loop
        req = self.engine.submit(prompt, max_tokens=max_tokens, eos=eos,
                                 enc_frames=enc_frames, deadline_s=deadline_s)
        handle = RequestHandle(self, req)
        self._handles[req.rid] = handle
        if self._pump_task is None or self._pump_task.done():
            self._pump_task = loop.create_task(self._pump())
        return handle

    async def drain(self) -> None:
        """Wait until every submitted request has finished or been
        cancelled; re-raises a pump failure."""
        while self._pump_task is not None and not self._pump_task.done():
            await asyncio.shield(self._pump_task)
        if self._pump_task is not None:
            self._pump_task.result()

    def close(self) -> None:
        """Abandon the pump (outstanding streams get the cancellation)."""
        if self._pump_task is not None and not self._pump_task.done():
            self._pump_task.cancel()

    # -- pump -----------------------------------------------------------------
    def _dispatch_ahead(self, plan2: TickPlan, tok_col: torch.Tensor):
        """Steps 2 and 3: enqueue tick N's token copy and record its event,
        then dispatch tick N+1 from ``tok_col``.  Returns (event, tick N+1's
        token column).  Issues no synchronizing call."""
        copied = steps.tokens_to_host(tok_col, self._tok_host)
        return copied, self.engine._decode_dispatch(plan2, device_toks=tok_col)

    async def _pump(self) -> None:
        eng = self.engine
        in_flight: tuple | None = None  # (plan, token column): at most one tick
        idle = 0
        try:
            while True:
                if in_flight is None:
                    self._apply_cancels()
                    eng._expire_deadlines()
                    self._deliver()
                    if not eng.pending():
                        break
                    eng._admit()  # batched chunked prefill (waits for the device)
                    self._deliver()  # prefill emitted first tokens
                    await asyncio.sleep(0)
                    plan = eng._decode_schedule()
                    if plan is None:
                        eng._finish_tick()
                        idle += 1
                        if idle > 10_000:
                            raise RuntimeError("async pump stalled: queue blocked with no "
                                               "active slots")
                        continue
                    idle = 0
                    in_flight = (plan, eng._decode_dispatch(plan))
                    await asyncio.sleep(0)  # consumers run while the device computes
                    continue
                plan, tok_col = in_flight
                in_flight = None
                plan2 = None
                if self.dispatch_ahead and not self._cancel_q and \
                        not (eng.queue and None in eng.slot_req) and not eng._deadline_due():
                    plan2 = eng._plan_ahead(plan)
                if plan2 is not None:
                    copied, tok_col2 = self._dispatch_ahead(plan2, tok_col)
                    self.stats["ahead_ticks"] += 1
                    if copied is not None:
                        copied.synchronize()  # step 4: tick N and its copy only
                    eng._decode_collect(plan, tok_col, toks_host=self._tok_host[:, 0].tolist())
                    in_flight = (plan2, tok_col2)
                else:
                    eng._decode_collect(plan, tok_col)
                eng._finish_tick()
                self.stats["ticks"] += 1
                self._deliver()
                await asyncio.sleep(0)
        except BaseException as e:
            self._fail(e)
            raise
        finally:
            self._deliver()

    def _apply_cancels(self) -> None:
        q, self._cancel_q = self._cancel_q, []
        for handle in q:
            self.engine.cancel(handle.req, reason="user")

    def _deliver(self) -> None:
        """Push newly emitted tokens (and completions) to consumer queues."""
        finished = []
        for rid, handle in self._handles.items():
            out = handle.req.out_tokens
            while handle._n_sent < len(out):
                handle._queue.put_nowait(out[handle._n_sent])
                handle._n_sent += 1
            if handle.req.done:
                handle._queue.put_nowait(_DONE)
                handle._done.set()
                finished.append(rid)
        for rid in finished:
            del self._handles[rid]

    def _fail(self, error: BaseException) -> None:
        """Propagate a pump failure to every live consumer."""
        for handle in self._handles.values():
            handle._error = error
            handle._queue.put_nowait(error)
            handle._done.set()
        self._handles.clear()
