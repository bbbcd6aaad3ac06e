"""Fault-tolerant training loop (counterpart of ``repro.train.trainer``).

* **checkpoint/restart**: ``AsyncCheckpointer`` saves every ``ckpt_every``
  steps (the host snapshot is taken before ``maybe_save`` returns, the
  write runs on one background thread); a failed step — any exception, or
  a non-finite loss (``FloatingPointError``) — restores the last committed
  checkpoint and replays: data is a pure function of (seed, step), so the
  replay is exact.  After ``max_retries`` failures in a row the error is
  raised.
* **straggler watchdog**: a step slower than ``straggler_factor`` times the
  rolling median of the last 50 step times fires ``on_straggler``.
* **preemption**: ``request_stop()`` finishes the current step, force-saves
  and returns.

Step times are ``time.perf_counter`` durations around the step and its loss
read, the step's one host sync.  With an observer, the registry carries
``train_step_seconds``, ``train_tokens_per_second``, ``train_steps_total``
and ``train_restarts_total``.
"""
from __future__ import annotations

import logging
import math
import statistics
import time
from collections.abc import Callable
from dataclasses import dataclass, field
from pathlib import Path

import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..data.pipeline import DataConfig, make_source
from ..obs import resolve_observer
from ..tree import leaves
from .step import TrainState

log = logging.getLogger("repro_torch.trainer")


@dataclass
class TrainerReport:
    steps_done: int = 0
    restarts: int = 0
    straggler_events: list[int] = field(default_factory=list)
    losses: list[float] = field(default_factory=list)
    step_times: list[float] = field(default_factory=list)


class Trainer:
    def __init__(
        self,
        train_step: Callable[[TrainState, dict], tuple[TrainState, dict]],
        state: TrainState,
        data_cfg: DataConfig,
        *,
        ckpt_dir: str | Path | None = None,
        ckpt_every: int = 50,
        max_retries: int = 3,
        straggler_factor: float = 3.0,
        on_straggler: Callable[[int, float, float], None] | None = None,
        obs=None,
    ):
        self.train_step = train_step
        self.state = state
        self.device = leaves(state.params)[0].device
        self.data = make_source(data_cfg)
        self.ckpt = AsyncCheckpointer(ckpt_dir, every=ckpt_every) if ckpt_dir else None
        self.max_retries = max_retries
        self.straggler_factor = straggler_factor
        self.on_straggler = on_straggler or self._log_straggler
        self.report = TrainerReport()
        self._stop = False
        self.obs = resolve_observer(obs)
        if self.obs is not None:
            reg = self.obs.registry
            self._h_step = reg.histogram("train_step_seconds")
            self._g_tps = reg.gauge("train_tokens_per_second")
            self._c_steps = reg.counter("train_steps_total")
            self._c_restarts = reg.counter("train_restarts_total")

    # -- fault-tolerance hooks ------------------------------------------------
    def request_stop(self):
        self._stop = True

    def _log_straggler(self, step: int, dt: float, median: float):
        log.warning("straggler: step %d took %.3fs (median %.3fs)", step, dt, median)

    def _restore_latest(self) -> bool:
        if self.ckpt is None:
            return False
        self.ckpt.wait()
        step = latest_step(self.ckpt.ckpt_dir)
        if step is None:
            return False
        restored, _ = restore_checkpoint(self.ckpt.ckpt_dir, step, self.state)
        self.state = restored.to(self.device)
        log.warning("restored checkpoint at step %d", step)
        return True

    # -- main loop ------------------------------------------------------------
    def current_step(self) -> int:
        return int(self.state.step)  # a host tensor: no device read

    def run(self, num_steps: int, log_every: int = 10,
            fault_injector: Callable[[int], None] | None = None) -> TrainerReport:
        retries = 0
        while self.report.steps_done < num_steps and not self._stop:
            step = self.current_step()
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.data.batch(step).items()}
            t0 = time.perf_counter()
            try:
                if fault_injector is not None:
                    fault_injector(step)
                new_state, metrics = self.train_step(self.state, batch)
                loss = float(metrics["loss"])  # the step's one host sync
                if not math.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}: {loss}")
                self.state = new_state
                retries = 0
            except Exception as e:  # noqa: BLE001 — any step failure
                retries += 1
                self.report.restarts += 1
                if self.obs is not None:
                    self._c_restarts.inc()
                log.warning("step %d failed (%r); restore+retry %d/%d",
                            step, e, retries, self.max_retries)
                if retries > self.max_retries:
                    raise
                if not self._restore_latest():
                    log.warning("no checkpoint to restore; retrying same step")
                continue

            dt = time.perf_counter() - t0
            self.report.step_times.append(dt)
            self.report.losses.append(loss)
            self.report.steps_done += 1
            if self.obs is not None:
                self._c_steps.inc()
                self._h_step.observe(dt)
                toks = batch["tokens"].numel()
                if toks and dt > 0:
                    self._g_tps.set(toks / dt)
            if len(self.report.step_times) >= 5:
                med = statistics.median(self.report.step_times[-50:])
                if dt > self.straggler_factor * med:
                    self.report.straggler_events.append(step)
                    self.on_straggler(step, dt, med)
            if self.ckpt is not None:
                self.ckpt.maybe_save(step + 1, self.state)
            if log_every and self.report.steps_done % log_every == 0:
                log.info("step %d loss %.4f (%.2fs)", step, loss, dt)
        if self.ckpt is not None:
            self.ckpt.maybe_save(self.current_step(), self.state, force=True)
            self.ckpt.wait()
        return self.report
