"""Fault-tolerant training loop (port of ``repro.train.trainer``).

  * resume from the latest verified checkpoint (parameters, optimizer and
    the data iterator's state);
  * periodic async checkpoints, and a final one; on SIGTERM / SIGINT the
    loop stops after the step in flight and saves (the handlers are the
    loop's own: ``run`` puts back the ones they replaced when it ends,
    so that no handler keeps a finished trainer, and its state on the
    card, alive);
  * retry: a step that raises is retried from the last checkpoint, up to
    ``max_retries`` times in a row.  The step updates the state in place:
    without a checkpoint a step that failed before its update is retried
    on the same state, and one that failed within it
    (:class:`~repro_torch.optim.adamw.PartialUpdateError`) raises;
  * straggler watchdog: a step slower than ``straggler_factor`` times the
    running median of the last 50 is reported to ``straggler_hook``.

A step's time ends when its loss is read on the host, which waits for the
device.  The final save is skipped when the loop has just saved the same
step (the reference writes it twice).  Sharded batches come with
sharding: ``batch_shardings`` is refused.
"""
from __future__ import annotations

import logging
import signal
import statistics
import time
from typing import Any, Callable

from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim.adamw import PartialUpdateError

log = logging.getLogger("repro_torch.trainer")


class Trainer:
    def __init__(
        self,
        *,
        train_step: Callable[[dict, dict], tuple[dict, dict]],
        state: dict,
        dataset,
        ckpt_dir: str,
        ckpt_every: int = 100,
        keep_n: int = 3,
        max_retries: int = 3,
        straggler_factor: float = 3.0,
        straggler_hook: Callable[[int, float, float], None] | None = None,
        batch_shardings: Any = None,
    ):
        if batch_shardings is not None:
            raise NotImplementedError("batch_shardings: sharding is not "
                                      "ported yet")
        self.train_step = train_step
        self.state = state
        self.dataset = dataset
        self.ckpt = CheckpointManager(ckpt_dir, keep_n=keep_n)
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.straggler_factor = straggler_factor
        self.straggler_hook = straggler_hook or self._default_straggler_hook
        self.step_times: list[float] = []
        self.metrics_history: list[dict] = []
        self._stop = False
        self._saved_step: int | None = None

    # ------------------------------------------------------------ resume
    def maybe_resume(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        self.state, extra = self.ckpt.restore(self.state)
        if "data_state" in extra:
            self.dataset.restore(extra["data_state"])
        log.info("resumed from checkpoint step %d", latest)
        return True

    # ------------------------------------------------------------ signals
    def _install_signal_handlers(self) -> dict:
        """Install the loop's SIGTERM / SIGINT handlers; returns the
        handlers they replaced."""
        def handler(signum, frame):
            log.warning("signal %s: emergency checkpoint then stop", signum)
            self._stop = True
        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not on the main thread (tests)
        return previous

    def _default_straggler_hook(self, step: int, dt: float, median: float):
        log.warning("straggler: step %d took %.3fs (median %.3fs)",
                    step, dt, median)

    # ------------------------------------------------------------ loop
    def _save(self, step: int):
        self.ckpt.save(step, self.state,
                       extra={"data_state": self.dataset.state()})
        self._saved_step = step

    def run(self, num_steps: int) -> list[dict]:
        previous = self._install_signal_handlers()
        try:
            return self._loop(num_steps)
        finally:
            for sig, handler in previous.items():
                if handler is not None:      # None: not set from Python
                    signal.signal(sig, handler)

    def _loop(self, num_steps: int) -> list[dict]:
        start = int(self.state["step"])
        retries = 0
        step = start
        while step < num_steps and not self._stop:
            batch = self.dataset.next()
            t0 = time.monotonic()
            try:
                self.state, metrics = self.train_step(self.state, batch)
                loss = float(metrics["loss"])
            except Exception as e:  # noqa: BLE001 -- transient-failure retry
                retries += 1
                log.exception("step %d failed (retry %d/%d)",
                              step, retries, self.max_retries)
                if retries > self.max_retries:
                    raise
                self.ckpt.wait()
                if self.ckpt.latest_step() is not None:
                    self.maybe_resume()
                    step = int(self.state["step"])
                elif isinstance(e, PartialUpdateError):
                    raise       # half-updated, and no checkpoint to restore
                continue
            retries = 0
            dt = time.monotonic() - t0
            self.step_times.append(dt)
            if len(self.step_times) >= 5:
                med = statistics.median(self.step_times[-50:])
                if dt > self.straggler_factor * med:
                    self.straggler_hook(step, dt, med)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["loss"] = loss
            metrics["step_time_s"] = dt
            self.metrics_history.append(metrics)
            step += 1
            if step % self.ckpt_every == 0:
                self._save(step)
        if self._saved_step != step:
            self._save(step)
        self.ckpt.wait()
        return self.metrics_history
