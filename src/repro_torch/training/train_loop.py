"""The fault-tolerant training loop.

Counterpart of ``repro/training/train_loop.py``, with its control flow:
- consume batches from any iterator (StreamBatcher / SyntheticBatcher);
- run the train step;
- checkpoint every N steps (async), restart from the latest checkpoint on
  failure (including injected ones), with bounded retries;
- straggler accounting via :class:`StragglerMonitor`;
- NaN-loss quarantine: a non-finite loss skips the update (batch
  discarded) and keeps the old state. That needs a step that leaves its
  inputs as they were (``jit_train_step(..., donate=False)``), as the
  reference's launcher builds it.

A restore does not rewind the batch iterator, as in the reference: after
a failure at step k and a restore to checkpoint c < k, the loop goes on
with batch k. The loss is read to the host once a step.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.ft import (
    FailureInjector,
    SimulatedFailure,
    StragglerMonitor,
)


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    max_restarts: int = 3
    async_checkpoint: bool = True
    log_every: int = 10


class TrainLoop:
    def __init__(self, step_fn: Callable, params: Any, opt_state: Any,
                 batches: Iterator[Dict], ckpt: CheckpointManager,
                 cfg: TrainLoopConfig,
                 injector: Optional[FailureInjector] = None,
                 on_metrics: Optional[Callable[[int, Dict], None]] = None):
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.batches = iter(batches)
        self.ckpt = ckpt
        self.cfg = cfg
        self.injector = injector
        self.on_metrics = on_metrics
        self.straggler = StragglerMonitor()
        self.history: List[Dict] = []
        self.restarts = 0
        self.step = 0
        self.skipped_nan = 0

    # ------------------------------------------------------------- running
    def run(self) -> Dict:
        while self.step < self.cfg.total_steps:
            try:
                self._run_segment()
            except SimulatedFailure as e:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError("restart budget exhausted") from e
                self._restore()
        self.ckpt.wait()
        self._save()  # final
        return self.summary()

    def _run_segment(self) -> None:
        while self.step < self.cfg.total_steps:
            if self.injector is not None:
                self.injector.check(self.step)
            batch = next(self.batches)
            t0 = time.perf_counter()
            new_params, new_opt, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])  # the step's one device read
            wall = time.perf_counter() - t0
            if not math.isfinite(loss):
                # quarantine: drop update, keep old state
                self.skipped_nan += 1
                del new_params, new_opt
            else:
                self.params, self.opt_state = new_params, new_opt
            self.straggler.observe(self.step, wall)
            rec = {"step": self.step, "loss": loss, "wall_s": wall}
            self.history.append(rec)
            if self.on_metrics is not None:
                self.on_metrics(self.step, {**rec, **{
                    k: float(v) for k, v in metrics.items()
                    if k != "loss"}})
            self.step += 1
            if self.step % self.cfg.checkpoint_every == 0:
                self._save()

    # ------------------------------------------------------------- ckpting
    def _state(self) -> Dict:
        return {"params": self.params, "opt": self.opt_state}

    def _save(self) -> None:
        self.ckpt.save(self.step, self._state(),
                       extra={"restarts": self.restarts},
                       blocking=not self.cfg.async_checkpoint)

    def _restore(self) -> None:
        self.ckpt.wait()
        latest = self.ckpt.latest_step()
        if latest is None:
            self.step = 0  # restart from scratch
            return
        state = self.ckpt.restore(self._state(), step=latest)
        self.params, self.opt_state = state["params"], state["opt"]
        self.step = latest

    def summary(self) -> Dict:
        return {
            "final_step": self.step,
            "restarts": self.restarts,
            "skipped_nan": self.skipped_nan,
            "final_loss": self.history[-1]["loss"] if self.history else None,
            "straggler": self.straggler.summary(),
        }
