"""Fault tolerance: failure injection, straggler mitigation, elastic re-mesh.

A copy of the JAX package's ``training/ft.py``, which imports no JAX: the
control-plane logic plus simulators, testable on the CPU.

- :class:`FailureInjector` raises a ``SimulatedFailure`` at chosen steps
  (process death / NaN grad / device loss);
- :class:`StragglerMonitor` watches per-step wall time against a rolling
  deadline and records mitigation decisions (the action on a cluster
  would be to re-issue the step's data shard to a healthy host — here we
  account for it and continue, which is what a synchronous SPMD job does
  after the collective timeout reassigns membership);
- :func:`elastic_plan` computes the new mesh + batch sharding when the
  world shrinks/grows, and the train loop restores the latest checkpoint
  onto it (checkpoints are mesh-agnostic — see checkpoint.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class SimulatedFailure(RuntimeError):
    def __init__(self, kind: str, step: int):
        super().__init__(f"simulated {kind} at step {step}")
        self.kind = kind
        self.step = step


@dataclasses.dataclass
class FailureInjector:
    """Raise ``SimulatedFailure`` when the loop reaches the given steps."""

    failures: Dict[int, str] = dataclasses.field(default_factory=dict)
    fired: List[int] = dataclasses.field(default_factory=list)

    def check(self, step: int) -> None:
        if step in self.failures and step not in self.fired:
            self.fired.append(step)
            raise SimulatedFailure(self.failures[step], step)


@dataclasses.dataclass
class StragglerMonitor:
    """Deadline-based straggler detection over step wall times.

    deadline = median(recent) * tolerance; a step exceeding it is recorded
    as mitigated (on hardware: reissue / drop the slow host's microbatch).
    """

    tolerance: float = 3.0
    window: int = 20
    history: List[float] = dataclasses.field(default_factory=list)
    mitigated_steps: List[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, wall_s: float) -> bool:
        hist = self.history[-self.window:]
        slow = False
        if len(hist) >= 5:
            med = sorted(hist)[len(hist) // 2]
            slow = wall_s > self.tolerance * med
            if slow:
                self.mitigated_steps.append(step)
        self.history.append(wall_s)
        return slow

    def summary(self) -> Dict:
        return {
            "steps": len(self.history),
            "mitigated": len(self.mitigated_steps),
            "median_s": (sorted(self.history)[len(self.history) // 2]
                         if self.history else 0.0),
        }


def elastic_plan(n_healthy: int, mesh_shape: Sequence[int],
                 axis_names: Sequence[str],
                 global_batch: int) -> Tuple[Tuple[int, ...], int]:
    """Given a shrunk/grown healthy-chip count, pick the new mesh shape.

    Policy: keep the 'model' axis intact (TP degree is set by memory), and
    shrink the data axis to the largest value that divides both the healthy
    count / model size and the global batch. Returns (new_shape,
    per_shard_batch). Raises if even data=1 doesn't fit.
    """
    names = list(axis_names)
    shape = list(mesh_shape)
    model = shape[names.index("model")] if "model" in names else 1
    if n_healthy < model:
        raise ValueError(
            f"{n_healthy} chips cannot host model axis of {model}")
    avail = n_healthy // model
    data = 1
    for cand in range(avail, 0, -1):
        if global_batch % cand == 0:
            data = cand
            break
    new_shape = []
    for n, s in zip(names, shape):
        if n == "model":
            new_shape.append(model)
        elif n == "data":
            new_shape.append(data)
        else:  # pod axis folds into data on shrink
            new_shape.append(1)
    return tuple(new_shape), global_batch // data
