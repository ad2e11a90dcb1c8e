"""Fault injection — the chaos layer of the replay pipeline.

Real IoT transports lose, duplicate, reorder, and stall messages
(RIoTBench benchmarks stream platforms under exactly these conditions;
IOTSim models broker-mediated delivery at cloud scale). The replay path
(:class:`~repro_torch.streamsim.producer.Producer` →
:class:`~repro_torch.streamsim.queue.StreamQueue`) is a *perfect* transport by
default; this module makes imperfection an explicit, **seeded, bit-
reproducible** axis of the scenario sweep, the same way ``max_range`` is
an axis of the simulation grid.

Design contract
---------------
- A :class:`FaultPlan` maps every scenario to a :class:`FaultSpec`
  (rates + windows for each fault kind). ``plan.injector(key)`` derives a
  per-scenario :class:`FaultInjector` whose RNG stream is keyed by
  ``sha256(seed, key)`` — NOT Python's randomized ``hash`` — so the same
  seed yields a **bit-identical fault schedule** across runs, processes,
  and hosts, regardless of how scenarios interleave in the merged
  multi-queue timeline (each scenario draws from its own stream).
- Draws happen in a FIXED order (one uniform vector per bucket, one
  integer per held bucket) so the schedule for fault kind X never shifts
  when the rate of fault kind Y changes from zero.
- A no-op spec (:attr:`FaultSpec.is_noop`) short-circuits every hook:
  a drop-free plan leaves replay stats **bit-equal** to the fault-free
  pipeline (tested).
- Every injected event is counted; the producer/queue ``stats()``
  surfaces the counters so per-scenario delivery reconciles as
  ``delivered == emitted - dropped + duplicated``.

Fault taxonomy (``docs/robustness.md`` has the full semantics):

=================  =========================================================
kind               effect at the injection point
=================  =========================================================
drop               bucket never reaches the queue (counted, not delivered)
duplicate          bucket is put twice (at-least-once delivery upper bound)
reorder            bucket held back and released within ``reorder_window``
                   later emissions (bounded out-of-order delivery)
delay              extra per-bucket emission jitter in ``[0, delay_jitter_s]``
stall              producer pauses ``stall_s`` before the bucket (broker
                   stall / GC pause on the transport)
consumer_crash     the wrapped consumer raises
                   :class:`InjectedConsumerCrash` on the scheduled
                   attempt(s) — the resilience layer's retry fodder
=================  =========================================================
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

__all__ = [
    "FaultSpec",
    "FaultPlan",
    "FaultInjector",
    "EmitAction",
    "InjectedConsumerCrash",
    "NOOP_SPEC",
]


class InjectedConsumerCrash(RuntimeError):
    """Raised by a fault-wrapped consumer on a scheduled crash attempt."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-scenario fault rates and windows. All-zero == perfect transport.

    ``consumer_crash_attempts`` holds 1-based replay attempt numbers on
    which the wrapped consumer raises — ``(1,)`` models a transient
    failure healed by one retry, ``(1, 2, 3, ...)`` a persistent one that
    should trip the circuit breaker.
    ``consumer_crash_after`` is how many buckets the consumer drains
    before crashing (a mid-stream failure, not an instant one).
    """

    drop_rate: float = 0.0
    duplicate_rate: float = 0.0
    reorder_rate: float = 0.0
    reorder_window: int = 4
    delay_jitter_s: float = 0.0
    stall_rate: float = 0.0
    stall_s: float = 0.0
    consumer_crash_attempts: Tuple[int, ...] = ()
    consumer_crash_after: int = 0

    def __post_init__(self):
        for f in ("drop_rate", "duplicate_rate", "reorder_rate",
                  "stall_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")
        if self.reorder_window < 1:
            raise ValueError("reorder_window must be >= 1")
        if self.delay_jitter_s < 0 or self.stall_s < 0:
            raise ValueError("delay_jitter_s / stall_s must be >= 0")
        if self.consumer_crash_after < 0:
            raise ValueError("consumer_crash_after must be >= 0")
        if any(a < 1 for a in self.consumer_crash_attempts):
            raise ValueError("crash attempts are 1-based")

    @property
    def is_noop(self) -> bool:
        """True when every hook can short-circuit (perfect transport)."""
        return (self.drop_rate == 0.0 and self.duplicate_rate == 0.0 and
                self.reorder_rate == 0.0 and self.delay_jitter_s == 0.0 and
                self.stall_rate == 0.0 and
                not self.consumer_crash_attempts)


NOOP_SPEC = FaultSpec()


@dataclasses.dataclass(frozen=True)
class EmitAction:
    """One bucket's drawn fate (the producer applies it in this order)."""

    stall_s: float = 0.0    #: sleep before the bucket (producer stall)
    delay_s: float = 0.0    #: extra jitter sleep before the bucket
    drop: bool = False      #: bucket never reaches the queue
    duplicate: bool = False  #: bucket is put twice
    hold: int = 0           #: >0: hold back, release after N emissions


_PASS = EmitAction()


def _derive_key(seed: int, key: object) -> np.ndarray:
    """Stable 2-word Philox key from (seed, scenario key).

    ``sha256`` — not the per-process-randomized builtin ``hash`` — so the
    schedule is identical across runs, interpreters, and hosts.
    """
    digest = hashlib.sha256(
        f"faultplan:{seed}|{key!r}".encode()).digest()
    return np.frombuffer(digest[:16], dtype=np.uint64).copy()


class FaultInjector:
    """One scenario's deterministic fault schedule + live counters.

    The injector is consumed by the producer hot path: ``draw()`` per
    source bucket (returns the bucket's :class:`EmitAction`),
    ``hold()``/``release_due()`` for the bounded-reorder buffer, and
    ``flush()`` at end-of-stream. ``reset()`` rewinds the RNG to the
    start of the schedule — a retried replay attempt sees the *same*
    drops/duplicates/reorders, so retry stats stay reconcilable — while
    the attempt counter (used by the consumer-crash schedule) keeps
    advancing.
    """

    def __init__(self, spec: FaultSpec, seed: int, key: object):
        self.spec = spec
        self.key = key
        self._rng_key = _derive_key(seed, key)
        self.attempts = 0
        self._pending: List[Tuple[int, object]] = []  # [remaining, bucket]
        self.reset()

    # ------------------------------------------------------------ schedule
    def reset(self) -> None:
        """Rewind to the start of the fault schedule (new replay attempt)."""
        self._rng = np.random.Generator(
            np.random.Philox(key=self._rng_key))
        self._pending.clear()
        self.dropped = 0
        self.duplicated = 0
        self.reordered = 0
        self.delayed = 0
        self.stalled = 0

    def draw(self) -> EmitAction:
        """Draw the next source bucket's fate (fixed draw order)."""
        spec = self.spec
        if spec.is_noop:
            return _PASS
        # ONE uniform vector per bucket, fixed slot per fault kind
        # (incl. the reorder hold length): the schedule for kind X never
        # shifts when the rate of kind Y changes
        u = self._rng.random(6)
        stall_s = spec.stall_s if u[3] < spec.stall_rate else 0.0
        delay_s = u[4] * spec.delay_jitter_s
        if stall_s > 0.0:
            self.stalled += 1
        if delay_s > 0.0:
            self.delayed += 1
        if u[0] < spec.drop_rate:
            self.dropped += 1
            return EmitAction(stall_s=stall_s, delay_s=delay_s, drop=True)
        if u[1] < spec.duplicate_rate:
            self.duplicated += 1
            return EmitAction(stall_s=stall_s, delay_s=delay_s,
                              duplicate=True)
        if u[2] < spec.reorder_rate:
            hold = 1 + int(u[5] * spec.reorder_window)
            self.reordered += 1
            return EmitAction(stall_s=stall_s, delay_s=delay_s, hold=hold)
        return EmitAction(stall_s=stall_s, delay_s=delay_s)

    # ------------------------------------------------------ reorder buffer
    def hold(self, bucket, n: int) -> None:
        """Park a bucket; it releases after ``n`` subsequent emissions."""
        self._pending.append([n, bucket])

    def release_due(self) -> List:
        """Advance the hold counters one emission; return released buckets."""
        if not self._pending:
            return []
        due, keep = [], []
        for item in self._pending:
            item[0] -= 1
            (due if item[0] <= 0 else keep).append(item)
        self._pending = keep
        return [b for _, b in due]

    def flush(self) -> List:
        """End-of-stream: every held bucket is released (bounded loss-free
        reorder — holds never become drops)."""
        due = [b for _, b in self._pending]
        self._pending.clear()
        return due

    # ----------------------------------------------------- consumer crash
    def next_attempt(self) -> int:
        """Advance and return the 1-based replay attempt number."""
        self.attempts += 1
        return self.attempts

    def crashes_on(self, attempt: int) -> bool:
        return attempt in self.spec.consumer_crash_attempts

    # ------------------------------------------------------------ counters
    def stats(self) -> Dict[str, int]:
        return {
            "fault_dropped": self.dropped,
            "fault_duplicated": self.duplicated,
            "fault_reordered": self.reordered,
            "fault_delayed": self.delayed,
            "fault_stalled": self.stalled,
        }


class _CrashingConsumer:
    """Consumer wrapper enforcing the injector's crash schedule.

    Named class (not a closure) so replay error messages show something
    greppable; thread-safe as long as the wrapped consumer is (each
    scenario gets its OWN wrapper instance).
    """

    def __init__(self, injector: FaultInjector, consumer: Callable):
        self._injector = injector
        self._consumer = consumer
        # advertise the wrapped task's name, so errors that name the task
        # still do so through the crash wrapper
        label = getattr(consumer, "name", None) \
            or getattr(consumer, "__name__", None)
        if isinstance(label, str) and label:
            self.name = label

    def __call__(self, queue):
        attempt = self._injector.next_attempt()
        if self._injector.crashes_on(attempt):
            after = self._injector.spec.consumer_crash_after
            for _ in range(after):
                if queue.get() is None:
                    break
            raise InjectedConsumerCrash(
                f"injected consumer crash (scenario {self._injector.key!r},"
                f" attempt {attempt})")
        return self._consumer(queue)


class FaultPlan:
    """Seeded, composable per-scenario fault schedules.

    ``FaultPlan(seed, default=spec)`` applies ``spec`` to every scenario;
    ``overrides`` pins specific scenarios to their own spec (e.g. one
    crash-prone consumer in an otherwise lossy-but-alive sweep). Plans
    compose with the scenario axis exactly like ``max_range`` does: the
    same plan object drives every producer of a sweep with identical
    per-scenario schedules, because each scenario's RNG stream is keyed
    by ``(seed, scenario key)`` alone.

    Injectors are memoized per key: the producer hooks and the consumer
    wrapper of one replay share one injector (one schedule, one counter
    set). ``fresh_injectors()`` starts a new replay generation.
    """

    def __init__(self, seed: int, default: FaultSpec = NOOP_SPEC,
                 overrides: Optional[Mapping[object, FaultSpec]] = None):
        self.seed = int(seed)
        self.default = default
        self.overrides = dict(overrides or {})
        self._injectors: Dict[object, FaultInjector] = {}

    def spec_for(self, key: object) -> FaultSpec:
        return self.overrides.get(key, self.default)

    def injector(self, key: object) -> FaultInjector:
        """The scenario's (memoized) injector — deterministic in
        ``(seed, key)`` only."""
        inj = self._injectors.get(key)
        if inj is None:
            inj = FaultInjector(self.spec_for(key), self.seed, key)
            self._injectors[key] = inj
        return inj

    def fresh_injectors(self) -> None:
        """Drop memoized injectors (a new replay generation: schedules
        restart from the top AND attempt counters restart)."""
        self._injectors.clear()

    def wrap_consumer(self, key: object, consumer: Callable) -> Callable:
        """Consumer with the scenario's crash schedule applied (identity
        pass-through when no crashes are scheduled)."""
        if not self.spec_for(key).consumer_crash_attempts:
            return consumer
        return _CrashingConsumer(self.injector(key), consumer)

    def is_noop_for(self, key: object) -> bool:
        return self.spec_for(key).is_noop

    def stats(self) -> Dict[object, Dict[str, int]]:
        """Live counters of every injector touched so far."""
        return {k: inj.stats() for k, inj in self._injectors.items()}
