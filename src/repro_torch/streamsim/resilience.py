"""Resilience primitives — retries, breakers, deadlines, checkpoints.

A copy of the reference's ``repro/streamsim/resilience.py`` (pure Python).
The replay layer (:func:`~repro_torch.streamsim.engine.replay_many`) wires
in the first three; the rest are carried for the sweep's checkpoint and
service layers:

- :class:`RetryPolicy` — capped exponential backoff with **deterministic**
  jitter (hash of ``(seed, key, attempt)``, not wall-clock randomness),
  so a retried sweep is as reproducible as a clean one.
- :class:`Deadline` — a monotonic time budget; the engine uses it to
  bound consumer ``join()`` s so a wedged consumer surfaces as a *named
  scenario failure* instead of an indefinite hang.
- :class:`CircuitBreaker` — per-scenario consecutive-failure breaker;
  once open, further retries of that scenario are refused and the
  scenario degrades to a partial report instead of burning the backoff
  budget (and the sweep's wall clock) on a persistently-broken consumer.
- :class:`SweepCheckpoint` — per-scenario completion markers persisted
  through the :class:`~repro_torch.streamsim.store.StreamStore` (atomic
  JSON writes); :func:`~repro_torch.streamsim.engine.run_sweep` writes a
  report marker per scenario when given one.
- :class:`Lease` / :class:`Heartbeat` — the sweep-service claim record:
  a lease binds a queued scenario to a worker for ``ttl_s`` seconds; a
  background :class:`Heartbeat` thread renews the deadline while the
  worker computes, so only a *dead or wedged* worker's lease ever expires
  and gets reaped (``docs/robustness.md`` documents the full queue →
  lease → result protocol).

All primitives are pure-host, numpy-free, and deliberately boring: the
interesting guarantees (schedule determinism, report equality across a
kill/resume) live in the tests.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "RetryPolicy",
    "Deadline",
    "CircuitBreaker",
    "BreakerOpen",
    "SweepCheckpoint",
    "Lease",
    "Heartbeat",
]


def _hash_uniform(seed: int, key: object, attempt: int) -> float:
    """Deterministic uniform in [0, 1) from (seed, key, attempt)."""
    digest = hashlib.sha256(
        f"retry:{seed}|{key!r}|{attempt}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2 ** 64


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff + deterministic jitter.

    ``delay(attempt, key)`` for 1-based *failed* attempt numbers:
    ``min(max_delay_s, base_delay_s * multiplier ** (attempt - 1))``
    scaled by ``1 + jitter * u`` with ``u`` the hash-uniform of
    ``(seed, key, attempt)`` — two scenarios (or two attempts) never
    share a jitter draw, yet the whole backoff sequence is reproducible
    from the policy alone.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")

    def delay(self, attempt: int, key: object = None) -> float:
        """Backoff before retry number ``attempt`` (1-based failures)."""
        if attempt < 1:
            raise ValueError("attempt is 1-based")
        base = min(self.max_delay_s,
                   self.base_delay_s * self.multiplier ** (attempt - 1))
        return base * (1.0 + self.jitter *
                       _hash_uniform(self.seed, key, attempt))

    def delays(self, key: object = None) -> List[float]:
        """The full backoff schedule (one entry per retry)."""
        return [self.delay(a, key) for a in range(1, self.max_attempts)]


class Deadline:
    """A monotonic time budget (``None`` seconds == no deadline)."""

    def __init__(self, seconds: Optional[float],
                 clock: Callable[[], float] = time.monotonic):
        self.seconds = seconds
        self._clock = clock
        self._t0 = clock()

    def remaining(self) -> Optional[float]:
        """Seconds left (clamped to 0), or None for no deadline."""
        if self.seconds is None:
            return None
        return max(0.0, self._t0 + self.seconds - self._clock())

    @property
    def expired(self) -> bool:
        rem = self.remaining()
        return rem is not None and rem <= 0.0


class BreakerOpen(RuntimeError):
    """Raised when work is attempted through an open circuit breaker."""


class CircuitBreaker:
    """Per-scenario consecutive-failure breaker (closed → open →
    half-open).

    ``failure_threshold`` consecutive failures open the breaker; while
    open, :meth:`allow` is False. After ``recovery_s`` (monotonic
    seconds; ``None`` = never) the breaker half-opens: ONE probe attempt
    is allowed, and its outcome closes (success) or re-opens (failure)
    the breaker. A success in the closed state resets the failure count.
    """

    def __init__(self, failure_threshold: int = 3,
                 recovery_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.recovery_s = recovery_s
        self._clock = clock
        self.failures = 0
        self.state = "closed"          # closed | open | half-open
        self._opened_at: Optional[float] = None

    def allow(self) -> bool:
        if self.state == "closed":
            return True
        if self.state == "open":
            if (self.recovery_s is not None and
                    self._clock() - self._opened_at >= self.recovery_s):
                self.state = "half-open"
                return True
            return False
        return True                    # half-open: the single probe

    def record_success(self) -> None:
        self.failures = 0
        self.state = "closed"
        self._opened_at = None

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == "half-open" or \
                self.failures >= self.failure_threshold:
            self.state = "open"
            self._opened_at = self._clock()


# ------------------------------------------------------------- checkpoints
class SweepCheckpoint:
    """Per-scenario sweep completion markers in the stream store.

    Layout (see ``docs/robustness.md`` for the format contract)::

        <store root>/_markers/<sweep_id>/
            materialized__<dataset>__<max_range>.json
            report__<dataset>__<max_range>.json

    ``materialized`` markers record that a scenario's simulated stream is
    persisted (written by :meth:`~repro_torch.streamsim.engine.
    DeviceSweepResult.materialize`); ``report`` markers carry the full
    :class:`~repro_torch.streamsim.engine.SimulationReport` JSON (written as
    each report is assembled). On resume, report markers short-circuit
    the scenario entirely — its stream is already a store cache hit and
    its report loads from the marker — so a sweep killed after k
    scenarios redoes only the remaining ones. Marker writes are atomic
    (temp file + rename, the store's discipline), so a kill mid-write
    never yields a half-marker.

    ``sweep_id`` should identify the sweep *configuration* (grid + scale
    + seed + host slot — :attr:`~repro_torch.streamsim.plan.SweepPlan.sweep_id`
    provides exactly that), so a restarted run with the same arguments
    finds its own markers and a different sweep never collides.
    """

    def __init__(self, store, sweep_id: str):
        self.store = store
        self.sweep_id = sweep_id

    # ------------------------------------------------------------- naming
    @staticmethod
    def _name(kind: str, scenario: Tuple[str, int]) -> str:
        d, mr = scenario
        return f"{kind}__{d}__{mr}"

    # ------------------------------------------------------------ writing
    def mark_materialized(self, scenarios) -> None:
        for sc in scenarios:
            self.store.put_marker(self.sweep_id,
                                  self._name("materialized", sc),
                                  {"dataset": sc[0], "max_range": sc[1]})

    def mark_report(self, report) -> None:
        sc = (report.dataset, report.max_range)
        self.store.put_marker(self.sweep_id, self._name("report", sc),
                              report.to_json())

    # ------------------------------------------------------------ reading
    def done_scenarios(self) -> List[Tuple[str, int]]:
        """Scenarios with a completed report marker."""
        out = []
        for name in self.store.list_markers(self.sweep_id):
            if name.startswith("report__"):
                _, d, mr = name.split("__")
                out.append((d, int(mr)))
        return out

    def load_reports(self) -> Dict[Tuple[str, int], "object"]:
        """scenario -> SimulationReport for every report marker."""
        from repro_torch.streamsim.engine import SimulationReport
        out = {}
        for sc in self.done_scenarios():
            payload = self.store.get_marker(
                self.sweep_id, self._name("report", sc))
            out[sc] = SimulationReport.from_json(payload)
        return out

    def materialized_scenarios(self) -> List[Tuple[str, int]]:
        out = []
        for name in self.store.list_markers(self.sweep_id):
            if name.startswith("materialized__"):
                _, d, mr = name.split("__")
                out.append((d, int(mr)))
        return out

    def clear(self) -> None:
        self.store.clear_markers(self.sweep_id)


# ------------------------------------------------------------------ leases
@dataclasses.dataclass
class Lease:
    """One worker's claim on one queued sweep scenario.

    Persisted as the lease-marker payload in the service's
    ``<group>/leases/`` namespace. ``deadline`` is *wall-clock*
    (``time.time()``) because leases are judged by OTHER processes —
    possibly on other hosts — where a monotonic clock has no shared
    origin; ``beat`` is a per-renewal counter so a reaper can tell a
    renewed lease from a stale re-read even under coarse filesystem
    timestamps. ``attempts`` counts how many leases this scenario has
    ever been granted (the poison-quarantine input: each expired lease
    is one "this scenario killed a worker" strike).
    """

    worker: str
    dataset: str
    max_range: int
    ttl_s: float
    deadline: float
    attempts: int = 1
    beat: int = 0

    def expired(self, now: Optional[float] = None) -> bool:
        return (time.time() if now is None else now) > self.deadline

    def renew(self, now: Optional[float] = None) -> "Lease":
        now = time.time() if now is None else now
        return dataclasses.replace(self, deadline=now + self.ttl_s,
                                   beat=self.beat + 1)

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, payload: Dict) -> "Lease":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in payload.items() if k in fields})


class Heartbeat:
    """Daemon thread that renews a batch of leases while work runs.

    Rewrites each lease marker every ``ttl_s / 3`` seconds (so a healthy
    worker gets ~3 renewal chances per TTL window before a reaper could
    act). A lease whose marker has *vanished* is dropped from the renewal
    set rather than resurrected: the marker disappearing means a reaper
    already reclaimed it (this worker overran its TTL — e.g. a long GC
    pause), and rewriting it would fight the reaper's decision. The
    worker discovers the loss via :attr:`lost` and skips publishing.

    Renewal is *wall-clock extension only* — a worker wedged inside the
    consumer keeps heartbeating, which is exactly why wedge detection is
    delegated to the engine's ``consumer_deadline_s`` (the lease protocol
    only defends against *dead* workers).
    """

    def __init__(self, store, sweep_id: str, leases: Dict[str, Lease],
                 *, interval_s: Optional[float] = None):
        self.store = store
        self.sweep_id = sweep_id
        self.leases = dict(leases)     # marker name -> Lease
        ttl = min((l.ttl_s for l in self.leases.values()), default=1.0)
        self.interval_s = interval_s if interval_s is not None else ttl / 3.0
        self.lost: List[str] = []      # marker names a reaper reclaimed
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sweep-lease-heartbeat")

    def _renew_all(self) -> None:
        for name in list(self.leases):
            if not self.store.has_marker(self.sweep_id, name):
                self.lost.append(name)
                del self.leases[name]
                continue
            lease = self.leases[name].renew()
            self.store.put_marker(self.sweep_id, name, lease.to_json())
            self.leases[name] = lease

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._renew_all()

    def __enter__(self) -> "Heartbeat":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)
